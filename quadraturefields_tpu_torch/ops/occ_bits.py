"""Bit-table occupancy lookup for the coarse grid of the two-level march.

Port of quadraturefields_tpu/ops/occ_bits.py. The coarse occupancy
field packs into at most 64 x 128 u32 words (32^3 cells = 1024 words),
stored as int32 like the JAX package. `occupancy_lookup_bits` is a
drop-in for grid.occupancy_lookup on such grids: for tensors on the
card it launches csrc/occ_bits.cu, which fuses the world -> cell mapping
with the bit test; for CPU tensors it runs `lookup_bits_plain`. Unlike
the JAX package there is no environment switch: the grid size alone
decides (`bits_lookup_applicable`).
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr

# rows of 128 words beyond which the JAX gate stops using the bit path
_MAX_BIT_ROWS = 64


def pack_occupancy_bits(binaries: torch.Tensor) -> torch.Tensor:
    """[res,res,res] bool -> [res^3/4096, 128] int32 bitfield.

    Bit k of word w encodes flat cell w*32 + k (x-major flattening, the
    (x, y, z) indexing of occupancy_lookup). Words with bit 31 set are
    stored as negative int32, as the JAX package's uint32 -> int32 cast.
    """
    flat = binaries.reshape(-1)
    n = flat.shape[0]
    if n % 4096:
        raise ValueError("bit packing needs res^3 % 4096 == 0")
    words = flat.reshape(n // 32, 32).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=flat.device) << \
        torch.arange(32, dtype=torch.int64, device=flat.device)
    packed = (words * weights[None, :]).sum(dim=1)        # < 2^32
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32).reshape(-1, 128)


def bits_lookup_applicable(res: int) -> bool:
    """Whether a res^3 grid packs into the bit table (1..64 rows)."""
    if res % 16 != 0:
        return False
    rows = res**3 // 4096
    return 1 <= rows <= _MAX_BIT_ROWS


def _bit_lookup(table: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Bit `flat_idx` of the bitfield, as int32 0/1: the word gather and
    bit extract that the TPU kernel _bit_lookup_kernel performs."""
    words = table.reshape(-1)
    idx = flat_idx.to(torch.int64)
    return (words[idx >> 5] >> (idx & 31).to(torch.int32)) & 1


def _cells(x: torch.Tensor, aabb: torch.Tensor, res: int):
    """(flat x-major cell index, in-box mask) of world positions."""
    unit = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    inside = ((unit >= 0.0) & (unit < 1.0)).all(dim=-1)
    cell = (unit * res).to(torch.int32).clamp(0, res - 1).to(torch.int64)
    flat = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    return flat, inside


def lookup_bits_plain(table: torch.Tensor, aabb: torch.Tensor,
                      x: torch.Tensor, res: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: bool [...] occupancy
    of the world positions x [..., 3]."""
    flat, inside = _cells(x, aabb, res)
    return (_bit_lookup(table, flat) > 0) & inside


BITS_KERNEL = CudaKernel(
    "occ_bits",
    "qf_occ_bits_lookup",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    replaces="quadraturefields_tpu/ops/occ_bits.py:49",
)


def lookup_bits_kernel(table: torch.Tensor, aabb: torch.Tensor,
                       x: torch.Tensor, res: int) -> torch.Tensor:
    """Launch csrc/occ_bits.cu: table [rows, 128] int32, aabb [6] f32 and
    positions x [..., 3] f32 on the card -> bool [...]."""
    dev = x.device
    check_cuda_tensor(table, "table", torch.int32, dev, 2)
    check_cuda_tensor(aabb, "aabb", torch.float32, dev, 1)
    check_cuda_tensor(x, "x", torch.float32, dev, x.dim())
    if x.shape[-1] != 3 or aabb.shape[0] != 6:
        raise ValueError("x must be [..., 3] and aabb [6]")
    n_words = table.numel()
    if n_words * 32 != res**3:
        raise ValueError(f"bit table of {n_words} words is not a {res}^3 grid")
    out = torch.empty(x.shape[:-1], dtype=torch.bool, device=dev)
    n = out.numel()
    if n == 0:
        return out
    BITS_KERNEL.launch(dev, ptr(table), n_words, ptr(x), n, ptr(aabb), res,
                       ptr(out))
    return out


def occupancy_lookup_bits(binaries: torch.Tensor, aabb: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Drop-in for grid.occupancy_lookup on small (coarse) grids:
    binaries[cell(x)], out-of-box positions -> False."""
    res = binaries.shape[0]
    table = pack_occupancy_bits(binaries)
    if x.device.type == "cpu":
        return lookup_bits_plain(table, aabb, x, res)
    return lookup_bits_kernel(table, aabb, x, res)
