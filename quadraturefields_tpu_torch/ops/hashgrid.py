"""Multiresolution hash-grid encoding (instant-NGP style), PyTorch port.

Port of quadraturefields_tpu/ops/hashgrid.py, corner layout, forward
only: `HashGridConfig` and its level math (tcnn's formula
scale_l = N_min * growth^l - 1, res_l = ceil(scale_l) + 1, dense levels
padded to a multiple of 8, hashed levels 2^log2_T rows), the table init,
the dense / xor-prime-hash level indexing, cube and Kuhn-tet corner
weights, and the encode itself.

`hashgrid_encode` launches the CUDA kernel csrc/hashgrid_encode.cu for
tensors on the card and runs the plain PyTorch version `encode_plain`
for tensors on the CPU. The cell layout and the table gradient come
with the training step.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr

# tcnn spatial-hash primes (the first coordinate is unmultiplied).
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Same fields and defaults as the JAX config, so configs carry over;
    `grad_mode` and `grad_payload` only matter to the table gradient,
    which the port does not have yet."""

    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865
    dtype: str = "float32"
    interp: str = "cube"      # "cube" (8 corners) | "tet" (Kuhn, 4)
    grad_mode: str = "auto"
    layout: str = "corner"    # "corner" | "cell" (not ported yet)
    grad_payload: str = "f32"

    @property
    def corners(self) -> int:
        return 8 if self.interp == "cube" else 4

    @property
    def row_width(self) -> int:
        if self.layout == "cell":
            return 8 * self.n_features
        return self.n_features

    @staticmethod
    def from_max_resolution(
        max_resolution: int,
        n_levels: int = 16,
        base_resolution: int = 16,
        n_features: int = 2,
        log2_hashmap_size: int = 19,
        dtype: str = "float32",
        interp: str = "cube",
        grad_mode: str = "auto",
        layout: str = "corner",
        grad_payload: str = "f32",
    ) -> "HashGridConfig":
        """per_level_scale = exp((ln max_res - ln base_res)/(L-1))."""
        s = math.exp(
            (math.log(max_resolution) - math.log(base_resolution))
            / (n_levels - 1)
        )
        return HashGridConfig(
            n_levels=n_levels,
            n_features=n_features,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution,
            per_level_scale=s,
            dtype=dtype,
            interp=interp,
            grad_mode=grad_mode,
            layout=layout,
            grad_payload=grad_payload,
        )

    @property
    def level_scales(self) -> Tuple[float, ...]:
        return tuple(
            self.base_resolution * (self.per_level_scale**l) - 1.0
            for l in range(self.n_levels)
        )

    @property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        hashmap_size = 1 << self.log2_hashmap_size
        sizes = []
        for res in self.level_resolutions:
            n_axis = res - 1 if self.layout == "cell" else res
            size = min(n_axis**3, hashmap_size)
            sizes.append((size + 7) // 8 * 8)
        return tuple(sizes)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def total_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def hashgrid_init(generator: torch.Generator, cfg: HashGridConfig,
                  device=None) -> torch.Tensor:
    """Table init U(-1e-4, 1e-4), tcnn's default for grid encodings."""
    table = torch.rand(
        (cfg.total_entries, cfg.row_width), generator=generator,
        device=device, dtype=torch.float32,
    )
    table = table * 2e-4 - 1e-4
    return table.to(getattr(torch, cfg.dtype))


def _level_indices(coords: torch.Tensor, res: int, size: int):
    """Flat table index (int64) of integer corner coords [..., 3] in
    [0, res-1] for one level: dense stride indexing when res^3 <= size,
    else the xor-prime hash masked to the power-of-two size. The hash
    is taken in int64: its low 32 bits equal the uint32 product."""
    c = coords.to(torch.int64)
    if res**3 <= size:
        return c[..., 0] + c[..., 1] * res + c[..., 2] * (res * res)
    h = c[..., 0] * _PRIMES[0]
    h = h ^ (c[..., 1] * _PRIMES[1])
    h = h ^ (c[..., 2] * _PRIMES[2])
    return h & (size - 1)


# The 8 trilinear corners: corner c = (c>>2 & 1, c>>1 & 1, c & 1).
_CORNERS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
    dtype=np.int64,
)


def _tet_ranks(frac: torch.Tensor):
    """Descending rank of each fractional coordinate with the JAX
    tie-break: rank_i = #(strictly greater) + #(equal, lower index)."""
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    rx = (fy > fx).to(torch.int64) + (fz > fx).to(torch.int64)
    ry = (fx >= fy).to(torch.int64) + (fz > fy).to(torch.int64)
    rz = (fx >= fz).to(torch.int64) + (fy >= fz).to(torch.int64)
    return torch.stack([rx, ry, rz], dim=1)


def _corner_indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """All-level corner table indices and interpolation weights.

    Returns (idx [N, L*C] int64, w [N, L*C] f32), C = 8 (cube) or 4
    (tet), in the JAX corner order.
    """
    n = x.shape[0]
    x = x.to(torch.float32)
    corners = torch.as_tensor(_CORNERS, device=x.device)
    idx_all, w_all = [], []
    for l in range(cfg.n_levels):
        scale = torch.tensor(cfg.level_scales[l], dtype=torch.float32)
        pos = x * scale + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        base = pos_floor.to(torch.int64)
        res = cfg.level_resolutions[l]
        if cfg.interp == "cube":
            c = (base[:, None, :] + corners[None]).clamp(0, res - 1)
            w = torch.ones((n, 8), dtype=torch.float32, device=x.device)
            for axis in range(3):
                on = corners[None, :, axis].bool()
                f = frac[:, None, axis]
                w = w * torch.where(on, f, 1.0 - f)
        else:
            r = _tet_ranks(frac)
            e_first = (r == 0).to(torch.int64)
            e_second = (r == 1).to(torch.int64)
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            f1 = torch.where(r == 0, frac, zero).sum(dim=1)
            f2 = torch.where(r == 1, frac, zero).sum(dim=1)
            f3 = torch.where(r == 2, frac, zero).sum(dim=1)
            w = torch.stack([1.0 - f1, f1 - f2, f2 - f3, f3], dim=1)
            c = torch.stack(
                [torch.zeros_like(base), e_first, e_first + e_second,
                 torch.ones_like(base)],
                dim=1,
            ) + base[:, None]
            c = c.clamp(0, res - 1)
        idx = _level_indices(c, res, cfg.level_sizes[l]) \
            + cfg.level_offsets[l]
        idx_all.append(idx)
        w_all.append(w)
    return torch.cat(idx_all, dim=1), torch.cat(w_all, dim=1)


def encode_plain(table: torch.Tensor, x: torch.Tensor,
                 cfg: HashGridConfig) -> torch.Tensor:
    """The plain PyTorch encode: gather the corner rows, weight, sum over
    corners. x [N, 3] -> [N, L*F] f32."""
    x = x.clamp(0.0, 1.0)
    n = x.shape[0]
    L, C, F = cfg.n_levels, cfg.corners, cfg.n_features
    idx, w = _corner_indices_weights(x, cfg)
    feats = table[idx].to(torch.float32)               # [N, L*C, F]
    out = (feats * w[..., None]).reshape(n, L, C, F).sum(dim=2)
    return out.reshape(n, L * F)


ENCODE_KERNEL = CudaKernel(
    "hashgrid_encode",
    "qf_hashgrid_encode",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="quadraturefields_tpu/ops/hashgrid_pallas.py:130",
)


def _level_arrays(cfg: HashGridConfig):
    return (
        np.asarray(cfg.level_scales, np.float32),
        np.asarray(cfg.level_resolutions, np.int32),
        np.asarray(cfg.level_sizes, np.int64),
        np.asarray(cfg.level_offsets[:-1], np.int64),
    )


def encode_kernel(table: torch.Tensor, x: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """Launch csrc/hashgrid_encode.cu on CUDA tensors x [N, 3] f32 and
    table [E, F] f32; returns [N, L*F] f32. Forward only: the table
    gradient is not ported yet, so a table that requires grad raises."""
    dev = x.device
    check_cuda_tensor(x, "x", torch.float32, dev, 2)
    check_cuda_tensor(table, "table", torch.float32, dev, 2)
    F = cfg.n_features
    if x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    if table.shape != (cfg.total_entries, F):
        raise ValueError(
            f"table is {tuple(table.shape)}, config needs "
            f"{(cfg.total_entries, F)}"
        )
    if F not in (1, 2, 4, 8) or table.data_ptr() % (4 * F):
        raise ValueError(f"kernel takes aligned F in (1, 2, 4, 8), got {F}")
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError("the encode kernel has no backward yet")
    n = x.shape[0]
    out = torch.empty((n, cfg.output_dim), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    scales, res, sizes, offsets = _level_arrays(cfg)
    ENCODE_KERNEL.launch(
        dev, ptr(x), ptr(table), ptr(out), n, cfg.n_levels, F,
        int(cfg.interp == "tet"),
        scales.ctypes.data_as(ctypes.c_void_p),
        res.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions x [N, 3] in [0,1]^3 -> features [N, L*F] f32.

    Out-of-range coordinates clamp to the unit cube. CUDA tensors go
    through the kernel, CPU tensors through `encode_plain`.
    """
    if cfg.layout != "corner":
        raise NotImplementedError("the cell layout is not ported yet")
    if x.device.type == "cpu":
        return encode_plain(table, x, cfg)
    return encode_kernel(table, x, cfg)


def hashgrid_encode_batched(table, x, cfg: HashGridConfig,
                            chunk: int = 2**20):
    """Chunked encode for very large point sets (dense grid export)."""
    n = x.shape[0]
    if n <= chunk:
        return hashgrid_encode(table, x, cfg)
    pieces = [hashgrid_encode(table, x[i:i + chunk], cfg)
              for i in range(0, n, chunk)]
    return torch.cat(pieces, dim=0)
