"""The value-space table gradient with bf16 values (K8's interface).

Port of quadraturefields_tpu/ops/hashgrid_backward.py:sorted_table_grad,
which the JAX package keeps as a measured record and does not wire into
the encoder. It sums (row, lane0, v0, v1) contributions of the packed
value layout (flat value id = row * 128 + lane, feature 0 at the even
lane0, feature 1 beside it) into a flat [total_values] f32 gradient. The
TPU kernel multiplies a bf16 one-hot by bf16 values and sums in f32, so
v0 and v1 are rounded to bf16 first, and each pair lands at entry
(row * 128 + lane0) / 2 of the [entries, 2] gradient. On the card one
kernel does all of it (csrc/table_grad.cu `qf_table_grad_values`: the
entry, the rounding and the sum, with no elementwise pass before it);
on the CPU `table_grad_values_plain` computes the same in PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr
from . import hashgrid_sorted

LANES = 128


def _n_entries(total_values: int) -> int:
    """The [entries, 2] gradient's entries: 64 for each row of 128."""
    return -(-total_values // LANES) * (LANES // 2)


def table_grad_values_plain(row_ids: torch.Tensor, lane0: torch.Tensor,
                            v0: torch.Tensor, v1: torch.Tensor,
                            total_values: int) -> torch.Tensor:
    """K8's function: the entries (row * 128 + lane0) // 2 in int64, v0
    and v1 rounded to bf16, one index_add_ into [entries, 2] (entries
    outside it dropped), flattened to [total_values]. Sums in f32 (f64
    for f64 values, a reference sum)."""
    entries = (row_ids.to(torch.int64) * LANES + lane0.to(torch.int64)) // 2
    out = hashgrid_sorted.table_grad_pairs_plain(
        entries, hashgrid_sorted._bf16(v0), hashgrid_sorted._bf16(v1),
        _n_entries(total_values))
    return out.reshape(-1)[:total_values]


TABLE_GRAD_VALUES_KERNEL = CudaKernel(
    "table_grad_values",
    "qf_table_grad_values",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_backward.py:52",
    library="table_grad",
)


def table_grad_values_kernel(row_ids: torch.Tensor, lane0: torch.Tensor,
                             v0: torch.Tensor, v1: torch.Tensor,
                             total_values: int) -> torch.Tensor:
    """Launch K8 (csrc/table_grad.cu) on row_ids, lane0 [M] int32/int64
    and v0, v1 [M] f32 on the card -> [total_values] f32."""
    dev = v0.device
    for name, t in (("row_ids", row_ids), ("lane0", lane0)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "int32/int64")
        check_cuda_tensor(t, name, t.dtype, dev, 1)
    check_cuda_tensor(v0, "v0", torch.float32, dev, 1)
    check_cuda_tensor(v1, "v1", torch.float32, dev, 1)
    m = row_ids.shape[0]
    if not lane0.shape[0] == v0.shape[0] == v1.shape[0] == m:
        raise ValueError(f"{m} row ids for {lane0.shape[0]} lanes, "
                         f"{v0.shape[0]}, {v1.shape[0]} values")
    if total_values <= 0:
        raise ValueError(f"total_values must be > 0, got {total_values}")
    n_entries = _n_entries(total_values)
    out = torch.zeros((n_entries, 2), dtype=torch.float32, device=dev)
    if m:
        TABLE_GRAD_VALUES_KERNEL.launch(
            dev, ptr(row_ids), int(row_ids.dtype == torch.int64), ptr(lane0),
            int(lane0.dtype == torch.int64), ptr(v0), ptr(v1), ptr(out), m,
            n_entries)
    return out.reshape(-1)[:total_values]


def sorted_table_grad(row_ids: torch.Tensor, lane0: torch.Tensor,
                      v0: torch.Tensor, v1: torch.Tensor,
                      total_values: int) -> torch.Tensor:
    """row_ids, lane0 [M] int (lane0 even), v0, v1 [M] f32 ->
    [total_values] f32: the kernel for CUDA tensors, its plain version
    on the CPU."""
    if v0.device.type == "cpu":
        return table_grad_values_plain(row_ids, lane0, v0, v1, total_values)
    return table_grad_values_kernel(row_ids, lane0, v0, v1, total_values)
