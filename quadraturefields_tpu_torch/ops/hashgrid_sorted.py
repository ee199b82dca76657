"""Segment sums: the per-ray sum of a key-sorted row stream, and the
table gradient of (entry, v0, v1) contributions.

Port of quadraturefields_tpu/ops/hashgrid_sorted.py:
- `presorted_row_segment_sum` and its differentiable form
  `presorted_row_segment_sum_vjp` (d vals = g[keys], as `_psum_bwd`):
  the per-ray sums of the composite (render/renderer.py) and of
  accumulate_along_rays. The card runs csrc/segment_sum.cu, the CPU
  `segment_sum_plain` (the JAX CPU branch's segment_sum).
- `sorted_table_grad`, K1's interface: M contributions summed into
  [E, 2]. The card runs csrc/table_grad.cu (one float2 atomic per
  contribution, no sort), the CPU `table_grad_pairs_plain` (one
  index_add_). The encode's own backward does not go through it: the
  fused kernel of csrc/hashgrid_encode.cu never builds the stream.
The cell-layout kernels of that module (K5-K7) are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr


def segment_sum_plain(keys: torch.Tensor, vals: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """out[k] = sum of vals rows with key k; keys clip to [0, n_segments]
    and the n_segments row (the sentinel) is dropped. Sums in f32 (f64
    for f64 values, a reference sum)."""
    k = keys.to(torch.int64).clamp(0, n_segments)
    dtype = torch.promote_types(vals.dtype, torch.float32)
    out = torch.zeros((n_segments + 1, vals.shape[1]), dtype=dtype,
                      device=vals.device)
    out.index_add_(0, k, vals.to(dtype))
    return out[:n_segments]


SEGMENT_SUM_KERNEL = CudaKernel(
    "segment_sum",
    "qf_segment_sum",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:175",
)


def segment_sum_kernel(keys: torch.Tensor, vals: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Launch csrc/segment_sum.cu on keys [M] int32 (non-decreasing) and
    vals [M, RW] f32 on the card -> [n_segments, RW] f32."""
    dev = vals.device
    if torch.is_grad_enabled() and vals.requires_grad:
        raise RuntimeError(
            "segment_sum_kernel does not record a gradient; call "
            "presorted_row_segment_sum_vjp under autograd")
    check_cuda_tensor(keys, "keys", torch.int32, dev, 1)
    check_cuda_tensor(vals, "vals", torch.float32, dev, 2)
    m, rw = vals.shape
    if keys.shape[0] != m:
        raise ValueError(f"{keys.shape[0]} keys for {m} rows")
    if not 1 <= rw <= 8:
        raise ValueError(f"row width {rw} not in 1..8")
    if rw % 4 == 0 and vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    out = torch.empty((n_segments, rw), dtype=torch.float32, device=dev)
    if n_segments == 0:
        return out
    SEGMENT_SUM_KERNEL.launch(dev, ptr(keys), ptr(vals), ptr(out), m,
                              n_segments, rw)
    return out


def presorted_row_segment_sum(keys: torch.Tensor, vals: torch.Tensor,
                              n_segments: int) -> torch.Tensor:
    """Segment-sum the rows of an already key-sorted stream.

    keys: [M] int32, non-decreasing; rows with key >= n_segments are
    dropped (use key = n_segments for padding). vals: [M, RW] f32.
    Returns [n_segments, RW] f32.
    """
    if vals.device.type == "cpu":
        return segment_sum_plain(keys, vals, n_segments)
    return segment_sum_kernel(keys, vals, n_segments)


class _PresortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keys, vals, n_segments):
        ctx.save_for_backward(keys)
        ctx.n_segments = n_segments
        return presorted_row_segment_sum(keys, vals, n_segments)

    @staticmethod
    def backward(ctx, g):
        (keys,) = ctx.saved_tensors
        n = ctx.n_segments
        k = keys.to(torch.int64).clamp(0, n - 1)
        dv = torch.where((keys < n)[:, None], g[k], 0.0)
        return None, dv, None


def presorted_row_segment_sum_vjp(keys: torch.Tensor, vals: torch.Tensor,
                                  n_segments: int) -> torch.Tensor:
    """Differentiable presorted_row_segment_sum: d vals = g[keys], zero
    for the dropped rows (keys >= n_segments). A plain gather, no
    kernel, as in JAX (hashgrid_sorted.py:969-972)."""
    return _PresortedSegmentSum.apply(keys, vals, n_segments)


def table_grad_pairs_plain(idx: torch.Tensor, v0: torch.Tensor,
                           v1: torch.Tensor,
                           total_entries: int) -> torch.Tensor:
    """out[idx[j]] += (v0[j], v1[j]) into [total_entries, 2] with one
    index_add_, in f32 (f64 for f64 values, a reference sum)."""
    dtype = torch.promote_types(v0.dtype, torch.float32)
    out = torch.zeros((total_entries, 2), dtype=dtype, device=v0.device)
    vals = torch.stack([v0.to(dtype), v1.to(dtype)], dim=1)
    out.index_add_(0, idx.to(torch.int64), vals)
    return out


TABLE_GRAD_PAIRS_KERNEL = CudaKernel(
    "table_grad_pairs",
    "qf_table_grad_pairs",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_backward.py:52",
    library="table_grad",
)


def table_grad_pairs_kernel(idx: torch.Tensor, v0: torch.Tensor,
                            v1: torch.Tensor,
                            total_entries: int) -> torch.Tensor:
    """Launch csrc/table_grad.cu on idx [M] int32/int64 and v0, v1 [M]
    f32 on the card -> [total_entries, 2] f32. Entries outside
    [0, total_entries) are dropped."""
    dev = v0.device
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx has dtype {idx.dtype}, expected int32/int64")
    check_cuda_tensor(idx, "idx", idx.dtype, dev, 1)
    check_cuda_tensor(v0, "v0", torch.float32, dev, 1)
    check_cuda_tensor(v1, "v1", torch.float32, dev, 1)
    m = idx.shape[0]
    if v0.shape[0] != m or v1.shape[0] != m:
        raise ValueError(f"{m} indices for {v0.shape[0]}, {v1.shape[0]} "
                         "values")
    if total_entries <= 0:
        raise ValueError(f"total_entries must be > 0, got {total_entries}")
    out = torch.zeros((total_entries, 2), dtype=torch.float32, device=dev)
    if m:
        TABLE_GRAD_PAIRS_KERNEL.launch(
            dev, ptr(idx), int(idx.dtype == torch.int64), ptr(v0), ptr(v1),
            ptr(out), m, total_entries)
    return out


def sorted_table_grad(idx: torch.Tensor, v0: torch.Tensor,
                      v1: torch.Tensor, total_entries: int) -> torch.Tensor:
    """Segment-sum contributions into a [total_entries, 2] gradient
    (K1's interface): idx [M] entry ids in [0, total_entries), v0, v1
    [M] per-feature values. Exact modulo f32 summation order."""
    if v0.device.type == "cpu":
        return table_grad_pairs_plain(idx, v0, v1, total_entries)
    return table_grad_pairs_kernel(idx, v0, v1, total_entries)
