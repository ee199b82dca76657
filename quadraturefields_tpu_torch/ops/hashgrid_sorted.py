"""Segment sum of a key-sorted row stream.

Port of `presorted_row_segment_sum` from
quadraturefields_tpu/ops/hashgrid_sorted.py, forward only: the per-ray
sum of the composite (render/renderer.py) and of accumulate_along_rays.
For tensors on the card it launches csrc/segment_sum.cu; for CPU
tensors it runs `segment_sum_plain`, the JAX CPU branch's
segment_sum. The sorted table-gradient kernels of that module (K1,
K5-K7) and this function's VJP come with the training step.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr


def segment_sum_plain(keys: torch.Tensor, vals: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """out[k] = sum of vals rows with key k; keys clip to [0, n_segments]
    and the n_segments row (the sentinel) is dropped."""
    k = keys.to(torch.int64).clamp(0, n_segments)
    out = torch.zeros((n_segments + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, k, vals.to(torch.float32))
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
