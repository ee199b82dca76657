"""Segment sums: the per-ray sum of a key-sorted row stream, and the
table gradient of (entry, v0, v1) contributions.

Port of quadraturefields_tpu/ops/hashgrid_sorted.py:
- `presorted_row_segment_sum` and its differentiable form
  `presorted_row_segment_sum_vjp` (d vals = g[keys], as `_psum_bwd`):
  the per-ray sums of the composite (render/renderer.py) and of
  accumulate_along_rays. The card runs csrc/segment_sum.cu
  (`segment_group(M, n)` lanes a segment, a warp per 32 / lanes
  segments), the CPU
  `segment_sum_plain` (the JAX CPU branch's segment_sum).
- `sorted_table_grad`, K1's interface: M contributions summed into
  [E, 2]. The card runs csrc/table_grad.cu's `qf_table_grad_pairs`
  (one float2 atomic per contribution, lanes of equal neighbouring
  entries merged, no sort; K8's entry on the same kernel), the CPU
  `table_grad_pairs_plain` (one index_add_). The encode's own
  backward does not go through it: the fused kernel of
  csrc/hashgrid_encode.cu never builds the stream.
- The cell-layout table gradients, M contributions summed into
  [E, 8F] rows (row slot c*F + f = corner c, feature f), one function
  with three input forms: `sorted_row_grad` (K5, f32 rows [M, 8F]),
  `sorted_pair_grad` (K6, feature pairs rounded to bf16) and
  `sorted_tet_factor_grad` (K7's stream interface, Kuhn weights and
  cotangents rounded to bf16, their products rounded to bf16). The card
  runs csrc/cell_table_grad.cu (K5, K6) and the stream entry of
  csrc/cell_factor_grad.cu (K7), the CPU `row_grad_plain`,
  `pair_grad_plain` and `tet_factor_grad_plain`. JAX sorts each stream
  by entry for the TPU's in-order grid; the port sums unsorted. The
  cell encode's own backward builds neither K7's stream nor K5's (but
  for an F that K5's fused entry does not take): it launches the fused
  entries (ops/hashgrid.py `tet_factor_grad_x`, `cell_row_grad_x`).
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
     ctypes.c_int, ctypes.c_int, ctypes.c_int],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:175",
)


def segment_group(m: int, n_segments: int) -> int:
    """Lanes a segment in csrc/segment_sum.cu: the largest power of two
    at most the mean rows a segment, M / n_segments, and at most
    2^17 / n_segments, so that the grid holds at most 4096 warps (about
    one resident wave of an H100's 132 SMs: a second wave pays the
    warps' searches again); 1 to 16."""
    group = 1
    while group < 16 and 2 * group * n_segments <= min(m, 1 << 17):
        group *= 2
    return group


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
                              n_segments, rw, segment_group(m, n_segments))
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
    """out[idx[j]] += (v0[j], v1[j]) into [total_entries, 2] (see
    row_grad_plain)."""
    return row_grad_plain(idx, torch.stack([v0, v1], dim=1), total_entries)


TABLE_GRAD_PAIRS_KERNEL = CudaKernel(
    "table_grad_pairs",
    "qf_table_grad_pairs",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:54",
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


# ---- cell-layout table gradients (K5, K6, K7) ----

def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even, as JAX's astype) and back."""
    dtype = torch.promote_types(t.dtype, torch.float32)
    return t.to(torch.bfloat16).to(dtype)


def row_grad_plain(idx: torch.Tensor, vals: torch.Tensor,
                   total_entries: int) -> torch.Tensor:
    """K5's function: out[idx[j]] += vals[j] into [total_entries, RW]
    with one index_add_; entries outside [0, total_entries) are dropped,
    as the kernels drop them. Sums in f32 (f64 for f64 values, a
    reference sum)."""
    dtype = torch.promote_types(vals.dtype, torch.float32)
    keep = ((idx >= 0) & (idx < total_entries))[:, None]
    out = torch.zeros((total_entries, vals.shape[1]), dtype=dtype,
                      device=vals.device)
    out.index_add_(0, idx.to(torch.int64).clamp(0, total_entries - 1),
                   torch.where(keep, vals.to(dtype), 0.0))
    return out


def pair_grad_plain(idx: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    total_entries: int) -> torch.Tensor:
    """K6's function: lo, hi [M, PW] rounded to bf16 and summed into
    [total_entries, 2*PW], column 2k <- lo[:, k], 2k+1 <- hi[:, k]."""
    return row_grad_plain(idx, pair_rows(lo, hi), total_entries)


def pair_rows(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The [M, 2*PW] contribution rows of K6: bf16(lo[:, k]) at column
    2k, bf16(hi[:, k]) at 2k+1."""
    m, pw = lo.shape
    return torch.stack([_bf16(lo), _bf16(hi)], dim=2).reshape(m, 2 * pw)


def tet_factor_grad_plain(idx: torch.Tensor, wk: torch.Tensor,
                          c1: torch.Tensor, c2: torch.Tensor,
                          g: torch.Tensor,
                          total_entries: int) -> torch.Tensor:
    """K7's function, as JAX's _factor_grad_reference
    (hashgrid_sorted.py:514-561): wk [M, 4] and g [M, F] rounded to
    bf16, each product wk[:, t] * g[:, f] rounded to bf16 and added at
    column slot_t * F + f of row idx, slots (0, c1, c2, 7); the other
    four slots get nothing, nor do slots outside 0..7. Entries outside
    [0, total_entries) are dropped."""
    return row_grad_plain(idx, factor_rows(wk, c1, c2, g), total_entries)


def factor_rows(wk: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """The [M, 8F] contribution rows that K7 builds from its factors:
    bf16(bf16(wk[:, t]) * bf16(g[:, f])) at column slot_t * F + f."""
    m, F = g.shape
    dev = g.device
    slots = torch.stack([torch.zeros_like(c1), c1, c2,
                         torch.full_like(c1, 7)], dim=1).to(torch.int64)
    ok = ((slots >= 0) & (slots < 8))[:, :, None]
    prod = _bf16(_bf16(wk)[:, :, None] * _bf16(g)[:, None, :])  # [M, 4, F]
    cols = slots.clamp(0, 7)[:, :, None] * F + torch.arange(F, device=dev)
    rows = torch.zeros((m, 8 * F), dtype=prod.dtype, device=dev)
    rows.scatter_add_(1, cols.reshape(m, 4 * F),
                      torch.where(ok, prod, 0.0).reshape(m, 4 * F))
    return rows


CELL_ROW_GRAD_KERNEL = CudaKernel(
    "cell_row_grad",
    "qf_cell_row_grad",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:175",
    library="cell_table_grad",
)
CELL_PAIR_GRAD_KERNEL = CudaKernel(
    "cell_pair_grad",
    "qf_cell_pair_grad",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:238",
    library="cell_table_grad",
)
CELL_FACTOR_GRAD_KERNEL = CudaKernel(
    "cell_factor_grad_stream",
    "qf_cell_factor_grad",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:301",
    library="cell_factor_grad",
)


def _check_stream(idx: torch.Tensor, dev: torch.device, m: int,
                  total_entries: int) -> None:
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx has dtype {idx.dtype}, expected int32/int64")
    check_cuda_tensor(idx, "idx", idx.dtype, dev, 1)
    if idx.shape[0] != m:
        raise ValueError(f"{idx.shape[0]} indices for {m} contributions")
    if total_entries <= 0:
        raise ValueError(f"total_entries must be > 0, got {total_entries}")


def _check_aligned(t: torch.Tensor, name: str, n_bytes: int) -> None:
    if t.data_ptr() % n_bytes:
        raise ValueError(f"{name} must be {n_bytes}-byte aligned")


def row_grad_kernel(idx: torch.Tensor, vals: torch.Tensor,
                    total_entries: int) -> torch.Tensor:
    """Launch K5 (csrc/cell_table_grad.cu) on idx [M] int32/int64 and
    vals [M, RW] f32 on the card, RW in {8, 16, 32, 64, 128} ->
    [total_entries, RW] f32."""
    dev = vals.device
    check_cuda_tensor(vals, "vals", torch.float32, dev, 2)
    m, rw = vals.shape
    _check_stream(idx, dev, m, total_entries)
    if rw not in (8, 16, 32, 64, 128):
        raise ValueError(f"row width {rw} not in (8, 16, 32, 64, 128)")
    _check_aligned(vals, "vals", 16)
    out = torch.zeros((total_entries, rw), dtype=torch.float32, device=dev)
    if m:
        CELL_ROW_GRAD_KERNEL.launch(
            dev, ptr(idx), int(idx.dtype == torch.int64), ptr(vals),
            ptr(out), m, rw, total_entries)
    return out


def pair_grad_kernel(idx: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     total_entries: int) -> torch.Tensor:
    """Launch K6 (csrc/cell_table_grad.cu) on idx [M] int32/int64 and
    lo, hi [M, PW] f32 on the card, PW in {2, 4, 8, 16, 32, 64} ->
    [total_entries, 2*PW] f32."""
    dev = lo.device
    check_cuda_tensor(lo, "lo", torch.float32, dev, 2)
    check_cuda_tensor(hi, "hi", torch.float32, dev, 2)
    m, pw = lo.shape
    if hi.shape != lo.shape:
        raise ValueError(f"hi is {tuple(hi.shape)}, lo {tuple(lo.shape)}")
    _check_stream(idx, dev, m, total_entries)
    if pw not in (2, 4, 8, 16, 32, 64):
        raise ValueError(f"pair width {pw} not in (2, 4, 8, 16, 32, 64)")
    _check_aligned(lo, "lo", 8)
    _check_aligned(hi, "hi", 8)
    out = torch.zeros((total_entries, 2 * pw), dtype=torch.float32,
                      device=dev)
    if m:
        CELL_PAIR_GRAD_KERNEL.launch(
            dev, ptr(idx), int(idx.dtype == torch.int64), ptr(lo), ptr(hi),
            ptr(out), m, pw, total_entries)
    return out


def tet_factor_grad_kernel(idx: torch.Tensor, wk: torch.Tensor,
                           c1: torch.Tensor, c2: torch.Tensor,
                           g: torch.Tensor,
                           total_entries: int) -> torch.Tensor:
    """Launch K7's stream entry (csrc/cell_factor_grad.cu) on idx [M]
    int32/int64, wk [M, 4] f32, c1, c2 [M] int32 and g [M, F] f32 on the
    card, F in {2, 4, 8, 16} -> [total_entries, 8F] f32."""
    dev = g.device
    check_cuda_tensor(g, "g", torch.float32, dev, 2)
    m, F = g.shape
    check_cuda_tensor(wk, "wk", torch.float32, dev, 2)
    check_cuda_tensor(c1, "c1", torch.int32, dev, 1)
    check_cuda_tensor(c2, "c2", torch.int32, dev, 1)
    if wk.shape != (m, 4) or c1.shape != (m,) or c2.shape != (m,):
        raise ValueError(f"wk {tuple(wk.shape)}, c1 {tuple(c1.shape)}, "
                         f"c2 {tuple(c2.shape)} for {m} contributions")
    _check_stream(idx, dev, m, total_entries)
    if total_entries >= 2**31:
        raise ValueError(f"{total_entries} rows: the kernel takes < 2^31")
    if F not in (2, 4, 8, 16):
        raise ValueError(f"F = {F} not in (2, 4, 8, 16)")
    _check_aligned(wk, "wk", 16)
    _check_aligned(g, "g", 8 if F == 2 else 16)
    out = torch.zeros((total_entries, 8 * F), dtype=torch.float32,
                      device=dev)
    if m:
        CELL_FACTOR_GRAD_KERNEL.launch(
            dev, ptr(idx), int(idx.dtype == torch.int64), ptr(wk), ptr(c1),
            ptr(c2), ptr(g), ptr(out), m, F, total_entries)
    return out


def sorted_row_grad(idx: torch.Tensor, vals: torch.Tensor,
                    total_entries: int) -> torch.Tensor:
    """Segment-sum cell-row contributions (K5's interface): idx [M]
    entry ids, vals [M, RW] f32 -> [total_entries, RW] f32. Exact
    modulo f32 summation order."""
    if vals.device.type == "cpu":
        return row_grad_plain(idx, vals, total_entries)
    return row_grad_kernel(idx, vals, total_entries)


def sorted_pair_grad(idx: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     total_entries: int) -> torch.Tensor:
    """Segment-sum feature-pair contributions (K6's interface), each
    value rounded to bf16 and summed in f32: idx [M], lo, hi [M, PW] ->
    [total_entries, 2*PW], column 2k from lo[:, k], 2k+1 from hi[:, k]."""
    if lo.device.type == "cpu":
        return pair_grad_plain(idx, lo, hi, total_entries)
    return pair_grad_kernel(idx, lo, hi, total_entries)


def sorted_tet_factor_grad(idx: torch.Tensor, wk: torch.Tensor,
                           c1: torch.Tensor, c2: torch.Tensor,
                           g: torch.Tensor,
                           total_entries: int) -> torch.Tensor:
    """Segment-sum tet cell contributions from their factors (K7's
    interface): idx [M], Kuhn weights wk [M, 4] (corner order 0, c1,
    c2, 7), slots c1, c2 [M] int32 in 1..6, cotangents g [M, F] ->
    [total_entries, 8F]; factors and products rounded to bf16, sums in
    f32."""
    if g.device.type == "cpu":
        return tet_factor_grad_plain(idx, wk, c1, c2, g, total_entries)
    return tet_factor_grad_kernel(idx, wk, c1, c2, g, total_entries)
