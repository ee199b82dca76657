// Cell-layout table gradients: M contributions summed into the rows of
// a zeroed [E, RW] gradient, RW = 8F (row slot c*F + f holds corner c,
// feature f).
//
// Replaces two TPU kernels of quadraturefields_tpu/ops/hashgrid_sorted.py
// that compute this one function from two input forms. Each runs after a
// lax.sort of the stream by entry and walks the sorted stream window by
// window with one-hot matmuls, a sequential grid that carries a window's
// sums from one step to the next:
//   K5 _row_acc_kernel_packed and _row_acc_kernel, its packed=False form
//      (sorted_row_grad): f32 rows [M, RW];
//   K6 _row_acc_kernel_pair (sorted_pair_grad): lo, hi [M, PW], each
//      value rounded to bf16, column 2k <- lo[k], 2k+1 <- hi[k].
// The third form, K7's bf16 factors, is cell_factor_grad.cu.
//
// K5 has two entries. qf_cell_row_grad_x is the cell encode's backward
// (ops/hashgrid.py cell_row_grad_x): no contribution stream is built.
// For each (point, level) a lane computes the cell row and the tet or
// cube weights from x, reads its F values of g itself and adds
// w[slot] * g[f] (f32, or rounded to bf16 for the bf16sim payload) at
// column slot * F + f, on the warp-aggregated core of cell_grad.cuh that
// K7 uses too. What bounds it: the atomics' throughput in L2, against a
// bound of reading x and g once and writing [E, 8F] (2^20 points, L8
// F4: 12.6 + 134 + 56 MB, ~61 us at 3.35 TB/s); the stream it replaces
// was 1.07 GB, written by PyTorch and read back here.
//
// K6 has two entries too. qf_cell_pair_grad_x is the cell encode's
// backward on the bf16pair route (ops/hashgrid.py cell_pair_grad_x). K6's
// lo/hi pairs carry the products w[c] * g[2p] and w[c] * g[2p + 1] of
// corner c, each rounded to bf16, into columns c*F + 2p and c*F + 2p + 1:
// the rows of K5's bf16sim payload, column for column. So the entry runs
// K5's fused core with the bf16-rounded product (Payload::kBf16Sim) and
// builds none of the [N*L, 4F] lo and hi streams that the route built in
// PyTorch before (2 x 537 MB at 2^20 points, L8 F4). Its bound and its
// limit are K5's: the same float4 atomics into [E, 8F].
//
// qf_cell_row_grad (K5's stream, JAX's interface) and qf_cell_pair_grad
// (K6's stream, JAX's interface): Hopper runs blocks in no order, so
// nothing is sorted: each thread adds its part of one contribution into
// the gradient with one 16-byte float4 atomicAdd (native on sm_90,
// global memory). Entries outside [0, E) are skipped, and so are atomics
// whose values are all zero (the renderer's padded samples carry zero
// cotangents; adding zeros changes no sum). The order of the sums varies from run to run. What bounds
// them on an H100: bytes, then the atomics. Reading the stream once
// (with int64 entries, 8 + 128 B a contribution at F = 4) and writing
// [E, 8F]; at the stage-1 cell scale (M = 8.4M contributions into
// E = 439,472 rows of 32 floats) ~0.35 ms at 3.35 TB/s. Next come the
// atomics' throughput in L2: the dense coarse level (3,376 rows) takes
// ~310 contributions a row.
#include "cell_grad.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__device__ __forceinline__ long long entry(const Idx* __restrict__ idx,
                                           long long j) {
  return static_cast<long long>(__ldg(idx + j));
}

// K5: thread t adds chunk q = t mod (RW/4) of contribution j = t / (RW/4)
// (RW/4 = 1 << shift), i.e. vals float4 t, at out float4 e * RW/4 + q.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cell_row_grad_kernel(const Idx* __restrict__ idx,
                     const float4* __restrict__ vals,
                     float4* __restrict__ out, long long m, int shift,
                     long long n_entries) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (m << shift)) return;
  const long long e = entry(idx, t >> shift);
  if (e < 0 || e >= n_entries) return;
  const float4 v = __ldg(vals + t);
  if (all_zero(v)) return;
  atomicAdd(out + (e << shift) + (t & ((1 << shift) - 1)), v);
}

// K6: thread t takes pair chunk q of contribution j (PW/2 = 1 << shift
// chunks): lo[j, 2q..2q+1] and hi[j, 2q..2q+1], float2 t of each, rounded
// to bf16 and added as (lo0, hi0, lo1, hi1) at columns 4q..4q+3.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cell_pair_grad_kernel(const Idx* __restrict__ idx,
                      const float2* __restrict__ lo,
                      const float2* __restrict__ hi,
                      float4* __restrict__ out, long long m, int shift,
                      long long n_entries) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (m << shift)) return;
  const long long e = entry(idx, t >> shift);
  if (e < 0 || e >= n_entries) return;
  const float2 a = __ldg(lo + t);
  const float2 b = __ldg(hi + t);
  const float4 v = make_float4(bf16_round(a.x), bf16_round(b.x),
                               bf16_round(a.y), bf16_round(b.y));
  if (all_zero(v)) return;
  atomicAdd(out + (e << shift) + (t & ((1 << shift) - 1)), v);
}

// log2 of a power of two v >= 1, else -1
int exact_log2(int v) {
  int s = 0;
  while ((1 << s) < v && s < 30) ++s;
  return (v >= 1 && (1 << s) == v) ? s : -1;
}

}  // namespace

// K5. idx [m] (int32 if idx_is_64 == 0, else int64), vals [m, rw] f32
// (16-byte aligned), out [n_entries, rw] f32 zeroed by the caller and
// added into, all device memory; rw in {8, 16, 32, 64, 128}.
QF_EXPORT int qf_cell_row_grad(const void* idx, int idx_is_64,
                               const float* vals, float* out, long long m,
                               int rw, long long n_entries, void* stream) {
  const int shift = rw % 4 == 0 ? exact_log2(rw / 4) : -1;
  if (m < 0 || n_entries <= 0 || shift < 1 || shift > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = qf_blocks(m << shift, kThreads);
  const float4* v = reinterpret_cast<const float4*>(vals);
  float4* o = reinterpret_cast<float4*>(out);
  if (idx_is_64) {
    cell_row_grad_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(idx), v, o, m, shift, n_entries);
  } else {
    cell_row_grad_kernel<int><<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(idx), v, o, m, shift, n_entries);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6. idx [m] (int32 / int64), lo, hi [m, pw] f32 (8-byte aligned), out
// [n_entries, 2 * pw] f32 zeroed by the caller and added into, all
// device memory; pw in {2, 4, ..., 64}, a power of two.
QF_EXPORT int qf_cell_pair_grad(const void* idx, int idx_is_64,
                                const float* lo, const float* hi,
                                float* out, long long m, int pw,
                                long long n_entries, void* stream) {
  const int shift = pw % 2 == 0 ? exact_log2(pw / 2) : -1;
  if (m < 0 || n_entries <= 0 || shift < 0 || shift > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = qf_blocks(m << shift, kThreads);
  const float2* a = reinterpret_cast<const float2*>(lo);
  const float2* b = reinterpret_cast<const float2*>(hi);
  float4* o = reinterpret_cast<float4*>(out);
  if (idx_is_64) {
    cell_pair_grad_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(idx), a, b, o, m, shift, n_entries);
  } else {
    cell_pair_grad_kernel<int><<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(idx), a, b, o, m, shift, n_entries);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5 fused from positions (the cell encode's backward). x [n, 3] f32,
// g [n, L*F] f32 (16-byte aligned, 8 at F = 2), out [n_entries, 8F] f32
// zeroed by the caller and added into, all device memory; F in {2, 4, 8,
// 16}; tet: the Kuhn weights, else the 8 trilinear ones; bf16sim: each
// product rounded to bf16, else f32. The per-level arrays (length L) are
// host memory: scales, cells per axis, level sizes and row offsets.
QF_EXPORT int qf_cell_row_grad_x(const float* x, const float* g, float* out,
                                 long long n, int n_levels, int n_features,
                                 const float* scales, const int* n_axis,
                                 const long long* sizes,
                                 const long long* offsets,
                                 long long n_entries, int tet, int bf16sim,
                                 void* stream) {
  Levels lv;
  if (n < 0 || n_entries <= 0 || n_entries > kMaxCellEntries ||
      !make_levels(n_levels, scales, n_axis, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = n_features;
  cudaError_t err;
  if (tet && bf16sim) {
    err = launch_cell_grad_x<true, Payload::kBf16Sim>(
        x, g, out, n, n_levels, f, lv, n_entries, s);
  } else if (tet) {
    err = launch_cell_grad_x<true, Payload::kF32>(
        x, g, out, n, n_levels, f, lv, n_entries, s);
  } else if (bf16sim) {
    err = launch_cell_grad_x<false, Payload::kBf16Sim>(
        x, g, out, n, n_levels, f, lv, n_entries, s);
  } else {
    err = launch_cell_grad_x<false, Payload::kF32>(
        x, g, out, n, n_levels, f, lv, n_entries, s);
  }
  return static_cast<int>(err);
}

// K6 fused from positions (the cell encode's backward on the bf16pair
// route): the arguments of qf_cell_row_grad_x without the payload flag;
// every product is rounded to bf16. F in {2, 4, 8, 16} (K6 takes feature
// pairs: F even).
QF_EXPORT int qf_cell_pair_grad_x(const float* x, const float* g, float* out,
                                  long long n, int n_levels, int n_features,
                                  const float* scales, const int* n_axis,
                                  const long long* sizes,
                                  const long long* offsets,
                                  long long n_entries, int tet,
                                  void* stream) {
  Levels lv;
  if (n < 0 || n_entries <= 0 || n_entries > kMaxCellEntries ||
      !make_levels(n_levels, scales, n_axis, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tet ? launch_cell_grad_x<true, Payload::kBf16Sim>(
                x, g, out, n, n_levels, n_features, lv, n_entries, s)
          : launch_cell_grad_x<false, Payload::kBf16Sim>(
                x, g, out, n, n_levels, n_features, lv, n_entries, s);
  return static_cast<int>(err);
}
