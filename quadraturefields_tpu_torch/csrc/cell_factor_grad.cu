// Cell-layout table gradient with the bf16 factor payload (K7): for every
// (point, level), the 4 Kuhn weights wk and the F cotangent values g,
// both rounded to bf16, each product wk[t] * g[f] rounded to bf16 and
// added at column slot_t * F + f of the level's cell row in a zeroed
// [E, 8F] f32 gradient, slots (0, s1, s2, 7); the other four slots of
// the row get nothing.
//
// Replaces the TPU kernel quadraturefields_tpu/ops/hashgrid_sorted.py:
// _row_acc_kernel_factor (called from sorted_tet_factor_grad). JAX builds
// the contribution stream (entry, wk, s1, s2, g) of all N*L (point,
// level) pairs with XLA, sorts it by entry, and the TPU kernel walks the
// sorted stream window by window with one-hot matmuls. Two front ends
// here share the accumulation core of cell_grad.cuh (payload kBf16Factor)
// with K5's fused entry:
// - qf_cell_factor_grad_x, the training path: the stream is never
//   built. A lane computes its (point, level)'s cell row, clipped
//   fraction and Kuhn weights from x and reads its F values of g [N, L*F]
//   itself (cell_grad_x_kernel).
// - qf_cell_factor_grad, JAX's stream interface (sorted_tet_factor_grad):
//   lane j reads contribution j of the stream.
// Hopper runs blocks in no order, so nothing is sorted.
//
// What bounds it on an H100: the atomics' throughput in L2. The fused
// entry must read x and g once and write [E, 8F] (2^20 points, L8 F4:
// 12.6 + 134 + 56 MB, ~61 us at 3.35 TB/s); the stream entry reads
// 48 bytes a contribution instead of 16 + 12/L. Both issue up to 4 * F/4
// float4 atomics a contribution, and the dense coarse level (3,376 rows)
// takes ~310 contributions a row; the core's warp aggregation merges the
// lanes of equal rows before their atomics.
#include "cell_grad.cuh"

namespace {

constexpr Payload kFactor = Payload::kBf16Factor;

// Stream front end: lane j takes contribution j.
template <int F, typename Idx>
__global__ void __launch_bounds__(kCellThreads)
cell_factor_grad_kernel(const Idx* __restrict__ idx,
                        const float4* __restrict__ wk,
                        const int* __restrict__ c1,
                        const int* __restrict__ c2,
                        const float* __restrict__ g,
                        float* __restrict__ out, long long m,
                        long long n_entries) {
  __shared__ WarpFactors<F, true> factors[kCellWarps];
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j - lane >= m) return;  // the whole warp

  Contribution<F, true> c;
  c.row = -1;
  if (j < m) {
    const long long e = static_cast<long long>(__ldg(idx + j));
    const float4 w4 = __ldg(wk + j);
    c.w[0] = bf16_round(w4.x);
    c.w[1] = bf16_round(w4.y);
    c.w[2] = bf16_round(w4.z);
    c.w[3] = bf16_round(w4.w);
    c.s1 = __ldg(c1 + j);
    c.s2 = __ldg(c2 + j);
    load_g<F, true>(g + j * F, c.g);
    if (e >= 0 && e < n_entries && any_nonzero<F>(c.g)) {
      c.row = static_cast<int>(e);
    }
  }
  add_contribution<F, true, kFactor>(out, c, factors[threadIdx.x >> 5],
                                     lane);
}

template <typename Idx>
cudaError_t launch_stream(int f, const Idx* idx, const float* wk,
                          const int* c1, const int* c2, const float* g,
                          float* out, long long m, long long n_entries,
                          cudaStream_t s) {
  const unsigned int blocks = qf_blocks(m, kCellThreads);
  const float4* w = reinterpret_cast<const float4*>(wk);
  switch (f) {
    case 2:
      cell_factor_grad_kernel<2, Idx><<<blocks, kCellThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 4:
      cell_factor_grad_kernel<4, Idx><<<blocks, kCellThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 8:
      cell_factor_grad_kernel<8, Idx><<<blocks, kCellThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 16:
      cell_factor_grad_kernel<16, Idx><<<blocks, kCellThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Fused K7 (the training path). x [n, 3] f32 in [0, 1], g [n, L*F] f32
// (16-byte aligned, 8 at F = 2), out [n_entries, 8F] f32 zeroed by the
// caller and added into, all device memory; F in {2, 4, 8, 16}. The
// per-level arrays (length L) are host memory: scales, cells per axis,
// level sizes and row offsets.
QF_EXPORT int qf_cell_factor_grad_x(const float* x, const float* g,
                                    float* out, long long n, int n_levels,
                                    int n_features, const float* scales,
                                    const int* n_axis,
                                    const long long* sizes,
                                    const long long* offsets,
                                    long long n_entries, void* stream) {
  Levels lv;
  if (n < 0 || n_entries <= 0 || n_entries > kMaxCellEntries ||
      !make_levels(n_levels, scales, n_axis, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_cell_grad_x<true, kFactor>(
      x, g, out, n, n_levels, n_features, lv, n_entries,
      static_cast<cudaStream_t>(stream)));
}

// K7's stream interface. idx [m] (int32 if idx_is_64 == 0, else int64),
// wk [m, 4] f32 (16-byte aligned), c1, c2 [m] int32, g [m, F] f32
// (16-byte aligned, 8 at F = 2), out [n_entries, 8F] f32 zeroed by the
// caller and added into, all device memory; F in {2, 4, 8, 16}. Slots
// outside [0, 8) add nothing.
QF_EXPORT int qf_cell_factor_grad(const void* idx, int idx_is_64,
                                  const float* wk, const int* c1,
                                  const int* c2, const float* g, float* out,
                                  long long m, int n_features,
                                  long long n_entries, void* stream) {
  if (m < 0 || n_entries <= 0 || n_entries > kMaxCellEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (idx_is_64) {
    err = launch_stream(n_features, static_cast<const long long*>(idx), wk,
                        c1, c2, g, out, m, n_entries, s);
  } else {
    err = launch_stream(n_features, static_cast<const int*>(idx), wk, c1,
                        c2, g, out, m, n_entries, s);
  }
  return static_cast<int>(err);
}
