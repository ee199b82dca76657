// Per-key row sum of a key-sorted stream (forward only).
//
// Replaces the TPU kernel ops/hashgrid_sorted.py:_row_acc_kernel_packed
// as presorted_row_segment_sum drives it (_windowed_row_accumulate,
// packed=True): there a merge-path schedule of one-hot matmuls walks
// windows of output rows in order. Here the keys are already sorted, so
// no sort and no one-hot product is needed: one warp owns one segment
// k, binary-searches its run [lower_bound(k), lower_bound(k+1)), sums
// the run's rows (RW columns, one row per lane per step) in registers
// and reduces across the warp with shuffles. The order of the sum is
// fixed by M alone, so the result is deterministic. Keys >= n_seg (the
// caller's sentinel padding) lie beyond every run and are dropped;
// negative keys count to segment 0, as the clip of the JAX CPU branch.
//
// What bounds it on an H100: reading the [M, RW] f32 values once
// (32 MB at M=2^20, RW=8), as 16-byte loads with neighbouring lanes on
// neighbouring rows, plus the ~log2(M) dependent key loads of each
// warp's two searches, which many resident warps hide.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys,
                                                 long long m, int k) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int RW>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int* __restrict__ keys,
                   const float* __restrict__ vals, float* __restrict__ out,
                   long long m, int n_seg) {
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= n_seg) return;
  const long long start = seg == 0 ? 0 : lower_bound(keys, m, seg);
  const long long end = lower_bound(keys, m, seg + 1);

  float acc[RW];
#pragma unroll
  for (int c = 0; c < RW; ++c) acc[c] = 0.0f;
  for (long long r = start + lane; r < end; r += 32) {
    if constexpr (RW % 4 == 0) {
      const float4* row = reinterpret_cast<const float4*>(vals + r * RW);
#pragma unroll
      for (int q = 0; q < RW / 4; ++q) {
        const float4 v = __ldg(row + q);
        acc[4 * q + 0] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < RW; ++c) acc[c] += __ldg(vals + r * RW + c);
    }
  }
#pragma unroll
  for (int c = 0; c < RW; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < RW; ++c) {
      out[static_cast<long long>(seg) * RW + c] = acc[c];
    }
  }
}

template <int RW>
cudaError_t launch(const int* keys, const float* vals, float* out,
                   long long m, int n_seg, cudaStream_t stream) {
  const unsigned int blocks = qf_blocks(n_seg, kWarps);
  segment_sum_kernel<RW><<<blocks, kThreads, 0, stream>>>(keys, vals, out,
                                                          m, n_seg);
  return cudaGetLastError();
}

}  // namespace

// keys [m] i32 non-decreasing, vals [m, rw] f32 (16-byte aligned when
// rw % 4 == 0), out [n_seg, rw] f32, all device memory.
QF_EXPORT int qf_segment_sum(const int* keys, const float* vals, float* out,
                             long long m, int n_seg, int rw, void* stream) {
  if (n_seg <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rw) {
    case 1: err = launch<1>(keys, vals, out, m, n_seg, s); break;
    case 2: err = launch<2>(keys, vals, out, m, n_seg, s); break;
    case 3: err = launch<3>(keys, vals, out, m, n_seg, s); break;
    case 4: err = launch<4>(keys, vals, out, m, n_seg, s); break;
    case 5: err = launch<5>(keys, vals, out, m, n_seg, s); break;
    case 6: err = launch<6>(keys, vals, out, m, n_seg, s); break;
    case 7: err = launch<7>(keys, vals, out, m, n_seg, s); break;
    case 8: err = launch<8>(keys, vals, out, m, n_seg, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
