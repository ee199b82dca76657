// Segment sum of (entry, v0, v1) contributions into a [E, 2] table
// gradient: out[idx[j]] += (v0[j], v1[j]).
//
// Replaces the interface of two TPU kernels that compute this function:
// ops/hashgrid_sorted.py:_acc_kernel (K1, sorted_table_grad: sort by
// entry, then one-hot matmuls over windows of the packed table) and
// ops/hashgrid_backward.py:_kernel (K8, the chunk-owner one-hot
// accumulate, whose values are rounded to bf16 first; the Python
// wrapper rounds them). The stage-1 encode backward does not call it:
// its fused form in hashgrid_encode.cu never materialises the stream.
//
// One thread per contribution adds its pair with one float2 atomicAdd
// (native on sm_90); no sort. Entries outside [0, E) are skipped. The
// order of the sums varies from run to run. What bounds it on an H100:
// reading the M triples once (12 or 16 bytes each) and writing the
// [E, 2] gradient (16.8M triples into 6.3M entries: ~250 MB, ~75 us at
// 3.35 TB/s), and the atomics' throughput in L2 when many contributions
// share an entry.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const Idx* __restrict__ idx, const float* __restrict__ v0,
             const float* __restrict__ v1, float2* __restrict__ out,
             long long m, long long n_entries) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const long long e = static_cast<long long>(__ldg(idx + j));
  if (e < 0 || e >= n_entries) return;
  atomicAdd(out + e, make_float2(__ldg(v0 + j), __ldg(v1 + j)));
}

}  // namespace

// idx [m] (int32 if idx_is_64 == 0, else int64), v0, v1 [m] f32, out
// [n_entries, 2] f32 zeroed by the caller and added into, all device
// memory.
QF_EXPORT int qf_table_grad_pairs(const void* idx, int idx_is_64,
                                  const float* v0, const float* v1,
                                  float* out, long long m,
                                  long long n_entries, void* stream) {
  if (m < 0 || n_entries <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = qf_blocks(m, kThreads);
  float2* o = reinterpret_cast<float2*>(out);
  if (idx_is_64) {
    pairs_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(idx), v0, v1, o, m, n_entries);
  } else {
    pairs_kernel<int><<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(idx), v0, v1, o, m, n_entries);
  }
  return static_cast<int>(cudaGetLastError());
}
