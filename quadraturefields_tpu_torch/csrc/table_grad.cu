// Segment sum of (entry, v0, v1) contributions into a [E, 2] table
// gradient: out[e_j] += (v0[j], v1[j]).
//
// Replaces the interface of two TPU kernels that compute this function:
// ops/hashgrid_backward.py:_kernel (K8, sorted_table_grad: the
// chunk-owner one-hot accumulate of the packed value layout, whose
// values are rounded to bf16 first) and ops/hashgrid_sorted.py:
// _acc_kernel (K1, sorted_table_grad: sort by entry, then one-hot
// matmuls over windows of the packed table). Both sort the stream by
// entry for the TPU's in-order grid; nothing is sorted here. The stage-1
// encode backward does not call either: its fused form in
// hashgrid_encode.cu never materialises the stream.
//
// Two entries on one kernel:
// - qf_table_grad_values (K8's interface): row ids and even lanes of the
//   value layout (flat value id = row * 128 + lane), as they arrive,
//   int32 or int64. A thread computes its entry (row * 128 + lane0) / 2,
//   rounds v0 and v1 to bf16 in registers and adds the pair: the whole
//   interface is one launch, with no elementwise pass before it.
// - qf_table_grad_pairs (K1's stream interface): entries and f32 values
//   as they are, no rounding.
//
// What bounds it on an H100: reading the M contributions once (16 bytes
// each with int32 ids) and writing the [E, 2] gradient (16.8M
// contributions into 6.3M entries: ~320 MB, ~95 us at 3.35 TB/s); then
// the float2 atomics. An atomic is a read-modify-write in L2, and a
// stream in no order (uniform points) hits a 50 MB gradient at random:
// an atomic that misses L2 moves a sector to and from device memory. So
// the stream, read once, is loaded evict-first (__ldcs) and the atomics
// carry an L2 evict-last policy: the 270 MB of stream passing through L2
// then evicts less of the gradient, whose lines each take several
// atomics.
// Along rays the coarse levels' entries repeat in neighbouring
// contributions, so a warp aggregates as K1 does (hashgrid_encode.cu):
// if some lane holds its neighbour's entry (one shuffle and one vote),
// __match_any_sync groups the lanes of equal entries and the group's
// first lane adds their sum, in lane order, with one atomic. Elsewhere
// each lane adds its own pair. Zero pairs (after the rounding), and
// entries outside [0, E), add nothing. The order of the sums varies from
// run to run.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kLanes = 128;  // values in a row of the value layout

// out[0:2] += v, as atomicAdd(float2*) does on sm_90, with the line kept
// in L2 in preference to the stream's (evict_last)
__device__ __forceinline__ void add_evict_last(float2* out, float2 v) {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  asm volatile("red.global.add.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;"
               :: "l"(out), "f"(v.x), "f"(v.y), "l"(policy)
               : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kValues: idx holds row ids and lane0 the even lanes (K8), values
// rounded to bf16; else idx holds the entries (lane0 unused).
template <typename Idx, typename Lane, bool kValues>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const Idx* __restrict__ idx, const Lane* __restrict__ lane0,
             const float* __restrict__ v0, const float* __restrict__ v1,
             float2* __restrict__ out, long long m, long long n_entries) {
  __shared__ float2 staged[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (j - lane >= m) return;  // the whole warp

  long long e = -1;
  float2 v = make_float2(0.0f, 0.0f);
  if (j < m) {
    const long long i = static_cast<long long>(__ldcs(idx + j));
    if constexpr (kValues) {
      // an arithmetic shift: floor division, as the plain version's
      e = (i * kLanes + static_cast<long long>(__ldcs(lane0 + j))) >> 1;
      v = make_float2(bf16_round(__ldcs(v0 + j)),
                      bf16_round(__ldcs(v1 + j)));
    } else {
      e = i;
      v = make_float2(__ldcs(v0 + j), __ldcs(v1 + j));
    }
    if (e < 0 || e >= n_entries || (v.x == 0.0f && v.y == 0.0f)) e = -1;
  }
  // every lane reaches the shuffle and the vote (the full mask)
  const long long prev = __shfl_up_sync(0xffffffffu, e, 1);
  const bool repeats = lane > 0 && e >= 0 && e == prev;
  if (!__any_sync(0xffffffffu, repeats)) {
    if (e >= 0) add_evict_last(out + e, v);
    return;
  }
  const unsigned int group = __match_any_sync(0xffffffffu, e);
  staged[warp][lane] = v;
  __syncwarp();
  if (e < 0 || lane != __ffs(group) - 1) return;
  float2 sum = make_float2(0.0f, 0.0f);
  for (unsigned int rest = group; rest; rest &= rest - 1u) {
    const float2 w = staged[warp][__ffs(rest) - 1];
    sum.x += w.x;
    sum.y += w.y;
  }
  add_evict_last(out + e, sum);
}

template <typename Idx, typename Lane, bool kValues>
cudaError_t launch(const void* idx, const void* lane0, const float* v0,
                   const float* v1, float* out, long long m,
                   long long n_entries, cudaStream_t s) {
  pairs_kernel<Idx, Lane, kValues><<<qf_blocks(m, kThreads), kThreads, 0,
                                     s>>>(
      static_cast<const Idx*>(idx), static_cast<const Lane*>(lane0), v0, v1,
      reinterpret_cast<float2*>(out), m, n_entries);
  return cudaGetLastError();
}

}  // namespace

// K1's stream interface. idx [m] (int32 if idx_is_64 == 0, else int64),
// v0, v1 [m] f32, out [n_entries, 2] f32 zeroed by the caller and added
// into, all device memory.
QF_EXPORT int qf_table_grad_pairs(const void* idx, int idx_is_64,
                                  const float* v0, const float* v1,
                                  float* out, long long m,
                                  long long n_entries, void* stream) {
  if (m < 0 || n_entries <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx_is_64
          ? launch<long long, int, false>(idx, nullptr, v0, v1, out, m,
                                          n_entries, s)
          : launch<int, int, false>(idx, nullptr, v0, v1, out, m, n_entries,
                                    s);
  return static_cast<int>(err);
}

// K8's interface. rows, lane0 [m] (each int32 if its flag is 0, else
// int64; lane0 even), v0, v1 [m] f32, out [n_entries, 2] f32 (the flat
// value gradient, n_entries = 64 per row of 128 values) zeroed by the
// caller and added into, all device memory.
QF_EXPORT int qf_table_grad_values(const void* rows, int rows_is_64,
                                   const void* lane0, int lane0_is_64,
                                   const float* v0, const float* v1,
                                   float* out, long long m,
                                   long long n_entries, void* stream) {
  if (m < 0 || n_entries <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows_is_64 && lane0_is_64) {
    err = launch<long long, long long, true>(rows, lane0, v0, v1, out, m,
                                             n_entries, s);
  } else if (rows_is_64) {
    err = launch<long long, int, true>(rows, lane0, v0, v1, out, m,
                                       n_entries, s);
  } else if (lane0_is_64) {
    err = launch<int, long long, true>(rows, lane0, v0, v1, out, m,
                                       n_entries, s);
  } else {
    err = launch<int, int, true>(rows, lane0, v0, v1, out, m, n_entries, s);
  }
  return static_cast<int>(err);
}
