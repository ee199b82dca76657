// Cell-layout table gradients: M contributions summed into the rows of
// a zeroed [E, RW] gradient, RW = 8F (row slot c*F + f holds corner c,
// feature f).
//
// Replaces three TPU kernels of quadraturefields_tpu/ops/hashgrid_sorted.py
// that compute this one function from three input forms. Each runs
// after a lax.sort of the stream by entry and walks the sorted stream
// window by window with one-hot matmuls, a sequential grid that carries
// a window's sums from one step to the next:
//   K5 _row_acc_kernel_packed (sorted_row_grad): f32 rows [M, RW];
//   K6 _row_acc_kernel_pair (sorted_pair_grad): lo, hi [M, PW], each
//      value rounded to bf16, column 2k <- lo[k], 2k+1 <- hi[k];
//   K7 _row_acc_kernel_factor (sorted_tet_factor_grad): Kuhn weights
//      wk [M, 4] and cotangents g [M, F], both rounded to bf16, each
//      product w * g rounded to bf16 and added at the slots
//      (0, c1, c2, 7); the other four slots get nothing.
// Hopper runs blocks in no order, so nothing is sorted: each thread adds
// its part of one contribution into the gradient with one 16-byte float4
// atomicAdd (native on sm_90, global memory). Entries outside [0, E) are
// skipped, and so are atomics whose values are all zero (the renderer's
// padded samples carry zero cotangents; adding zeros changes no sum).
// The order of the sums varies from run to run. A product of two bf16
// values is exact in f32, so __float2bfloat16_rn(w * g) is JAX's bf16
// product bit for bit.
//
// What bounds them on an H100: bytes, then the atomics. Reading the
// stream once (with int64 entries: K5 and K6 8 + 128 B a contribution at
// F = 4, K7 8 + 16 + 4 + 4 + 16 = 48 B) and writing [E, 8F]; at the
// stage-1 cell scale (M = 8.4M contributions into E = 439,472 rows of 32
// floats) ~0.35 ms for K5 and K6 and ~0.14 ms for K7 at 3.35 TB/s. K7
// rebuilds the 8F products from 4 + F factors in registers, so it reads
// about a third of K5's bytes. Next come the atomics' throughput in L2:
// the dense coarse level (3,376 rows) takes ~310 contributions a row.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool all_zero(float4 v) {
  return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
}

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

// K7: one thread per contribution; 4 slots x F products, added F/4
// float4 atomics a slot (one float2 at F = 2). Slots outside [0, 8)
// add nothing.
template <int F, typename Idx>
__global__ void __launch_bounds__(kThreads)
cell_factor_grad_kernel(const Idx* __restrict__ idx,
                        const float4* __restrict__ wk,
                        const int* __restrict__ c1,
                        const int* __restrict__ c2,
                        const float* __restrict__ g,
                        float* __restrict__ out, long long m,
                        long long n_entries) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const long long e = entry(idx, j);
  if (e < 0 || e >= n_entries) return;
  const float4 w4 = __ldg(wk + j);
  const float w[4] = {bf16_round(w4.x), bf16_round(w4.y), bf16_round(w4.z),
                      bf16_round(w4.w)};
  const int slot[4] = {0, __ldg(c1 + j), __ldg(c2 + j), 7};
  float gv[F];
  if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(g) + j);
    gv[0] = bf16_round(v.x);
    gv[1] = bf16_round(v.y);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(g + j * F) + q);
      gv[4 * q + 0] = bf16_round(v.x);
      gv[4 * q + 1] = bf16_round(v.y);
      gv[4 * q + 2] = bf16_round(v.z);
      gv[4 * q + 3] = bf16_round(v.w);
    }
  }
  float* row = out + e * 8 * F;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (slot[k] < 0 || slot[k] > 7) continue;
    float* dst = row + slot[k] * F;
    if constexpr (F == 2) {
      const float2 p = make_float2(bf16_round(__fmul_rn(w[k], gv[0])),
                                   bf16_round(__fmul_rn(w[k], gv[1])));
      if (p.x != 0.0f || p.y != 0.0f) {
        atomicAdd(reinterpret_cast<float2*>(dst), p);
      }
    } else {
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float4 p =
            make_float4(bf16_round(__fmul_rn(w[k], gv[4 * q + 0])),
                        bf16_round(__fmul_rn(w[k], gv[4 * q + 1])),
                        bf16_round(__fmul_rn(w[k], gv[4 * q + 2])),
                        bf16_round(__fmul_rn(w[k], gv[4 * q + 3])));
        if (!all_zero(p)) atomicAdd(reinterpret_cast<float4*>(dst) + q, p);
      }
    }
  }
}

// log2 of a power of two v >= 1, else -1
int exact_log2(int v) {
  int s = 0;
  while ((1 << s) < v && s < 30) ++s;
  return (v >= 1 && (1 << s) == v) ? s : -1;
}

template <int F, typename Idx>
void launch_factor(const Idx* idx, const float* wk, const int* c1,
                   const int* c2, const float* g, float* out, long long m,
                   long long n_entries, cudaStream_t s) {
  cell_factor_grad_kernel<F, Idx><<<qf_blocks(m, kThreads), kThreads, 0, s>>>(
      idx, reinterpret_cast<const float4*>(wk), c1, c2, g, out, m,
      n_entries);
}

template <typename Idx>
cudaError_t launch_factor_f(int f, const Idx* idx, const float* wk,
                            const int* c1, const int* c2, const float* g,
                            float* out, long long m, long long n_entries,
                            cudaStream_t s) {
  switch (f) {
    case 2: launch_factor<2>(idx, wk, c1, c2, g, out, m, n_entries, s); break;
    case 4: launch_factor<4>(idx, wk, c1, c2, g, out, m, n_entries, s); break;
    case 8: launch_factor<8>(idx, wk, c1, c2, g, out, m, n_entries, s); break;
    case 16:
      launch_factor<16>(idx, wk, c1, c2, g, out, m, n_entries, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// K7. idx [m] (int32 / int64), wk [m, 4] f32 (16-byte aligned), c1, c2
// [m] int32, g [m, F] f32 (16-byte aligned, 8 at F = 2), out
// [n_entries, 8F] f32 zeroed by the caller and added into, all device
// memory; F in {2, 4, 8, 16}.
QF_EXPORT int qf_cell_factor_grad(const void* idx, int idx_is_64,
                                  const float* wk, const int* c1,
                                  const int* c2, const float* g, float* out,
                                  long long m, int n_features,
                                  long long n_entries, void* stream) {
  if (m < 0 || n_entries <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (idx_is_64) {
    err = launch_factor_f(n_features, static_cast<const long long*>(idx),
                          wk, c1, c2, g, out, m, n_entries, s);
  } else {
    err = launch_factor_f(n_features, static_cast<const int*>(idx), wk, c1,
                          c2, g, out, m, n_entries, s);
  }
  return static_cast<int>(err);
}
