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
// here share one accumulation core:
// - qf_cell_factor_grad_x, the training path: the stream is never
//   built. A lane computes its (point, level)'s cell row, clipped
//   fraction and Kuhn weights from x and reads its F values of g [N, L*F]
//   itself, with the same f32 operations as ops/hashgrid.py:_cell_levels
//   and _cell_kuhn (pos = x * scale + 0.5 with two roundings and no FMA,
//   floor, the cell clipped to [0, n_axis - 1], frac = pos - cell clipped
//   to [0, 1], ranks with JAX's tie-break).
// - qf_cell_factor_grad, JAX's stream interface (sorted_tet_factor_grad):
//   lane j reads contribution j of the stream.
// Hopper runs blocks in no order, so nothing is sorted; the sums go into
// the gradient with 16-byte float4 atomicAdds (native on sm_90) in an
// order that varies from run to run. A product of two bf16 values is
// exact in f32, so __float2bfloat16_rn(w * g) is JAX's bf16 product bit
// for bit.
//
// What bounds it on an H100: the atomics' throughput in L2. The fused
// entry must read x and g once and write [E, 8F] (2^20 points, L8 F4:
// 12.6 + 134 + 56 MB, ~61 us at 3.35 TB/s); the stream entry reads
// 48 bytes a contribution instead of 16 + 12/L. Both issue up to 4 * F/4
// float4 atomics a contribution, and the dense coarse level (3,376 rows)
// takes ~310 contributions a row. The design:
// - Warp aggregation. The fused entry lays warps out level-major: a warp
//   holds 32 consecutive points of one level. Along a ray, neighbouring
//   samples share the cell of every level coarser than the sample
//   spacing. __match_any_sync groups the lanes of equal rows; a lane
//   alone in its group adds its own 4 slots from registers, and a group
//   of k lanes publishes its factors to shared memory and spreads the
//   row's 2F float4 chunks over its k lanes, each summing its chunks
//   over the group, so a row takes at most one atomic per chunk.
// - Lanes whose F cotangent values are all zero (the renderer's padded
//   samples), entries outside [0, E) and all-zero chunks add nothing.
#include <cuda_bf16.h>

#include "grid_levels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool all_zero(float4 v) {
  return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
}

// One lane's contribution: its row (-1: nothing to add), its Kuhn
// weights and cotangents rounded to bf16, and its two dynamic slots.
template <int F>
struct Contribution {
  int row;
  int s1, s2;
  float w[4];
  float g[F];
};

// A warp's published factors, one column per lane.
template <int F>
struct WarpFactors {
  float w[4][32];
  int slot[2][32];
  float g[F][32];
};

// Adds the F products bf16(w * g[f]) at the columns of `slot` in `row`
// (one float4 atomic per 4 columns, one float2 at F = 2); a slot outside
// [0, 8) adds nothing.
template <int F>
__device__ __forceinline__ void add_slot(float* __restrict__ row, int slot,
                                         float w, const float (&g)[F]) {
  if (slot < 0 || slot > 7) return;
  float* dst = row + slot * F;
  if constexpr (F == 2) {
    const float2 p = make_float2(bf16_round(__fmul_rn(w, g[0])),
                                 bf16_round(__fmul_rn(w, g[1])));
    if (p.x != 0.0f || p.y != 0.0f) {
      atomicAdd(reinterpret_cast<float2*>(dst), p);
    }
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 p = make_float4(bf16_round(__fmul_rn(w, g[4 * q + 0])),
                                   bf16_round(__fmul_rn(w, g[4 * q + 1])),
                                   bf16_round(__fmul_rn(w, g[4 * q + 2])),
                                   bf16_round(__fmul_rn(w, g[4 * q + 3])));
      if (!all_zero(p)) atomicAdd(reinterpret_cast<float4*>(dst) + q, p);
    }
  }
}

// Member j's part of float4 chunk q of the row (floats 4q .. 4q + 3):
// at F >= 4 slot q / (F/4), features 4 (q mod F/4) ..; at F = 2 slots 2q
// and 2q + 1, features 0 and 1 of each.
template <int F>
__device__ __forceinline__ void add_member_chunk(const WarpFactors<F>& wf,
                                                 int j, int q, float4& acc) {
  const int slots[4] = {0, wf.slot[0][j], wf.slot[1][j], 7};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float w = wf.w[t][j];
    if constexpr (F == 2) {
      if (slots[t] == 2 * q) {
        acc.x += bf16_round(__fmul_rn(w, wf.g[0][j]));
        acc.y += bf16_round(__fmul_rn(w, wf.g[1][j]));
      } else if (slots[t] == 2 * q + 1) {
        acc.z += bf16_round(__fmul_rn(w, wf.g[0][j]));
        acc.w += bf16_round(__fmul_rn(w, wf.g[1][j]));
      }
    } else {
      if (slots[t] == q / (F / 4)) {
        const int f = q % (F / 4) * 4;
        acc.x += bf16_round(__fmul_rn(w, wf.g[f + 0][j]));
        acc.y += bf16_round(__fmul_rn(w, wf.g[f + 1][j]));
        acc.z += bf16_round(__fmul_rn(w, wf.g[f + 2][j]));
        acc.w += bf16_round(__fmul_rn(w, wf.g[f + 3][j]));
      }
    }
  }
}

// The accumulation core. All 32 lanes of the warp call it together.
template <int F>
__device__ __forceinline__ void add_contribution(float* __restrict__ out,
                                                 const Contribution<F>& c,
                                                 WarpFactors<F>& wf,
                                                 int lane) {
  const unsigned int group = __match_any_sync(0xffffffffu, c.row);
  if (c.row < 0) return;
  float* row = out + static_cast<long long>(c.row) * 8 * F;
  const int k = __popc(group);
  if (k == 1) {
    add_slot<F>(row, 0, c.w[0], c.g);
    add_slot<F>(row, c.s1, c.w[1], c.g);
    add_slot<F>(row, c.s2, c.w[2], c.g);
    add_slot<F>(row, 7, c.w[3], c.g);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) wf.w[t][lane] = c.w[t];
  wf.slot[0][lane] = c.s1;
  wf.slot[1][lane] = c.s2;
#pragma unroll
  for (int f = 0; f < F; ++f) wf.g[f][lane] = c.g[f];
  __syncwarp(group);
  const int rank = __popc(group & ((1u << lane) - 1u));
  for (int q = rank; q < 2 * F; q += k) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (unsigned int rest = group; rest; rest &= rest - 1u) {
      add_member_chunk<F>(wf, __ffs(rest) - 1, q, acc);
    }
    if (!all_zero(acc)) atomicAdd(reinterpret_cast<float4*>(row) + q, acc);
  }
}

template <int F>
__device__ __forceinline__ bool any_nonzero(const float (&g)[F]) {
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) any |= g[f] != 0.0f;
  return any;
}

// F values from p (8-byte aligned at F = 2, else 16), rounded to bf16.
template <int F>
__device__ __forceinline__ void load_g(const float* __restrict__ p,
                                       float (&g)[F]) {
  if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    g[0] = bf16_round(v.x);
    g[1] = bf16_round(v.y);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      g[4 * q + 0] = bf16_round(v.x);
      g[4 * q + 1] = bf16_round(v.y);
      g[4 * q + 2] = bf16_round(v.z);
      g[4 * q + 3] = bf16_round(v.w);
    }
  }
}

// Fused front end. Warp task t = (group t / L of 32 points, level t % L).
template <int F>
__global__ void __launch_bounds__(kThreads)
cell_factor_grad_x_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ out, long long n,
                          int n_levels, Levels lv, long long n_entries) {
  __shared__ WarpFactors<F> factors[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long p = task / n_levels * 32 + lane;
  const int l = static_cast<int>(task % n_levels);
  if (p - lane >= n) return;  // the whole warp

  Contribution<F> c;
  c.row = -1;
  if (p < n) {
    const float scale = lv.scale[l];
    const int n_axis = lv.res[l];
    float frac[3];
    int cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fadd_rn(__fmul_rn(__ldg(x + 3 * p + a), scale),
                                  0.5f);
      cell[a] = min(max(static_cast<int>(floorf(pos)), 0), n_axis - 1);
      frac[a] = fminf(fmaxf(__fsub_rn(pos, static_cast<float>(cell[a])),
                            0.0f), 1.0f);
    }
    // Kuhn simplex: descending ranks with JAX's tie-break, slot bit of
    // axis a = 4 >> a
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    const int r[3] = {
        (fy > fx) + (fz > fx),
        (fx >= fy) + (fz > fy),
        (fx >= fz) + (fy >= fz),
    };
    float f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
    c.s1 = 0;
    c.s2 = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (r[a] == 0) f1 = frac[a];
      if (r[a] == 1) f2 = frac[a];
      if (r[a] == 2) f3 = frac[a];
      if (r[a] == 0) c.s1 += 4 >> a;
      if (r[a] <= 1) c.s2 += 4 >> a;
    }
    c.w[0] = bf16_round(__fsub_rn(1.0f, f1));
    c.w[1] = bf16_round(__fsub_rn(f1, f2));
    c.w[2] = bf16_round(__fsub_rn(f2, f3));
    c.w[3] = bf16_round(f3);
    load_g<F>(g + (p * n_levels + l) * F, c.g);
    const long long e =
        corner_index(cell[0], cell[1], cell[2], n_axis, lv.hashed[l],
                     lv.mask[l]) +
        lv.offset[l];
    if (e >= 0 && e < n_entries && any_nonzero<F>(c.g)) {
      c.row = static_cast<int>(e);
    }
  }
  add_contribution<F>(out, c, factors[warp], lane);
}

// Stream front end: lane j takes contribution j.
template <int F, typename Idx>
__global__ void __launch_bounds__(kThreads)
cell_factor_grad_kernel(const Idx* __restrict__ idx,
                        const float4* __restrict__ wk,
                        const int* __restrict__ c1,
                        const int* __restrict__ c2,
                        const float* __restrict__ g,
                        float* __restrict__ out, long long m,
                        long long n_entries) {
  __shared__ WarpFactors<F> factors[kWarps];
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j - lane >= m) return;  // the whole warp

  Contribution<F> c;
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
    load_g<F>(g + j * F, c.g);
    if (e >= 0 && e < n_entries && any_nonzero<F>(c.g)) {
      c.row = static_cast<int>(e);
    }
  }
  add_contribution<F>(out, c, factors[threadIdx.x >> 5], lane);
}

template <typename Idx>
cudaError_t launch_stream(int f, const Idx* idx, const float* wk,
                          const int* c1, const int* c2, const float* g,
                          float* out, long long m, long long n_entries,
                          cudaStream_t s) {
  const unsigned int blocks = qf_blocks(m, kThreads);
  const float4* w = reinterpret_cast<const float4*>(wk);
  switch (f) {
    case 2:
      cell_factor_grad_kernel<2, Idx><<<blocks, kThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 4:
      cell_factor_grad_kernel<4, Idx><<<blocks, kThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 8:
      cell_factor_grad_kernel<8, Idx><<<blocks, kThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    case 16:
      cell_factor_grad_kernel<16, Idx><<<blocks, kThreads, 0, s>>>(
          idx, w, c1, c2, g, out, m, n_entries);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the rows of out are indexed with int: 2^31 - 1 rows at most
constexpr long long kMaxEntries = 0x7fffffffLL;

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
  if (n < 0 || n_entries <= 0 || n_entries > kMaxEntries ||
      !make_levels(n_levels, scales, n_axis, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = qf_blocks((n + 31) / 32 * n_levels, kWarps);
  switch (n_features) {
    case 2:
      cell_factor_grad_x_kernel<2><<<blocks, kThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 4:
      cell_factor_grad_x_kernel<4><<<blocks, kThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 8:
      cell_factor_grad_x_kernel<8><<<blocks, kThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 16:
      cell_factor_grad_x_kernel<16><<<blocks, kThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (m < 0 || n_entries <= 0 || n_entries > kMaxEntries) {
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
