// The accumulation core of the cell-layout table gradients that are
// computed from positions: K5's fused entry (cell_table_grad.cu,
// qf_cell_row_grad_x) and K7 (cell_factor_grad.cu, both entries).
//
// For every (point, level) the function adds w[slot] * g[f] at column
// slot * F + f of the level's cell row in a zeroed [E, 8F] f32 gradient:
// tet the 4 Kuhn weights at slots (0, s1, s2, 7), cube the 8 trilinear
// weights at slots 0..7 (slot = i*4 + j*2 + k for corner (i, j, k)). The
// payload sets the roundings:
// - kF32: f32 weights and cotangents, one rounding per product;
// - kBf16Sim: the same product rounded to bf16 (JAX's "bf16sim");
// - kBf16Factor: weights and cotangents rounded to bf16 first, then the
//   product rounded to bf16 (K7; a product of two bf16 values is exact
//   in f32, so this is JAX's bf16 product bit for bit).
//
// The cell math (cell_row) is ops/hashgrid.py:_cell_levels with the same
// f32 operations (pos = x * scale + 0.5 with two roundings and no FMA,
// floor, the cell clipped to [0, n_axis - 1], frac = pos - cell clipped
// to [0, 1]); the weights are _cell_kuhn's (descending ranks with JAX's
// tie-break) and _cube_weights' ((w_x * w_y) * w_z).
//
// What bounds these kernels on an H100: the atomics' throughput in L2.
// Warp aggregation cuts it where rows repeat: the fused front end lays
// warps out level-major (a warp holds 32 consecutive points of one
// level), and along a ray neighbouring samples share the cell of every
// level coarser than the sample spacing. __match_any_sync groups the
// lanes of equal rows; a lane alone in its group adds its own slots from
// registers, and a group of k lanes publishes its factors to shared
// memory and spreads the row's 2F float4 chunks over its k lanes, each
// summing its chunks over the group, so a row takes at most one atomic
// per chunk. Lanes whose F cotangent values are all zero (the renderer's
// padded samples), entries outside [0, E) and all-zero chunks add
// nothing. The sums go in with 16-byte float4 atomicAdds (native on
// sm_90; float2 for a lone tet slot at F = 2) in an order that varies
// from run to run.
#pragma once

#include <cuda_bf16.h>

#include "grid_levels.cuh"

namespace {

constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;

enum class Payload { kF32, kBf16Sim, kBf16Factor };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool all_zero(float4 v) {
  return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
}

template <Payload P>
__device__ __forceinline__ float product(float w, float g) {
  const float p = __fmul_rn(w, g);
  if constexpr (P == Payload::kF32) {
    return p;
  } else {
    return bf16_round(p);
  }
}

// One lane's contribution: its row (-1: nothing to add), its slot
// weights (tet: at slots 0, s1, s2, 7; cube: at slots 0..7) and its F
// cotangent values, both as the payload takes them.
template <int F, bool kTet>
struct Contribution {
  static constexpr int kSlots = kTet ? 4 : 8;
  int row;
  int s1, s2;  // tet only
  float w[kSlots];
  float g[F];
};

// A warp's published factors, one column per lane.
template <int F, bool kTet>
struct WarpFactors {
  float w[Contribution<F, kTet>::kSlots][32];
  int slot[2][32];  // tet only
  float g[F][32];
};

// Adds the F products w * g[f] at the columns of `slot` in `row` (one
// float4 atomic per 4 columns, one float2 at F = 2); a slot outside
// [0, 8) adds nothing.
template <int F, Payload P>
__device__ __forceinline__ void add_slot(float* __restrict__ row, int slot,
                                         float w, const float (&g)[F]) {
  if (slot < 0 || slot > 7) return;
  float* dst = row + slot * F;
  if constexpr (F == 2) {
    const float2 p = make_float2(product<P>(w, g[0]), product<P>(w, g[1]));
    if (p.x != 0.0f || p.y != 0.0f) {
      atomicAdd(reinterpret_cast<float2*>(dst), p);
    }
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 p = make_float4(
          product<P>(w, g[4 * q + 0]), product<P>(w, g[4 * q + 1]),
          product<P>(w, g[4 * q + 2]), product<P>(w, g[4 * q + 3]));
      if (!all_zero(p)) atomicAdd(reinterpret_cast<float4*>(dst) + q, p);
    }
  }
}

// A lone lane's whole contribution, from registers.
template <int F, bool kTet, Payload P>
__device__ __forceinline__ void add_alone(float* __restrict__ row,
                                          const Contribution<F, kTet>& c) {
  if constexpr (kTet) {
    add_slot<F, P>(row, 0, c.w[0], c.g);
    add_slot<F, P>(row, c.s1, c.w[1], c.g);
    add_slot<F, P>(row, c.s2, c.w[2], c.g);
    add_slot<F, P>(row, 7, c.w[3], c.g);
  } else if constexpr (F == 2) {
    // slots 2q and 2q + 1 fill float4 chunk q
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 p = make_float4(
          product<P>(c.w[2 * q], c.g[0]), product<P>(c.w[2 * q], c.g[1]),
          product<P>(c.w[2 * q + 1], c.g[0]),
          product<P>(c.w[2 * q + 1], c.g[1]));
      if (!all_zero(p)) atomicAdd(reinterpret_cast<float4*>(row) + q, p);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) add_slot<F, P>(row, s, c.w[s], c.g);
  }
}

// Member j's part of float4 chunk q of the row (floats 4q .. 4q + 3):
// at F >= 4 slot q / (F/4), features 4 (q mod F/4) ..; at F = 2 slots 2q
// and 2q + 1, features 0 and 1 of each.
template <int F, bool kTet, Payload P>
__device__ __forceinline__ void add_member_chunk(
    const WarpFactors<F, kTet>& wf, int j, int q, float4& acc) {
  if constexpr (kTet) {
    const int slots[4] = {0, wf.slot[0][j], wf.slot[1][j], 7};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float w = wf.w[t][j];
      if constexpr (F == 2) {
        if (slots[t] == 2 * q) {
          acc.x += product<P>(w, wf.g[0][j]);
          acc.y += product<P>(w, wf.g[1][j]);
        } else if (slots[t] == 2 * q + 1) {
          acc.z += product<P>(w, wf.g[0][j]);
          acc.w += product<P>(w, wf.g[1][j]);
        }
      } else {
        if (slots[t] == q / (F / 4)) {
          const int f = q % (F / 4) * 4;
          acc.x += product<P>(w, wf.g[f + 0][j]);
          acc.y += product<P>(w, wf.g[f + 1][j]);
          acc.z += product<P>(w, wf.g[f + 2][j]);
          acc.w += product<P>(w, wf.g[f + 3][j]);
        }
      }
    }
  } else if constexpr (F == 2) {
    const float w0 = wf.w[2 * q][j], w1 = wf.w[2 * q + 1][j];
    acc.x += product<P>(w0, wf.g[0][j]);
    acc.y += product<P>(w0, wf.g[1][j]);
    acc.z += product<P>(w1, wf.g[0][j]);
    acc.w += product<P>(w1, wf.g[1][j]);
  } else {
    const float w = wf.w[q / (F / 4)][j];
    const int f = q % (F / 4) * 4;
    acc.x += product<P>(w, wf.g[f + 0][j]);
    acc.y += product<P>(w, wf.g[f + 1][j]);
    acc.z += product<P>(w, wf.g[f + 2][j]);
    acc.w += product<P>(w, wf.g[f + 3][j]);
  }
}

// The accumulation core. All 32 lanes of the warp call it together.
template <int F, bool kTet, Payload P>
__device__ __forceinline__ void add_contribution(
    float* __restrict__ out, const Contribution<F, kTet>& c,
    WarpFactors<F, kTet>& wf, int lane) {
  const unsigned int group = __match_any_sync(0xffffffffu, c.row);
  if (c.row < 0) return;
  float* row = out + static_cast<long long>(c.row) * 8 * F;
  const int k = __popc(group);
  if (k == 1) {
    add_alone<F, kTet, P>(row, c);
    return;
  }
#pragma unroll
  for (int t = 0; t < Contribution<F, kTet>::kSlots; ++t) {
    wf.w[t][lane] = c.w[t];
  }
  if constexpr (kTet) {
    wf.slot[0][lane] = c.s1;
    wf.slot[1][lane] = c.s2;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) wf.g[f][lane] = c.g[f];
  __syncwarp(group);
  const int rank = __popc(group & ((1u << lane) - 1u));
  for (int q = rank; q < 2 * F; q += k) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (unsigned int rest = group; rest; rest &= rest - 1u) {
      add_member_chunk<F, kTet, P>(wf, __ffs(rest) - 1, q, acc);
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

// F values from p (8-byte aligned at F = 2, else 16), rounded to bf16
// when kRound.
template <int F, bool kRound>
__device__ __forceinline__ void load_g(const float* __restrict__ p,
                                       float (&g)[F]) {
  auto r = [](float v) { return kRound ? bf16_round(v) : v; };
  if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    g[0] = r(v.x);
    g[1] = r(v.y);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      g[4 * q + 0] = r(v.x);
      g[4 * q + 1] = r(v.y);
      g[4 * q + 2] = r(v.z);
      g[4 * q + 3] = r(v.w);
    }
  }
}

// The cell row of point p within its level (scale, n_axis cells an axis,
// hashed or dense, the hash mask) and its clipped fraction, as
// ops/hashgrid.py:_cell_levels.
__device__ __forceinline__ long long cell_row(const float* __restrict__ x,
                                              long long p, float scale,
                                              int n_axis, int hashed,
                                              unsigned int mask,
                                              float (&frac)[3]) {
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(__ldg(x + 3 * p + a), scale),
                                0.5f);
    cell[a] = min(max(static_cast<int>(floorf(pos)), 0), n_axis - 1);
    frac[a] = fminf(fmaxf(__fsub_rn(pos, static_cast<float>(cell[a])),
                          0.0f), 1.0f);
  }
  return corner_index(cell[0], cell[1], cell[2], n_axis, hashed, mask);
}

// The slot weights of a cell fraction into c: tet the Kuhn simplex
// (descending ranks with JAX's tie-break, slot bit of axis a = 4 >> a),
// cube the trilinear weights ((w_x * w_y) * w_z); rounded to bf16 for
// kBf16Factor.
template <int F, bool kTet, Payload P>
__device__ __forceinline__ void cell_weights(const float (&frac)[3],
                                             Contribution<F, kTet>& c) {
  auto r = [](float v) {
    return P == Payload::kBf16Factor ? bf16_round(v) : v;
  };
  if constexpr (kTet) {
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    const int rank[3] = {
        (fy > fx) + (fz > fx),
        (fx >= fy) + (fz > fy),
        (fx >= fz) + (fy >= fz),
    };
    float f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
    c.s1 = 0;
    c.s2 = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (rank[a] == 0) f1 = frac[a];
      if (rank[a] == 1) f2 = frac[a];
      if (rank[a] == 2) f3 = frac[a];
      if (rank[a] == 0) c.s1 += 4 >> a;
      if (rank[a] <= 1) c.s2 += 4 >> a;
    }
    c.w[0] = r(__fsub_rn(1.0f, f1));
    c.w[1] = r(__fsub_rn(f1, f2));
    c.w[2] = r(__fsub_rn(f2, f3));
    c.w[3] = r(f3);
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float w0 = (s >> 2) & 1 ? frac[0] : __fsub_rn(1.0f, frac[0]);
      const float w1 = (s >> 1) & 1 ? frac[1] : __fsub_rn(1.0f, frac[1]);
      const float w2 = s & 1 ? frac[2] : __fsub_rn(1.0f, frac[2]);
      c.w[s] = r(__fmul_rn(__fmul_rn(w0, w1), w2));
    }
  }
}

// The fused front end: x [n, 3] f32, g [n, L*F] f32, out [n_entries, 8F]
// f32. Warp task t = (group t / L of 32 points, level t % L); launch
// cell_blocks(n, L) blocks of kCellThreads.
template <int F, bool kTet, Payload P>
__global__ void __launch_bounds__(kCellThreads)
cell_grad_x_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ out, long long n, int n_levels,
                   Levels lv, long long n_entries) {
  __shared__ WarpFactors<F, kTet> factors[kCellWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task =
      static_cast<long long>(blockIdx.x) * kCellWarps + warp;
  const long long p = task / n_levels * 32 + lane;
  const int l = static_cast<int>(task % n_levels);
  if (p - lane >= n) return;  // the whole warp

  Contribution<F, kTet> c;
  c.row = -1;
  if (p < n) {
    float frac[3];
    const long long e = cell_row(x, p, lv.scale[l], lv.res[l],
                                 lv.hashed[l], lv.mask[l], frac) +
                        lv.offset[l];
    cell_weights<F, kTet, P>(frac, c);
    load_g<F, P == Payload::kBf16Factor>(g + (p * n_levels + l) * F, c.g);
    if (e >= 0 && e < n_entries && any_nonzero<F>(c.g)) {
      c.row = static_cast<int>(e);
    }
  }
  add_contribution<F, kTet, P>(out, c, factors[warp], lane);
}

inline unsigned int cell_blocks(long long n, int n_levels) {
  return qf_blocks((n + 31) / 32 * n_levels, kCellWarps);
}

// Launch the fused front end for F in {2, 4, 8, 16}.
template <bool kTet, Payload P>
cudaError_t launch_cell_grad_x(const float* x, const float* g, float* out,
                               long long n, int n_levels, int n_features,
                               const Levels& lv, long long n_entries,
                               cudaStream_t s) {
  const unsigned int blocks = cell_blocks(n, n_levels);
  switch (n_features) {
    case 2:
      cell_grad_x_kernel<2, kTet, P><<<blocks, kCellThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 4:
      cell_grad_x_kernel<4, kTet, P><<<blocks, kCellThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 8:
      cell_grad_x_kernel<8, kTet, P><<<blocks, kCellThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    case 16:
      cell_grad_x_kernel<16, kTet, P><<<blocks, kCellThreads, 0, s>>>(
          x, g, out, n, n_levels, lv, n_entries);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the rows of out are indexed with int: 2^31 - 1 rows at most
constexpr long long kMaxCellEntries = 0x7fffffffLL;

}  // namespace
