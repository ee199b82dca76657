// Forward multiresolution hash-grid encode, corner layout.
//
// Replaces the TPU kernel ops/hashgrid_pallas.py:_encode_kernel (called
// from hashgrid_encode_pallas), whose math the JAX main path runs as an
// XLA gather (ops/hashgrid.py:_encode_fwd_impl). Widened from the TPU
// probe's cube-only, F=2, log2_T 13-20 form to cube and Kuhn-tet
// interpolation, any level count up to kMaxLevels, F in {1,2,4,8} and
// tables indexed with 64-bit level offsets.
//
// Per (point, level): clip x to [0,1], pos = x * scale_l + 0.5, floor
// and frac, then the 8 cube or 4 tet corners, each clipped to
// [0, res-1] and indexed densely (res^3 <= level size) or by the uint32
// xor-prime hash masked to the power-of-two level size, exactly as
// ops/hashgrid.py:_level_indices. The weighted corner rows are summed
// in corner order into out[n, l*F:(l+1)*F].
//
// What bounds it on an H100: the corner gathers. The stage-1 table
// (L16 F2 T2^19, 6,299,960 rows, 50.4 MB) cannot sit in shared memory
// and about fills the 50 MB L2, so each corner row is a dependent
// 8-byte load whose latency is that of L2 or device memory, and each
// costs a 32-byte sector. The design (tet, the trainer's default):
// - Level-major warps over a tile of consecutive points. A block takes
//   `tile` points and all L levels; a warp works on one level of 32
//   consecutive points. The renderer emits samples ray by ray, and on
//   the coarse levels neighbouring samples share corner rows, which then
//   fall into the same load instruction and the same sectors (the
//   padded slots of a sample budget all sit at one position).
// - Each thread takes kPairs (point, level) pairs of its warp's tasks at
//   once, so 8 independent row loads are in flight per thread (4
//   corners x 2 pairs; 1 pair at F = 8).
// - The [tile, L*F] output goes through shared memory, whose point rows
//   are padded so that the lanes' writes hit distinct banks, and leaves
//   as coalesced vector stores; level-major lanes would otherwise store
//   8 bytes each at a stride of L*F*4 bytes (storing so measured
//   10-75% slower, PERF.md).
// - The tile is sized from L*F to about 8.5 KB of shared memory (64
//   points at L16 F2; at least 32 points, 33 KB at L = 32, F = 8), so a
//   block never needs the opt-in above 48 KB. Larger tiles and more
//   pairs a thread measured slower on the training step's positions:
//   they cost occupancy and L1, which caches the coarse levels.
// What it does not change: on uniform points every corner load is a
// sector of its own in either layout, and the kernel runs at the
// point-major one's L2 rate; the gain is on the renderer's inputs.
// Cube keeps one thread per (point, level), point-major, storing its F
// floats straight to out: with 8 loads a thread already, the level-major
// tiles measured 18-21% slower for cube on uniform points, the valid
// samples of an eval chunk and a training step (PERF.md).
// Position arithmetic uses explicit round-to-nearest intrinsics so that
// nvcc does not contract x*s+0.5 into an FMA: floor() must see the same
// pos as the plain version.
//
// Backward (qf_hashgrid_encode_bwd): the table gradient, which replaces
// the TPU kernel ops/hashgrid_sorted.py:_acc_kernel (K1, reached from
// sorted_table_grad at ops/hashgrid.py:736-756). There the contribution
// stream (entry, w*g0, w*g1) of all N*L*C corners is sorted by entry
// and summed window by window with one-hot matmuls. Here nothing is
// materialised or sorted: each (point, level) recomputes its corners
// with the forward's own level_corners, reads its F cotangent values and
// adds w*g into the zeroed gradient with atomics. What bounds it on an
// H100: reading x and g and writing the [E, F] gradient (87 MB at 2^18
// points, L16 F2 T2^19: ~26 us at 3.35 TB/s) plus the atomics'
// throughput in L2. The coarse dense levels (4096 rows at level 0) take
// ~256 adds a row per step, which serialise in L2. The design:
// - A block per 32 consecutive points; its warps take the levels in
//   turn, so the lanes of a warp hold the 32 points at one level. The
//   renderer emits samples ray by ray, so on every level coarser than
//   the sample spacing neighbouring lanes share corner rows. The block
//   first copies the points' cotangent rows into shared memory with
//   coalesced loads: a lane reading its level's F values straight from
//   g (8 bytes at a stride of L*F*4) lost to one thread per (point,
//   level) on uniform points (PERF.md).
// - Warp aggregation where rows repeat: if some lane shares its
//   neighbour's cell (one shuffle and one vote a task),
//   __match_any_sync groups the lanes of equal rows corner by corner,
//   and a group adds its f32 sum with one atomic (one vector atomic per
//   16 bytes of the row) instead of one per lane. Elsewhere the lanes
//   add their corners back to back: matching every corner, and a zero
//   test before each atomic, cost more than they saved on uniform
//   points.
// - Lanes whose cotangent values are all zero (the sample budget's
//   padded slots, all at one position) add nothing.
//
// Stochastic backward (qf_hashgrid_encode_bwd_stochastic): grad_mode
// "stochastic", which replaces the corner pick of ops/hashgrid.py:791-812
// (XLA code in JAX, on the way to the same table gradient K1 computes).
// Each (point, level) picks ONE of its C corners with probability equal
// to its interpolation weight, from a uniform hashed from the clipped
// position's bits and the level (JAX's _hash_u01), and adds its
// unweighted cotangent g to that row alone: an unbiased estimate of the
// exact sum. The weights come from the same cell_corners as the forward
// and the exact backward and are summed in corner order with
// round-to-nearest adds, so the picks equal the plain version's wherever
// its weights equal these (tet: always); only the picked corner's row is
// hashed. Its bound on an H100: reading x and g and writing the [E, F]
// gradient (87 MB at 2^18 points, L16 F2 T2^19: ~26 us, the wrapper's
// zeroing of the gradient included). What holds it back is the atomics'
// rate in L2: one a live (point, level), a quarter of the exact K1's,
// most of them into rows at random on the fine hashed levels, where no
// two samples share a cell; and the wrapper's zeroing (PERF.md). The
// design is the exact K1's:
// - A block per 32 consecutive points, its warps taking the levels in
//   turn, so a warp's lanes hold 32 neighbouring points at one level
//   (one level's constants, one branch of the dense/hashed index). x and
//   g are staged in shared memory by coalesced evict-first loads (__ldcs:
//   read once).
// - Along rays, neighbouring samples share a cell on every level coarser
//   than the sample spacing, and after the pick often a row. One shuffle
//   and one vote find whether some lane picked its neighbour's row; if
//   so, __match_any_sync groups the lanes of equal rows and one lane adds
//   the group's sum. Lanes whose cotangent values are all zero (the
//   sample budget's padding) add nothing.
// - Plain atomics: K8's L2 evict-last policy on them measured slower
//   here, on uniform and on ray-ordered points alike (PERF.md). Passes
//   over groups of levels, so that a pass's atomics meet fewer rows in
//   L2, measured faster on uniform points and slower on ray-ordered
//   ones, whose coarse levels then take every block's atomics at once.

#include "grid_levels.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__device__ __forceinline__ void accumulate_row(const float* __restrict__ table,
                                               long long row, float w,
                                               float (&acc)[F]) {
  if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(table) + row);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v.x));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(w, v.y));
  } else if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(table + row * F) + q);
      acc[4 * q + 0] = __fadd_rn(acc[4 * q + 0], __fmul_rn(w, v.x));
      acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(w, v.y));
      acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(w, v.z));
      acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(w, v.w));
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w, __ldg(table + row * F + f)));
    }
  }
}

// The C corners of a point's cell at one level, in the corner order of
// ops/hashgrid.py:_CORNERS (cube) or the Kuhn simplex order (tet): each
// corner's interpolation weight and its offset (0 or 1 an axis) from
// the cell's base. The forward, the exact backward and the stochastic
// pick all take their weights and corners from here, so the backward
// scatters into exactly the (row, w) the forward gathered.
template <bool kTet>
struct CellCorners {
  static constexpr int kCount = kTet ? 4 : 8;
  int base[3];
  float w[kCount];
  int off[kCount][3];
};

template <bool kTet>
__device__ __forceinline__ CellCorners<kTet> cell_corners(
    const float (&xa)[3], float scale) {
  CellCorners<kTet> c;
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(xa[a], scale), 0.5f);
    const float fl = floorf(pos);
    frac[a] = __fsub_rn(pos, fl);
    c.base[a] = static_cast<int>(fl);
  }
  if constexpr (!kTet) {
    // corner k sits at offset (k>>2 & 1, k>>1 & 1, k & 1); weight
    // ((w_x) * w_y) * w_z
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o0 = (k >> 2) & 1, o1 = (k >> 1) & 1, o2 = k & 1;
      const float w0 = o0 ? frac[0] : __fsub_rn(1.0f, frac[0]);
      const float w1 = o1 ? frac[1] : __fsub_rn(1.0f, frac[1]);
      const float w2 = o2 ? frac[2] : __fsub_rn(1.0f, frac[2]);
      c.w[k] = __fmul_rn(__fmul_rn(w0, w1), w2);
      c.off[k][0] = o0;
      c.off[k][1] = o1;
      c.off[k][2] = o2;
    }
  } else {
    // Kuhn simplex: rank the fracs descending with the JAX tie-break
    // (rank_i = #strictly greater + #equal with lower axis index).
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    const int r[3] = {
        (fy > fx) + (fz > fx),
        (fx >= fy) + (fz > fy),
        (fx >= fz) + (fy >= fz),
    };
    float f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (r[a] == 0) f1 = frac[a];
      if (r[a] == 1) f2 = frac[a];
      if (r[a] == 2) f3 = frac[a];
      c.off[0][a] = 0;
      c.off[1][a] = r[a] == 0;
      c.off[2][a] = r[a] <= 1;
      c.off[3][a] = 1;
    }
    c.w[0] = __fsub_rn(1.0f, f1);
    c.w[1] = __fsub_rn(f1, f2);
    c.w[2] = __fsub_rn(f2, f3);
    c.w[3] = f3;
  }
  return c;
}

// The row within its level of the corner at offset o of the cell.
template <bool kTet>
__device__ __forceinline__ long long cell_corner_row(
    const CellCorners<kTet>& c, const int (&o)[3], int res, int hashed,
    unsigned int mask) {
  return corner_index(c.base[0] + o[0], c.base[1] + o[1], c.base[2] + o[2],
                      res, hashed, mask);
}

// The corner rows and interpolation weights of point p at level l.
template <bool kTet>
struct Corners {
  static constexpr int kCount = kTet ? 4 : 8;
  long long row[kCount];
  float w[kCount];
};

template <bool kTet>
__device__ __forceinline__ Corners<kTet> level_corners(
    const float* __restrict__ x, long long p, float scale, int res,
    int hashed, unsigned int mask) {
  float xa[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    xa[a] = fminf(fmaxf(__ldg(x + 3 * p + a), 0.0f), 1.0f);
  }
  const CellCorners<kTet> cc = cell_corners<kTet>(xa, scale);
  Corners<kTet> c;
#pragma unroll
  for (int k = 0; k < Corners<kTet>::kCount; ++k) {
    c.w[k] = cc.w[k];
    c.row[k] = cell_corner_row<kTet>(cc, cc.off[k], res, hashed, mask);
  }
  return c;
}

// Floats between two points' rows of the shared output tile: L*F, plus
// V = min(F, 4) when (L*F)/V is even, so that the V-float writes of the
// lanes of one level land on distinct banks.
__host__ __device__ inline int tile_stride(int n_levels, int F) {
  const int v = F < 4 ? F : 4;
  const int row = n_levels * F;
  return (row / v) % 2 == 0 ? row + v : row;
}

template <int V>
__device__ __forceinline__ void copy_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  } else {
    *dst = *src;
  }
}

// Tet: one block per tile of `tile` points (a multiple of 32). Task t
// of the tile is (group t / L of 32 points, level t % L); warp w takes
// tasks w, w + kWarps, ..., kPairs of them at a time.
template <int F, int kPairs>
__global__ void __launch_bounds__(kThreads)
encode_tet_kernel(const float* __restrict__ x,
                  const float* __restrict__ table, float* __restrict__ out,
                  long long n, int n_levels, int tile, Levels lv) {
  constexpr int kWarps = kThreads / 32;
  constexpr int V = F < 4 ? F : 4;
  extern __shared__ float4 tile_smem[];
  float* tile_out = reinterpret_cast<float*>(tile_smem);
  const int stride = tile_stride(n_levels, F);
  const int lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_tile = static_cast<int>(min(static_cast<long long>(tile),
                                          n - p0));
  const int tasks = tile / 32 * n_levels;

  for (int t0 = threadIdx.x >> 5; t0 < tasks; t0 += kWarps * kPairs) {
    Corners<true> c[kPairs];
    int level[kPairs], at[kPairs];
    bool ok[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int t = t0 + i * kWarps;
      const int l = t % n_levels;
      const int pl = t / n_levels * 32 + lane;
      ok[i] = t < tasks && pl < n_tile;
      level[i] = l;
      at[i] = pl * stride + l * F;
      if (ok[i]) {
        c[i] = level_corners<true>(x, p0 + pl, lv.scale[l], lv.res[l],
                                   lv.hashed[l], lv.mask[l]);
      }
    }
    float acc[kPairs][F];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[i][f] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!ok[i]) continue;
      const float* tab = table + lv.offset[level[i]] * F;
#pragma unroll
      for (int k = 0; k < Corners<true>::kCount; ++k) {
        accumulate_row<F>(tab, c[i].row[k], c[i].w[k], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!ok[i]) continue;
      float* o = tile_out + at[i];
      if constexpr (V == 4) {
#pragma unroll
        for (int f = 0; f < F; f += 4) {
          *reinterpret_cast<float4*>(o + f) = make_float4(
              acc[i][f], acc[i][f + 1], acc[i][f + 2], acc[i][f + 3]);
        }
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1]);
      } else {
        *o = acc[i][0];
      }
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in out: vector i of the tile is
  // out[p0 * L * F + i * V .. + V)
  const int vecs = n_levels * F / V;
  float* dst = out + p0 * n_levels * F;
  for (int i = threadIdx.x; i < n_tile * vecs; i += kThreads) {
    const int p = i / vecs;
    copy_vec<V>(dst + static_cast<long long>(i) * V,
                tile_out + p * stride + (i - p * vecs) * V);
  }
}

// Cube: one thread per (point, level), point-major; out[p, l*F:(l+1)*F]
// stored straight from the thread.
template <int F>
__global__ void __launch_bounds__(kThreads)
encode_cube_kernel(const float* __restrict__ x,
                   const float* __restrict__ table, float* __restrict__ out,
                   long long n, int n_levels, Levels lv) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * n_levels) return;
  const long long p = i / n_levels;
  const int l = static_cast<int>(i - p * n_levels);
  const Corners<false> c = level_corners<false>(
      x, p, lv.scale[l], lv.res[l], lv.hashed[l], lv.mask[l]);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < Corners<false>::kCount; ++k) {
    accumulate_row<F>(table + lv.offset[l] * F, c.row[k], c.w[k], acc);
  }
  float* o = out + p * n_levels * F + l * F;
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

// Adds the F values v at row `row` of dtab: one scalar atomic at F = 1,
// one float2 at F = 2, one float4 per 4 floats at F >= 4 (native on
// sm_90). No zero test here: the lanes of zero cotangents are skipped
// before.
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ dtab,
                                        long long row, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(dtab + row, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dtab) + row, make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      atomicAdd(reinterpret_cast<float4*>(dtab + row * F) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]));
    }
  }
}

// Table gradient of the encode (K1, fused): d_table[row] += w * g[p, l]
// for every corner of every (point, level), recomputed with
// level_corners. A block takes a group of 32 consecutive points; it
// copies their cotangent rows [32, L*F] (contiguous in g) into
// bank-padded shared rows with coalesced vector loads, and its warps
// take the levels in turn, so the 32 lanes of a warp hold the group at
// one level. Where some lane shares its neighbour's cell (corner 0),
// __match_any_sync on each corner's row (within the level) groups the
// lanes of equal rows: a lane alone adds its F products straight from
// registers; a group publishes its products to shared memory, and its
// first lane (its first two at F = 8, one float4 chunk each) sums them
// over the group in lane order and adds the sum with one atomic.
// Elsewhere every lane adds its corners with one atomic each, back to
// back. Lanes whose F cotangent values are all zero add nothing. The
// order of the sums varies from run to run, so results match the plain
// version to f32 rounding only.
template <int F, bool kTet>
__global__ void __launch_bounds__(kThreads)
encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ d_table, long long n, int n_levels,
                  Levels lv) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunks = F < 4 ? 1 : F / 4;  // atomics a row
  constexpr int V = F < 4 ? F : 4;
  __shared__ float products[kWarps][F][32];
  extern __shared__ float4 g_smem[];
  float* g_tile = reinterpret_cast<float*>(g_smem);
  const int stride = tile_stride(n_levels, F);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 = static_cast<long long>(blockIdx.x) * 32;
  const int n_tile = static_cast<int>(min(32LL, n - p0));

  const int vecs = n_levels * F / V;
  const float* src = g + p0 * n_levels * F;
  for (int i = threadIdx.x; i < n_tile * vecs; i += blockDim.x) {
    const int pt = i / vecs;
    copy_vec<V>(g_tile + pt * stride + (i - pt * vecs) * V,
                src + static_cast<long long>(i) * V);
  }
  __syncthreads();

  const long long p = p0 + lane;
  float (&mine)[F][32] = products[warp];
  for (int l = warp; l < n_levels; l += blockDim.x >> 5) {
    float gv[F] = {};
    bool live = false;
    Corners<kTet> c;
    if (lane < n_tile) {
      c = level_corners<kTet>(x, p, lv.scale[l], lv.res[l], lv.hashed[l],
                              lv.mask[l]);
      const float* gs = g_tile + lane * stride + l * F;
      if constexpr (F == 1) {
        gv[0] = gs[0];
      } else if constexpr (F == 2) {
        const float2 v = *reinterpret_cast<const float2*>(gs);
        gv[0] = v.x;
        gv[1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(gs)[q];
          gv[4 * q] = v.x;
          gv[4 * q + 1] = v.y;
          gv[4 * q + 2] = v.z;
          gv[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) live |= gv[f] != 0.0f;
    }
    const unsigned int live_lanes = __ballot_sync(0xffffffffu, live);
    if (live_lanes == 0) continue;  // the whole warp
    float* dtab = d_table + lv.offset[l] * F;

    // rows within a level are < 2^32; dead lanes group among themselves
    // and are masked out
    auto row_of = [&](int k) {
      return live ? static_cast<unsigned int>(c.row[k]) : 0xffffffffu;
    };
    // merge only where some lane shares its neighbour's cell: samples
    // along a ray sit in neighbouring lanes, uniform points almost never
    // do, and there the per-corner matches cost more than they save
    // (rows repeated otherwise are added unmerged, which is as right).
    // Every lane runs the shuffle: it must not sit behind a && that
    // short-circuits.
    const unsigned int row0 = row_of(0);
    const unsigned int prev0 = __shfl_up_sync(0xffffffffu, row0, 1);
    if (__ballot_sync(0xffffffffu, live && lane > 0 && prev0 == row0) == 0) {
      if (live) {
#pragma unroll
        for (int k = 0; k < Corners<kTet>::kCount; ++k) {
          float v[F];
#pragma unroll
          for (int f = 0; f < F; ++f) v[f] = __fmul_rn(c.w[k], gv[f]);
          add_row<F>(dtab, c.row[k], v);
        }
      }
      continue;  // the whole warp
    }

#pragma unroll
    for (int k = 0; k < Corners<kTet>::kCount; ++k) {
      const unsigned int group =
          __match_any_sync(0xffffffffu, row_of(k)) & live_lanes;
      float v[F] = {};
      if (live) {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __fmul_rn(c.w[k], gv[f]);
      }
      const bool alone = group == (1u << lane);
      if (live && alone) add_row<F>(dtab, c.row[k], v);
      if (__ballot_sync(0xffffffffu, live && !alone) == 0) continue;
      if (live && !alone) {
#pragma unroll
        for (int f = 0; f < F; ++f) mine[f][lane] = v[f];
      }
      __syncwarp();
      const int rank = __popc(group & ((1u << lane) - 1u));
      if (live && !alone && rank < kChunks) {
        // chunk `rank` of the row: floats 4 rank .. (all F below F = 4)
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        for (unsigned int rest = group; rest; rest &= rest - 1u) {
          const int j = __ffs(rest) - 1;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[i] = __fadd_rn(acc[i], mine[rank * V + i][j]);
          }
        }
        if constexpr (F <= 4) {
          add_row<F>(dtab, c.row[k], acc);
        } else {
          atomicAdd(reinterpret_cast<float4*>(dtab + c.row[k] * F) + rank,
                    make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
      }
      __syncwarp();
    }
  }
}

// JAX's _hash_u01 (ops/hashgrid.py:685-701) of a point's clipped
// coordinates xa at level l: their bits times odd multipliers, xor'ed,
// the level's multiple xor'ed in, two xorshift-multiply rounds, the top
// 24 bits as a float in [0, 1). "+ 0" turns a clipped -0.0 into +0.0, as
// XLA's clip does.
__device__ __forceinline__ float hash_u01(const float (&xa)[3], int l) {
  unsigned int b[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) b[a] = __float_as_uint(__fadd_rn(xa[a], 0.0f));
  unsigned int h = (b[0] * 0x9E3779B1u) ^ (b[1] * 0x85EBCA77u) ^
                   (b[2] * 0xC2B2AE3Du);
  h ^= static_cast<unsigned int>(l) * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-08f);
}

// The row within level l that the stochastic gradient picks for a point
// with clipped coordinates xa: corner c = #{k < C-1 : u >= w_0 + ... +
// w_k} of the point's cell, u = hash_u01(xa, l), the weights summed in
// corner order with round-to-nearest adds. Only the picked corner's row
// is computed.
template <bool kTet>
__device__ __forceinline__ long long level_pick(const float (&xa)[3], int l,
                                                const Levels& lv) {
  constexpr int C = CellCorners<kTet>::kCount;
  const CellCorners<kTet> cc = cell_corners<kTet>(xa, lv.scale[l]);
  const float u = hash_u01(xa, l);
  float cdf = 0.0f;
  int sel = 0;
#pragma unroll
  for (int k = 0; k < C - 1; ++k) {
    cdf = __fadd_rn(cdf, cc.w[k]);
    sel += u >= cdf;
  }
  int o[3] = {cc.off[0][0], cc.off[0][1], cc.off[0][2]};
#pragma unroll
  for (int k = 1; k < C; ++k) {
    if (sel == k) {
      o[0] = cc.off[k][0];
      o[1] = cc.off[k][1];
      o[2] = cc.off[k][2];
    }
  }
  return cell_corner_row<kTet>(cc, o, lv.res[l], lv.hashed[l], lv.mask[l]);
}

// dst[0:V] = src[0:V], loaded evict-first (read once)
template <int V>
__device__ __forceinline__ void copy_streaming(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) =
        __ldcs(reinterpret_cast<const float4*>(src));
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) =
        __ldcs(reinterpret_cast<const float2*>(src));
  } else {
    *dst = __ldcs(src);
  }
}

// Stochastic table gradient: each (point, level) adds its unweighted
// cotangent g[p, l] to the one row level_pick picks (skipped when its F
// values are all zero). A block takes a group of 32 consecutive points:
// it copies their coordinates and cotangent rows [32, L*F] (contiguous
// in x and g) into shared memory with coalesced evict-first loads, and
// its warps take the levels in turn, so the 32 lanes of a warp hold the
// group at one level. Where some lane picked its neighbour's row,
// __match_any_sync groups the lanes of equal picked rows: a lane alone
// adds its own row; a group's first lane (its first two at F = 8, one
// float4 chunk each) sums the group's g in lane order from shared memory
// and adds the sum with one atomic. Elsewhere every lane adds its row,
// back to back. Zero-cotangent lanes take a sentinel row (rows within a
// level are < 2^32 - 1), so they never group with live ones. With
// `picks` non-null the picked row (global table row) of (p, l) is also
// stored at picks[p * L + l].
template <int F, bool kTet>
__global__ void __launch_bounds__(kThreads)
encode_bwd_stochastic_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             float* __restrict__ d_table,
                             long long* __restrict__ picks, long long n,
                             int n_levels, Levels lv) {
  constexpr int kChunks = F < 4 ? 1 : F / 4;  // atomics a row
  constexpr int V = F < 4 ? F : 4;
  constexpr unsigned int kAll = 0xffffffffu;
  __shared__ float x_tile[32 * 3];
  extern __shared__ float4 g_smem[];
  float* g_tile = reinterpret_cast<float*>(g_smem);
  const int stride = tile_stride(n_levels, F);
  const int lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * 32;
  const int n_tile = static_cast<int>(min(32LL, n - p0));

  for (int i = threadIdx.x; i < n_tile * 3; i += blockDim.x) {
    x_tile[i] = __ldcs(x + p0 * 3 + i);
  }
  const int vecs = n_levels * F / V;
  const float* src = g + p0 * n_levels * F;
  for (int i = threadIdx.x; i < n_tile * vecs; i += blockDim.x) {
    const int pt = i / vecs;
    copy_streaming<V>(g_tile + pt * stride + (i - pt * vecs) * V,
                      src + static_cast<long long>(i) * V);
  }
  __syncthreads();

  float xa[3] = {0.0f, 0.0f, 0.0f};
  if (lane < n_tile) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xa[a] = fminf(fmaxf(x_tile[3 * lane + a], 0.0f), 1.0f);
    }
  }
  for (int l = threadIdx.x >> 5; l < n_levels; l += blockDim.x >> 5) {
    const float* gs = g_tile + lane * stride + l * F;
    float gv[F] = {};
    bool live = false;
    long long row = 0;
    if (lane < n_tile) {
      row = level_pick<kTet>(xa, l, lv);
      if (picks != nullptr) {
        picks[(p0 + lane) * n_levels + l] = lv.offset[l] + row;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gv[f] = gs[f];
        live |= gv[f] != 0.0f;
      }
    }
    const unsigned int live_lanes = __ballot_sync(kAll, live);
    if (live_lanes == 0) continue;  // the whole warp
    float* dtab = d_table + lv.offset[l] * F;
    const unsigned int key = live ? static_cast<unsigned int>(row) : kAll;
    // Every lane runs the shuffle and the votes: they must not sit behind
    // a && that short-circuits.
    const unsigned int prev = __shfl_up_sync(kAll, key, 1);
    const bool merge =
        __ballot_sync(kAll, live && lane > 0 && prev == key) != 0;
    const unsigned int group =
        merge ? __match_any_sync(kAll, key) & live_lanes : 1u << lane;
    if (!live) continue;
    if (group == (1u << lane)) {  // alone: the row from registers
      add_row<F>(dtab, row, gv);
      continue;
    }
    const int rank = __popc(group & ((1u << lane) - 1u));
    if (rank >= kChunks) continue;
    // chunk `rank` of the row: floats V rank .. V rank + V, summed over
    // the group in lane order
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (unsigned int rest = group; rest; rest &= rest - 1u) {
      const float* gj = g_tile + (__ffs(rest) - 1) * stride + l * F + rank * V;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], gj[i]);
    }
    if constexpr (F <= 4) {
      add_row<F>(dtab, row, acc);
    } else {
      atomicAdd(reinterpret_cast<float4*>(dtab + row * F) + rank,
                make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
}

// Shared-memory budget of one tile's output, in floats (8.5 KB: 64
// points at L16 F2).
constexpr int kTileFloats = 2176;

template <int F>
cudaError_t launch(bool tet, const float* x, const float* table, float* out,
                   long long n, int n_levels, const Levels& lv,
                   cudaStream_t stream) {
  if (!tet) {
    encode_cube_kernel<F><<<qf_blocks(n * n_levels, kThreads), kThreads, 0,
                            stream>>>(x, table, out, n, n_levels, lv);
    return cudaGetLastError();
  }
  // 8 row loads in flight per thread (4 at F = 8, whose 8 accumulators a
  // pair take the registers)
  constexpr int kPairs = F <= 4 ? 2 : 1;
  const int stride = tile_stride(n_levels, F);
  const int tile = max(32, min(256, kTileFloats / stride / 32 * 32));
  const size_t smem = static_cast<size_t>(tile) * stride * sizeof(float);
  encode_tet_kernel<F, kPairs>
      <<<qf_blocks(n, tile), kThreads, smem, stream>>>(x, table, out, n,
                                                       n_levels, tile, lv);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(bool tet, const float* x, const float* g,
                       float* d_table, long long n, int n_levels,
                       const Levels& lv, cudaStream_t stream) {
  // a block per 32 points, a warp per level up to 8; the group's padded
  // cotangent rows (33 KB at L = 32, F = 8) in dynamic shared memory
  const unsigned int blocks = qf_blocks(n, 32);
  const int threads = 32 * min(kThreads / 32, n_levels);
  const size_t smem =
      static_cast<size_t>(32) * tile_stride(n_levels, F) * sizeof(float);
  if (tet) {
    encode_bwd_kernel<F, true><<<blocks, threads, smem, stream>>>(
        x, g, d_table, n, n_levels, lv);
  } else {
    encode_bwd_kernel<F, false><<<blocks, threads, smem, stream>>>(
        x, g, d_table, n, n_levels, lv);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd_stochastic(bool tet, const float* x, const float* g,
                                  float* d_table, long long* picks,
                                  long long n, int n_levels,
                                  const Levels& lv, cudaStream_t stream) {
  // as launch_bwd: a block per 32 points, a warp per level up to 8, the
  // group's padded cotangent rows in dynamic shared memory
  const unsigned int blocks = qf_blocks(n, 32);
  const int threads = 32 * min(kThreads / 32, n_levels);
  const size_t smem =
      static_cast<size_t>(32) * tile_stride(n_levels, F) * sizeof(float);
  if (tet) {
    encode_bwd_stochastic_kernel<F, true><<<blocks, threads, smem, stream>>>(
        x, g, d_table, picks, n, n_levels, lv);
  } else {
    encode_bwd_stochastic_kernel<F, false>
        <<<blocks, threads, smem, stream>>>(x, g, d_table, picks, n,
                                            n_levels, lv);
  }
  return cudaGetLastError();
}

}  // namespace

// x [n, 3] f32, table [E, F] f32, out [n, L*F] f32, all device memory;
// the per-level arrays (length L) are host memory.
QF_EXPORT int qf_hashgrid_encode(const float* x, const float* table,
                                 float* out, long long n, int n_levels,
                                 int n_features, int tet,
                                 const float* scales, const int* res,
                                 const long long* sizes,
                                 const long long* offsets, void* stream) {
  Levels lv;
  if (n <= 0 || !make_levels(n_levels, scales, res, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_features) {
    case 1: err = launch<1>(tet, x, table, out, n, n_levels, lv, s); break;
    case 2: err = launch<2>(tet, x, table, out, n, n_levels, lv, s); break;
    case 4: err = launch<4>(tet, x, table, out, n, n_levels, lv, s); break;
    case 8: err = launch<8>(tet, x, table, out, n, n_levels, lv, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x [n, 3] f32, g [n, L*F] f32 (the output's cotangent; 4 * min(F, 4)
// -byte aligned), d_table [E, F] f32 zeroed by the caller and added
// into, all device memory; the per-level arrays (length L) are host
// memory, each level smaller than 2^32 rows (the lanes match rows
// within a level in 32 bits).
QF_EXPORT int qf_hashgrid_encode_bwd(const float* x, const float* g,
                                     float* d_table, long long n,
                                     int n_levels, int n_features, int tet,
                                     const float* scales, const int* res,
                                     const long long* sizes,
                                     const long long* offsets,
                                     void* stream) {
  Levels lv;
  if (n <= 0 || !make_levels(n_levels, scales, res, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < n_levels; ++l) {
    if (sizes[l] > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_features) {
    case 1: err = launch_bwd<1>(tet, x, g, d_table, n, n_levels, lv, s); break;
    case 2: err = launch_bwd<2>(tet, x, g, d_table, n, n_levels, lv, s); break;
    case 4: err = launch_bwd<4>(tet, x, g, d_table, n, n_levels, lv, s); break;
    case 8: err = launch_bwd<8>(tet, x, g, d_table, n, n_levels, lv, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The stochastic table gradient (grad_mode "stochastic"): x [n, 3] f32,
// g [n, L*F] f32 (4 * min(F, 4)-byte aligned), d_table [E, F] f32 zeroed
// by the caller and added into, picks [n, L] int64 or null, all device
// memory; the per-level arrays (length L) are host memory, each level
// smaller than 2^32 rows (the lanes match picked rows in 32 bits).
QF_EXPORT int qf_hashgrid_encode_bwd_stochastic(
    const float* x, const float* g, float* d_table, long long* picks,
    long long n, int n_levels, int n_features, int tet, const float* scales,
    const int* res, const long long* sizes, const long long* offsets,
    void* stream) {
  Levels lv;
  if (n <= 0 || !make_levels(n_levels, scales, res, sizes, offsets, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < n_levels; ++l) {
    if (sizes[l] > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_features) {
    case 1:
      err = launch_bwd_stochastic<1>(tet, x, g, d_table, picks, n, n_levels,
                                     lv, s);
      break;
    case 2:
      err = launch_bwd_stochastic<2>(tet, x, g, d_table, picks, n, n_levels,
                                     lv, s);
      break;
    case 4:
      err = launch_bwd_stochastic<4>(tet, x, g, d_table, picks, n, n_levels,
                                     lv, s);
      break;
    case 8:
      err = launch_bwd_stochastic<8>(tet, x, g, d_table, picks, n, n_levels,
                                     lv, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
