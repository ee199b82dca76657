// Per-key row sum of a key-sorted stream (forward only).
//
// Replaces the TPU kernel ops/hashgrid_sorted.py:_row_acc_kernel_packed
// as presorted_row_segment_sum drives it (_windowed_row_accumulate,
// packed=True): there a merge-path schedule of one-hot matmuls walks
// windows of output rows in order. Here the keys are already sorted, so
// no sort and no one-hot product is needed, and one launch does the
// work, in two kinds of warps. A segment gets G lanes (a power of two,
// 1-16, chosen on the host from the mean rows a segment, M / n_seg, and
// capped so the grid stays within about one resident wave), so a
// segment warp owns S = 32 / G consecutive segments:
//   1. the warp finds its rows [lower_bound(k0), lower_bound(k0 + S))
//      with two 16-ary searches side by side, a half-warp each: 16
//      probes a round cut the range 16-fold, so ~6 rounds of loads at
//      2^20 rows instead of the 20 of a binary search;
//   2. up to 128 rows, it reads their keys once, coalesced, and each
//      lane finds where its segment's run starts by a search over the
//      lanes with shuffles (a run ends where the next one starts);
//      beyond, each lane binary-searches the warp's rows;
//   3. the G lanes of a segment stride its run, four rows in flight a
//      lane, sum in registers, reduce with G-wide xor shuffles and write
//      the row (16-byte stores where RW % 4 == 0). An empty segment
//      costs its share of the warp's searches and one store.
// A run of more than 32 G rows (eight rounds of loads for its lanes) is
// left to the run warps, which precede the segment warps in the grid and
// split the rows instead: every 16 G-th row is a probe, each run warp
// takes 16 probes, finds the long runs that hold them (the same key 16 G
// rows on) and sums each with all 32 lanes. Where a few rays hold most
// rows (a budget-saturated march, as the stage-4 twin's, whose samples
// fill the first rays of the batch), the run warps spread them over the
// card, where the segment warps would leave them to a few warps.
// Keys are clamped to [0, n_seg]: negative keys count to segment 0 and
// keys >= n_seg (the caller's sentinel padding) are dropped. Each lane
// adds its rows in row order and the shuffle tree is fixed, so the order
// of the sum depends on the inputs (and G, a function of M and n_seg)
// alone: two launches give the same bits.
//
// What bounds it on an H100: reading the [M, RW] f32 values and the keys
// once and writing [n_seg, RW] once. The first design gave every
// segment a warp and two binary searches, so short and empty segments
// (the stage-4 composite: 0.6-2.5 rows a ray) cost ~40 dependent loads
// and a warp each; here a warp's searches serve S segments and about 32
// rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows in flight a lane
constexpr int kScanRows = 128;  // the most rows whose keys a warp scans
constexpr int kProbes = 16;      // probe rows a run warp looks at
constexpr int kScanRounds = 4;    // a run warp's rounds of 128 rows and keys
constexpr unsigned int kFull = 0xffffffffu;

// A key's segment: negative keys count to 0, keys >= n_seg (padding) to
// n_seg, which no warp writes.
__device__ __forceinline__ int segment_of(const int* __restrict__ keys,
                                          int r, int n_seg) {
  return min(max(__ldg(keys + r), 0), n_seg);
}

// Lanes 0-15 find lower_bound(keys, target) of lane 0's target and lanes
// 16-31 of lane 16's, over [lo, hi); every lane returns its half's
// answer. Each round a half probes lo + j * step (j = 0..15): the c
// probes below the target leave the answer in (lo + (c - 1) step,
// lo + c step].
__device__ __forceinline__ int half_warp_lower_bound(
    const int* __restrict__ keys, int lo, int hi, int target, int lane) {
  const int j = lane & 15;
  const unsigned int half = 0xffffu << (lane & 16);
  while (__any_sync(kFull, lo < hi)) {
    const int step = (hi - lo + 15) >> 4;
    const int p = lo + j * step;
    const bool below = lo < hi && p < hi && __ldg(keys + p) < target;
    const int c = __popc(__ballot_sync(kFull, below) & half);
    if (lo < hi) {
      const int next_hi = min(lo + c * step, hi);
      lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
      hi = next_hi;
    }
  }
  return lo;
}

// The lanes l whose v_l < t, for v non-decreasing over the 32 lanes:
// a binary search over the lanes by shuffles (each lane its own t).
__device__ __forceinline__ int lanes_below(int v, int t) {
  int n = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kFull, v, n + step - 1) < t) n += step;
  }
  // n <= 31 here, and v_n >= t unless n == 31
  return n + (__shfl_sync(kFull, v, n) < t ? 1 : 0);
}

template <int RW>
__device__ __forceinline__ void load_row(const float* __restrict__ vals,
                                         int r, float (&v)[RW]) {
  if constexpr (RW % 4 == 0) {
    const float4* row = reinterpret_cast<const float4*>(vals) +
                        static_cast<long long>(r) * (RW / 4);
#pragma unroll
    for (int q = 0; q < RW / 4; ++q) {
      const float4 x = __ldg(row + q);
      v[4 * q + 0] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
    const float* row = vals + static_cast<long long>(r) * RW;
#pragma unroll
    for (int c = 0; c < RW; ++c) v[c] = __ldg(row + c);
  }
}

// acc += the rows r, r + STRIDE, ... below end, in that order, four in
// flight.
template <int RW, int STRIDE>
__device__ __forceinline__ void sum_rows(const float* __restrict__ vals,
                                         int r, int end, float (&acc)[RW]) {
  for (; r + (kUnroll - 1) * STRIDE < end; r += kUnroll * STRIDE) {
    float v[kUnroll][RW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_row<RW>(vals, r + u * STRIDE, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < RW; ++c) acc[c] += v[u][c];
    }
  }
  for (; r < end; r += STRIDE) {
    float v[RW];
    load_row<RW>(vals, r, v);
#pragma unroll
    for (int c = 0; c < RW; ++c) acc[c] += v[c];
  }
}

// Sum acc over aligned groups of WIDTH lanes (xor tree): every lane of
// a group ends with the same bits.
template <int RW, int WIDTH>
__device__ __forceinline__ void reduce(float (&acc)[RW]) {
#pragma unroll
  for (int c = 0; c < RW; ++c) {
#pragma unroll
    for (int off = WIDTH / 2; off > 0; off >>= 1) {
      acc[c] += __shfl_xor_sync(kFull, acc[c], off, WIDTH);
    }
  }
}

// Writes each of its S segments' sums, but those of runs longer than
// 32 G rows (left to the run warps).
// Write a segment's sum, held by every lane of its WIDTH-lane group:
// lane `sub` of the group writes the 16-byte quarters (or the columns)
// q with q % WIDTH == sub.
template <int RW, int WIDTH>
__device__ __forceinline__ void store(float* __restrict__ o,
                                      const float (&acc)[RW], int sub) {
  if constexpr (RW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RW / 4; ++q) {
      if ((q & (WIDTH - 1)) == sub) {
        reinterpret_cast<float4*>(o)[q] = make_float4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < RW; ++c) {
      if ((c & (WIDTH - 1)) == sub) o[c] = acc[c];
    }
  }
}

template <int RW, int G>
__device__ __forceinline__ void segment_warp(const int* __restrict__ keys,
                                             const float* __restrict__ vals,
                                             float* __restrict__ out, int m,
                                             int n_seg, long long warp,
                                             int lane) {
  constexpr int S = 32 / G;  // segments a warp
  const long long k0 = warp * S;
  if (k0 >= n_seg) return;  // the whole warp
  const int g = lane / G;        // this lane's segment, k0 + g
  const int sub = lane & (G - 1);  // its lane in the segment

  // 1. the warp's rows [s_w, e_w); segment 0 starts at row 0, where the
  // negative keys lie
  const long long last = k0 + S < n_seg ? k0 + S : n_seg;
  const int b = half_warp_lower_bound(
      keys, 0, m, static_cast<int>(lane < 16 ? k0 : last), lane);
  const int s_w = k0 == 0 ? 0 : __shfl_sync(kFull, b, 0);
  const int e_w = __shfl_sync(kFull, b, 16);

  // 2. segment g's run [start, end): lower_bound(k0 + g) and
  // lower_bound(k0 + g + 1) among the warp's rows
  int start = s_w, end = e_w;
  if (e_w - s_w <= kScanRows) {
    // the keys of the warp's rows, one coalesced load a lane per 32
    // rows, all in flight; key - k0 (0 for segment 0's negative keys,
    // S past e_w) is non-decreasing over the lanes, so the rows of a
    // chunk below segment g are found by a search over the lanes
    int rel[kScanRows / 32];
#pragma unroll
    for (int i = 0; i < kScanRows / 32; ++i) {
      const int r = s_w + 32 * i + lane;
      rel[i] =
          r < e_w ? max(__ldg(keys + r) - static_cast<int>(k0), 0) : S;
    }
    int below = 0;  // rows below segment g
#pragma unroll
    for (int i = 0; i < kScanRows / 32; ++i) {
      if (s_w + 32 * i < e_w) below += lanes_below(rel[i], g);
    }
    start = s_w + below;
    // segment g ends where segment g + 1 starts
    const int next = __shfl_sync(kFull, start, min(g + 1, S - 1) * G);
    end = g + 1 < S ? next : e_w;
  } else {
    // more rows: two binary searches a lane over the warp's rows
    int lo0 = s_w, hi0 = e_w, lo1 = s_w, hi1 = e_w;
    const int t0 = static_cast<int>(k0) + g;
    while (lo0 < hi0 || lo1 < hi1) {
      if (lo0 < hi0) {
        const int mid = (lo0 + hi0) >> 1;
        if (__ldg(keys + mid) < t0) lo0 = mid + 1; else hi0 = mid;
      }
      if (lo1 < hi1) {
        const int mid = (lo1 + hi1) >> 1;
        if (__ldg(keys + mid) < t0 + 1) lo1 = mid + 1; else hi1 = mid;
      }
    }
    start = g == 0 ? s_w : lo0;
    end = lo1;
  }

  // 3. the run's sum by the segment's G lanes, but for a long run
  const bool long_run = end - start > 32 * G;
  float acc[RW];
#pragma unroll
  for (int c = 0; c < RW; ++c) acc[c] = 0.0f;
  if (!long_run) sum_rows<RW, G>(vals, start + sub, end, acc);
  reduce<RW, G>(acc);
  const long long seg = k0 + g;
  if (seg < n_seg && !long_run) store<RW, G>(out + seg * RW, acc, sub);
}

// The run warp `warp`: the runs longer than 32 G rows that hold one of
// its kProbes probe rows a = (kProbes warp + i) P, P = 16 G, as the
// first probe in the run. Such a run holds rows a and a + P and not
// a - P, and every run longer than 2 P has a first probe. The warp finds
// the run's start with a half-warp search, sums it with all 32 lanes
// (lane l adds rows start + l, start + l + 32, ... in order, then a
// 32-wide xor tree), and writes it if it is longer than 32 G rows.
template <int RW, int G>
__device__ __forceinline__ void run_warp(const int* __restrict__ keys,
                                         const float* __restrict__ vals,
                                         float* __restrict__ out, int m,
                                         int n_seg, long long warp,
                                         int lane) {
  constexpr int kLong = 32 * G;
  constexpr int P = kLong / 2;
  const long long a0 = warp * kProbes * P;
  if (a0 >= m) return;  // the whole warp
  int k = -1;
  if (lane < kProbes) {
    const long long a = a0 + static_cast<long long>(lane) * P;
    if (a + P < m) {
      const int ka = segment_of(keys, static_cast<int>(a), n_seg);
      const int on = segment_of(keys, static_cast<int>(a + P), n_seg);
      const int back =
          a >= P ? segment_of(keys, static_cast<int>(a - P), n_seg) : -1;
      if (ka < n_seg && ka == on && ka != back) k = ka;
    }
  }
  for (unsigned int firsts = __ballot_sync(kFull, k >= 0); firsts;
       firsts &= firsts - 1) {
    const int i = __ffs(firsts) - 1;
    const int seg = __shfl_sync(kFull, k, i);
    const int a = static_cast<int>(a0) + i * P;
    // the run's start among the P - 1 rows before a; segment 0 starts at
    // row 0, where the negative keys lie
    const int start =
        seg == 0 ? 0
                 : half_warp_lower_bound(keys, max(a - P + 1, 0), a, seg,
                                         lane);
    // its rows 128 a round (up to kScanRounds rounds) until the key
    // changes, then, for a longer run, the rest up to its end, searched
    float acc[RW];
#pragma unroll
    for (int c = 0; c < RW; ++c) acc[c] = 0.0f;
    int end = start;
    bool more = true;
    for (int round = 0; more && round < kScanRounds; ++round) {
      const int base = start + round * 32 * kUnroll;
      bool in[kUnroll];
      float v[kUnroll][RW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = min(base + 32 * u + lane, m - 1);
        in[u] = base + 32 * u + lane < m && segment_of(keys, r, n_seg) == seg;
        load_row<RW>(vals, r, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (in[u]) {
#pragma unroll
          for (int c = 0; c < RW; ++c) acc[c] += v[u][c];
        }
        end += __popc(__ballot_sync(kFull, in[u]));
      }
      more = __shfl_sync(kFull, in[kUnroll - 1], 31);
    }
    if (more) {
      const int rest = end;
      end = half_warp_lower_bound(keys, rest, m, seg + 1, lane);
      sum_rows<RW, 32>(vals, rest + lane, end, acc);
    }
    reduce<RW, 32>(acc);
    if (end - start > kLong) {  // else a segment warp's run
      store<RW, 32>(out + static_cast<long long>(seg) * RW, acc, lane);
    }
  }
}

// Four blocks an SM, up to 64 registers a thread: the budget that keeps
// a long run's four rows a lane in flight.
template <int RW, int G>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_kernel(const int* __restrict__ keys,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int m, int n_seg, int run_blocks) {
  // the run blocks first: they start with the first wave
  const int lane = threadIdx.x & 31;
  const bool runs = static_cast<int>(blockIdx.x) < run_blocks;
  const long long warp =
      (static_cast<long long>(blockIdx.x - (runs ? 0 : run_blocks)) *
           kThreads + threadIdx.x) >> 5;
  if (runs) {
    run_warp<RW, G>(keys, vals, out, m, n_seg, warp, lane);
  } else {
    segment_warp<RW, G>(keys, vals, out, m, n_seg, warp, lane);
  }
}

template <int RW>
cudaError_t launch(const int* keys, const float* vals, float* out, int m,
                   int n_seg, int group, cudaStream_t s) {
  auto kernel = segment_sum_kernel<RW, 16>;
  switch (group) {
    case 1: kernel = segment_sum_kernel<RW, 1>; break;
    case 2: kernel = segment_sum_kernel<RW, 2>; break;
    case 4: kernel = segment_sum_kernel<RW, 4>; break;
    case 8: kernel = segment_sum_kernel<RW, 8>; break;
  }
  // a run warp per kProbes * 16 * group rows, and a segment warp per
  // 32 / group segments
  const long long segment_warps = (n_seg + 32 / group - 1) / (32 / group);
  const unsigned int segment_blocks = qf_blocks(segment_warps * 32, kThreads);
  const long long run_rows = kProbes * 16LL * group;
  const unsigned int run_blocks =
      qf_blocks((m + run_rows - 1) / run_rows * 32, kThreads);
  kernel<<<run_blocks + segment_blocks, kThreads, 0, s>>>(
      keys, vals, out, m, n_seg, static_cast<int>(run_blocks));
  return cudaGetLastError();
}

}  // namespace

// keys [m] i32 non-decreasing, vals [m, rw] f32 (16-byte aligned when
// rw % 4 == 0), out [n_seg, rw] f32, all device memory; group: lanes a
// segment, a power of two in 1..16.
QF_EXPORT int qf_segment_sum(const int* keys, const float* vals, float* out,
                             long long m, int n_seg, int rw, int group,
                             void* stream) {
  // rows below 2^31 - 1024: row indices (and r + 3G) stay in int
  if (n_seg <= 0 || m < 0 || m > (1LL << 31) - 1024 || rw < 1 || rw > 8 ||
      group < 1 || group > 16 || (group & (group - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  cudaError_t err;
  switch (rw) {
    case 1: err = launch<1>(keys, vals, out, mi, n_seg, group, s); break;
    case 2: err = launch<2>(keys, vals, out, mi, n_seg, group, s); break;
    case 3: err = launch<3>(keys, vals, out, mi, n_seg, group, s); break;
    case 4: err = launch<4>(keys, vals, out, mi, n_seg, group, s); break;
    case 5: err = launch<5>(keys, vals, out, mi, n_seg, group, s); break;
    case 6: err = launch<6>(keys, vals, out, mi, n_seg, group, s); break;
    case 7: err = launch<7>(keys, vals, out, mi, n_seg, group, s); break;
    default: err = launch<8>(keys, vals, out, mi, n_seg, group, s);
  }
  return static_cast<int>(err);
}
