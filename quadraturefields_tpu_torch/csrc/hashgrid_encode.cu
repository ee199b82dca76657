// Forward multiresolution hash-grid encode, corner layout.
//
// Replaces the TPU kernel ops/hashgrid_pallas.py:_encode_kernel (called
// from hashgrid_encode_pallas), whose math the JAX main path runs as an
// XLA gather (ops/hashgrid.py:_encode_fwd_impl). Widened from the TPU
// probe's cube-only, F=2, log2_T 13-20 form to cube and Kuhn-tet
// interpolation, any level count up to kMaxLevels, F in {1,2,4,8} and
// tables indexed with 64-bit level offsets.
//
// One thread per (point, level), point-major so that a warp's output
// rows are contiguous: clip x to [0,1], pos = x * scale_l + 0.5, floor
// and frac, then the 8 cube or 4 tet corners, each clipped to
// [0, res-1] and indexed densely (res^3 <= level size) or by the uint32
// xor-prime hash masked to the power-of-two level size, exactly as
// ops/hashgrid.py:_level_indices. The weighted corner rows are summed
// in corner order into out[n, l*F:(l+1)*F].
//
// What bounds it on an H100: the corner gathers. The stage-1 table
// (L16 F2 T2^19, 6,299,960 rows, 50.4 MB) cannot sit in shared memory
// and about fills the 50 MB L2, so each corner row is a dependent
// 8-byte load whose latency is that of L2 or device memory. The design
// keeps many (point, level) threads in flight to hide that latency and
// reads each row as one float2. Position arithmetic uses explicit
// round-to-nearest intrinsics so that nvcc does not contract x*s+0.5
// into an FMA: floor() must see the same pos as the plain version.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Levels {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int hashed[kMaxLevels];
  unsigned int mask[kMaxLevels];
  long long offset[kMaxLevels];
};

__device__ __forceinline__ long long corner_index(int cx, int cy, int cz,
                                                  int res, int hashed,
                                                  unsigned int mask) {
  const int hi = res - 1;
  cx = min(max(cx, 0), hi);
  cy = min(max(cy, 0), hi);
  cz = min(max(cz, 0), hi);
  if (!hashed) {
    return static_cast<long long>(cx) +
           static_cast<long long>(cy) * res +
           static_cast<long long>(cz) * res * res;
  }
  // tcnn primes (1, 2654435761, 805459861), uint32 wraparound
  unsigned int h = static_cast<unsigned int>(cx);
  h ^= static_cast<unsigned int>(cy) * 2654435761u;
  h ^= static_cast<unsigned int>(cz) * 805459861u;
  return static_cast<long long>(h & mask);
}

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

template <int F, bool kTet>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
              float* __restrict__ out, long long n, int n_levels,
              Levels lv) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * n_levels) return;
  const long long p = i / n_levels;
  const int l = static_cast<int>(i - p * n_levels);
  const float scale = lv.scale[l];
  const int res = lv.res[l];
  const int hashed = lv.hashed[l];
  const unsigned int mask = lv.mask[l];
  const float* tab = table + lv.offset[l] * F;

  float frac[3];
  int base[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xa = fminf(fmaxf(__ldg(x + 3 * p + a), 0.0f), 1.0f);
    const float pos = __fadd_rn(__fmul_rn(xa, scale), 0.5f);
    const float fl = floorf(pos);
    frac[a] = __fsub_rn(pos, fl);
    base[a] = static_cast<int>(fl);
  }

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  if constexpr (!kTet) {
    // corner c = (i, j, k) = (c>>2 & 1, c>>1 & 1, c & 1), the order of
    // ops/hashgrid.py:_CORNERS; weight ((w_x) * w_y) * w_z
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int o0 = (c >> 2) & 1, o1 = (c >> 1) & 1, o2 = c & 1;
      const float w0 = o0 ? frac[0] : __fsub_rn(1.0f, frac[0]);
      const float w1 = o1 ? frac[1] : __fsub_rn(1.0f, frac[1]);
      const float w2 = o2 ? frac[2] : __fsub_rn(1.0f, frac[2]);
      const float w = __fmul_rn(__fmul_rn(w0, w1), w2);
      const long long row = corner_index(base[0] + o0, base[1] + o1,
                                         base[2] + o2, res, hashed, mask);
      accumulate_row<F>(tab, row, w, acc);
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
    int e1[3], e12[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (r[a] == 0) f1 = frac[a];
      if (r[a] == 1) f2 = frac[a];
      if (r[a] == 2) f3 = frac[a];
      e1[a] = r[a] == 0;
      e12[a] = r[a] <= 1;
    }
    const float w[4] = {__fsub_rn(1.0f, f1), __fsub_rn(f1, f2),
                        __fsub_rn(f2, f3), f3};
    const long long rows[4] = {
        corner_index(base[0], base[1], base[2], res, hashed, mask),
        corner_index(base[0] + e1[0], base[1] + e1[1], base[2] + e1[2],
                     res, hashed, mask),
        corner_index(base[0] + e12[0], base[1] + e12[1], base[2] + e12[2],
                     res, hashed, mask),
        corner_index(base[0] + 1, base[1] + 1, base[2] + 1, res, hashed,
                     mask),
    };
#pragma unroll
    for (int c = 0; c < 4; ++c) accumulate_row<F>(tab, rows[c], w[c], acc);
  }

  float* o = out + p * n_levels * F + l * F;
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

template <int F>
cudaError_t launch(bool tet, const float* x, const float* table, float* out,
                   long long n, int n_levels, const Levels& lv,
                   cudaStream_t stream) {
  const unsigned int blocks = qf_blocks(n * n_levels, kThreads);
  if (tet) {
    encode_kernel<F, true><<<blocks, kThreads, 0, stream>>>(
        x, table, out, n, n_levels, lv);
  } else {
    encode_kernel<F, false><<<blocks, kThreads, 0, stream>>>(
        x, table, out, n, n_levels, lv);
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
  if (n_levels < 1 || n_levels > kMaxLevels || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    lv.scale[l] = scales[l];
    lv.res[l] = res[l];
    const long long r = res[l];
    lv.hashed[l] = r * r * r > sizes[l];
    lv.mask[l] = static_cast<unsigned int>(sizes[l] - 1);
    lv.offset[l] = offsets[l];
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
