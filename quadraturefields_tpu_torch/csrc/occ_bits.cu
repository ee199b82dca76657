// Coarse occupancy bit lookup of the two-level march.
//
// Replaces the TPU kernel ops/occ_bits.py:_bit_lookup_kernel (called
// from _bit_lookup, reached from occupancy_lookup_bits at
// ops/grid.py:_two_level_march). The TPU kernel takes flat cell indices
// and shuffles the bitfield across lanes; here the cell computation of
// occupancy_lookup_bits is fused in: each thread takes one world
// position, maps it through the aabb to a cell (truncating like
// astype(int32), then clipping to [0, res-1]), reads word q>>5 and bit
// q&31 of the x-major bitfield, and ands it with the in-box test
// 0 <= unit < 1 on every axis. The result is bit-exact with the plain
// version.
//
// What bounds it on an H100: reading the 12-byte positions and writing
// one byte per query; the bitfield (<= 32 KB; 4 KB for the 32^3 coarse
// grid) is staged once per block in shared memory, so the lookups never
// leave the SM. A grid-stride loop over a few blocks per SM amortises
// the staging.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 12288;  // 48 KB of static-limit shared memory

__global__ void __launch_bounds__(kThreads)
occ_bits_kernel(const int* __restrict__ words, int n_words,
                const float* __restrict__ x, long long n,
                const float* __restrict__ aabb, int res,
                unsigned char* __restrict__ out) {
  extern __shared__ unsigned int s_words[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    s_words[i] = static_cast<unsigned int>(__ldg(words + i));
  }
  __syncthreads();

  float lo[3], ext[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(aabb + a);
    ext[a] = __fsub_rn(__ldg(aabb + 3 + a), lo[a]);
  }
  const float fres = static_cast<float>(res);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < n; q += stride) {
    bool inside = true;
    int cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = __fdiv_rn(__fsub_rn(__ldg(x + 3 * q + a), lo[a]),
                                ext[a]);
      inside = inside && (u >= 0.0f) && (u < 1.0f);
      // saturating truncation, then the clip of occupancy_lookup
      const int c = __float2int_rz(__fmul_rn(u, fres));
      cell[a] = min(max(c, 0), res - 1);
    }
    const long long flat =
        (static_cast<long long>(cell[0]) * res + cell[1]) * res + cell[2];
    const unsigned int bit = (s_words[flat >> 5] >> (flat & 31)) & 1u;
    out[q] = static_cast<unsigned char>(inside && bit);
  }
}

}  // namespace

// words [res^3/32] i32, x [n, 3] f32, aabb [6] f32, out [n] bool (u8),
// all device memory.
QF_EXPORT int qf_occ_bits_lookup(const int* words, int n_words,
                                 const float* x, long long n,
                                 const float* aabb, int res,
                                 unsigned char* out, void* stream) {
  if (n <= 0 || n_words <= 0 || n_words > kMaxWords ||
      static_cast<long long>(res) * res * res != 32LL * n_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int blocks = qf_blocks(n, kThreads);
  const unsigned int cap = static_cast<unsigned int>(sms) * 8u;
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(n_words) * sizeof(unsigned int);
  occ_bits_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      words, n_words, x, n, aabb, res, out);
  return static_cast<int>(cudaGetLastError());
}
