// Per-level constants of a multiresolution grid and its table indexing,
// shared by the corner encode (hashgrid_encode.cu) and the cell table
// gradient (cell_factor_grad.cu).
#pragma once

#include "common.cuh"

constexpr int kMaxLevels = 32;

// One entry per level. `res` is the number of grid points per axis that
// the level indexes: the corner resolution for the corner layout, the
// number of cells per axis for the cell layout. A kernel parameter
// (under the 4 KB limit): 32 levels take 768 bytes.
struct Levels {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int hashed[kMaxLevels];
  unsigned int mask[kMaxLevels];
  long long offset[kMaxLevels];
};

// Row of integer point (cx, cy, cz) within its level, each coordinate
// clipped to [0, res-1]: dense strides when res^3 fits the level, else
// the xor-prime hash masked to the power-of-two level size, exactly as
// ops/hashgrid.py:_level_indices.
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

// Fill `lv` from host arrays of length n_levels; false if n_levels is
// out of range. A level hashes when res^3 exceeds its size.
static inline bool make_levels(int n_levels, const float* scales,
                               const int* res, const long long* sizes,
                               const long long* offsets, Levels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int l = 0; l < n_levels; ++l) {
    lv->scale[l] = scales[l];
    lv->res[l] = res[l];
    const long long r = res[l];
    lv->hashed[l] = r * r * r > sizes[l];
    lv->mask[l] = static_cast<unsigned int>(sizes[l] - 1);
    lv->offset[l] = offsets[l];
  }
  return true;
}
