// Shared by the port's kernels: each .cu builds into its own shared
// library with a plain C interface (loaded from Python with ctypes), so
// each library carries its own copy of these helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define QF_EXPORT extern "C" __attribute__((visibility("default")))

// cudaError_t -> message, for the Python wrapper's exception text.
QF_EXPORT const char* qf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned int qf_blocks(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
