// Shared definitions of the graphtpu_torch CUDA kernels.
//
// Every entry point is a plain C function that launches on the stream it is
// given and returns cudaGetLastError() as an int, so the Python wrapper
// (loaded with ctypes) can raise when a launch was refused.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GT_INT32_INF 0x7fffffff

#define GT_EXPORT extern "C" __attribute__((visibility("default")))

static inline unsigned int gt_blocks(long long work, int per_block) {
  return (unsigned int)((work + per_block - 1) / per_block);
}
