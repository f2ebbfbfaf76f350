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

// Delta-stepping's bucket of a distance, graphtpu/algorithms/sssp.py:242-247:
// floor(d * inv_delta) in the run's type (inv_delta = 1 / delta rounded to it
// on the host), INT32_INF where that reaches 2^31 - 1 rounded to the type
// (2147483648.0f in float32) or is infinite. The product is rounded once
// (__fmul_rn / __dmul_rn), so no contraction or fast-math flag moves a
// bucket. K14's bucket mode and K24 both call it.
__device__ __forceinline__ int gt_delta_bucket(float d, float inv) {
  const float b = floorf(__fmul_rn(d, inv));
  return b >= 2147483648.0f ? GT_INT32_INF : (int)b;
}

__device__ __forceinline__ int gt_delta_bucket(double d, double inv) {
  const double b = floor(__dmul_rn(d, inv));
  return b >= 2147483647.0 ? GT_INT32_INF : (int)b;
}

static inline unsigned int gt_blocks(long long work, int per_block) {
  return (unsigned int)((work + per_block - 1) / per_block);
}

// One bucket of a slab plan, as the host hands it to a table launch: a
// transposed [W, R] int32 slab (-1 = pad), or its row-major copy [R, W] where
// the kernel asks for that, whose R results go to out[out_off .. out_off + R). One launch serves up to GT_MAX_BUCKETS
// buckets: each block finds its bucket by its index.
#define GT_MAX_BUCKETS 16

struct GtBucket {
  const int* slab;
  long long R;
  long long out_off;
  int W;
  int row_major;  // 0: slab is [W, R]; 1: slab is the row-major copy [R, W]
};

// The buckets of one launch with the tiling the host chose: bucket k owns
// blocks [first_block[k], first_block[k + 1]), each a tile of tile[k]
// neighbouring rows (gt_table_blocks; a power of two that divides the block
// size).
struct GtTable {
  GtBucket b[GT_MAX_BUCKETS];
  unsigned int first_block[GT_MAX_BUCKETS + 1];
  int tile[GT_MAX_BUCKETS];
  int aux[GT_MAX_BUCKETS];  // per-bucket extra of the kernel (K2: hash entries per row)
  int nb;
};

// The bucket of this block (block-uniform).
__device__ __forceinline__ int gt_find_bucket(const GtTable& t) {
  int k = 0;
  while (k + 1 < t.nb && blockIdx.x >= t.first_block[k + 1]) ++k;
  return k;
}

// Fills first_block from tile; false if the buckets are not a valid table.
static inline bool gt_table_blocks(GtTable& t, const GtBucket* buckets, int nb) {
  if (nb < 1 || nb > GT_MAX_BUCKETS) return false;
  unsigned long long blocks = 0;
  for (int k = 0; k < nb; ++k) {
    t.b[k] = buckets[k];
    if (buckets[k].R < 0 || buckets[k].W < 1) return false;
    t.first_block[k] = (unsigned int)blocks;
    blocks += (unsigned long long)((buckets[k].R + t.tile[k] - 1) / t.tile[k]);
    if (blocks > 0x7fffffffull) return false;
  }
  t.first_block[nb] = (unsigned int)blocks;
  t.nb = nb;
  return true;
}
