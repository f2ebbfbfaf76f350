// The min-mode's counting as device functions, shared by K2 (slab_minmode.cu)
// and K12 (segment_minmode.cu).
//
// A label is counted in an open-addressing table of (label, count) pairs, two
// int32 arrays of `size` entries, INT32_INF marking an empty key. The value
// the count's atomicAdd returns is the label's running count, so the largest
// packed key (running count << 32 | INT32_MAX - label) over all inserts is the
// answer: the last insert of the most frequent label carries its full count,
// and among equal counts the smaller label packs larger. That holds in any
// insertion order, so atomics leave the result deterministic, and no pass over
// the table is needed. INT32_MAX - label is taken modulo 2^32, which keeps the
// order for every int32 label but INT32_INF (the empty key, never inserted).
#pragma once

#include "common.cuh"

#define GT_EMPTY GT_INT32_INF

// Counts `add` more of `label` in a table of `size` entries, which must hold
// more entries than the distinct labels ever inserted; returns the packed key
// (running count << 32 | INT32_MAX - label): larger is better.
__device__ __forceinline__ unsigned long long hash_insert(int* keys, int* cnts,
                                                          int size, int label,
                                                          int add) {
  int idx = (int)__umulhi((unsigned int)label * 2654435761u, (unsigned int)size);
  for (;;) {
    const int prev = atomicCAS(keys + idx, GT_EMPTY, label);
    if (prev == GT_EMPTY || prev == label) break;
    if (++idx == size) idx = 0;  // size > distinct labels: an entry is free
  }
  const unsigned long long c =
      (unsigned long long)(atomicAdd(cnts + idx, add) + add);
  return (c << 32) | ((unsigned int)GT_INT32_INF - (unsigned int)label);
}

// The label a packed key names; INT32_INF for 0 (no entry).
__device__ __forceinline__ int gt_minmode_label(unsigned long long best) {
  return (int)((unsigned int)GT_INT32_INF - (unsigned int)(best & 0xffffffffull));
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}
