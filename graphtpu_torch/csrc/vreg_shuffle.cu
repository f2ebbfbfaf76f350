// K4 vreg_shuffle: out[i, j] = tbl8[ind[i, j], j] for an [8, C] table of
// 4-byte elements (int32 or float32) and [8, C] int32 indices.
//
// Replaces graphtpu/ops/pallas_gather.py:69 vreg_shuffle, Mosaic's single-vreg
// dynamic gather on the TPU: one (8, 128) vector register, each lane choosing
// among the 8 sublanes of its own column.
//
// Bound on the card: launch latency; the whole call moves 12 KB at C = 128.
//
// Design: one thread per output element, neighbouring threads on neighbouring
// columns, so every read and write is coalesced; the table stays in L1. An
// index outside [0, 8) gives 0 (the TPU kernel promises in-bounds indices and
// leaves the result undefined).
#include "common.cuh"

__global__ void vreg_shuffle_kernel(const unsigned int* __restrict__ tbl8,
                                    const int* __restrict__ ind,
                                    unsigned int* __restrict__ out, int cols) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 8 * cols) return;
  int i = ind[e];
  out[e] = (i >= 0 && i < 8) ? tbl8[i * cols + e % cols] : 0u;
}

GT_EXPORT int gt_vreg_shuffle(const void* tbl8, const int* ind, void* out,
                              int cols, void* stream) {
  if (cols == 0) return (int)cudaGetLastError();
  const int threads = 256;
  vreg_shuffle_kernel<<<gt_blocks(8LL * cols, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const unsigned int*)tbl8, ind, (unsigned int*)out, cols);
  return (int)cudaGetLastError();
}
