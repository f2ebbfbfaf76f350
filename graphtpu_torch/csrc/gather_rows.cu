// K1 gather_rows: out[i, :] = table[idx[i], :] for a [R, C] table of 4- or
// 8-byte elements and int32 indices.
//
// Replaces graphtpu/ops/pallas_gather.py:95 dma_row_gather, which drives one
// 512 B DMA per index from a TPU-HBM-resident [R, 128] table, and carries the
// port's table_gather (graphtpu/ops/gather.py:91, x[idx] composed in XLA).
//
// Bound on the card: data movement only. Per index it reads 4 B of index,
// reads row_bytes from a random row and writes row_bytes. For C = 1 the
// tables of the path (labels and ranks of 2^20 vertices, 4 MB) stay in the
// 50 MB L2, so the index and output streams and the L2 latency bound it; for
// 512 B rows the random row reads from HBM bound it.
//
// Design: C = 1 runs one thread per index, so index reads and output writes
// are coalesced. Wider rows run one warp per row, each lane copying 16 B
// units where the row size and the pointers allow it, so a 512 B row moves
// as one coalesced 512 B access per warp. An index outside [0, R) gives a
// zero row instead of a read out of bounds.
#include "common.cuh"

template <typename T>
__global__ void gather_scalar_kernel(const T* __restrict__ table,
                                     const int* __restrict__ idx,
                                     T* __restrict__ out, long long n,
                                     long long rows) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int r = idx[i];
  out[i] = (r >= 0 && r < rows) ? table[r] : T(0);
}

template <typename V>
__global__ void gather_row_kernel(const V* __restrict__ table,
                                  const int* __restrict__ idx,
                                  V* __restrict__ out, long long n,
                                  long long rows, int units) {
  long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= n) return;
  int r = idx[row];
  V* dst = out + row * units;
  if (r < 0 || r >= rows) {
    V zero = {};
    for (int c = lane; c < units; c += 32) dst[c] = zero;
    return;
  }
  const V* src = table + (long long)r * units;
  for (int c = lane; c < units; c += 32) dst[c] = src[c];
}

GT_EXPORT const char* gt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

GT_EXPORT int gt_gather_rows(const void* table, const int* idx, void* out,
                             long long n, long long rows, long long row_bytes,
                             void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (row_bytes == 4) {
    gather_scalar_kernel<unsigned int><<<gt_blocks(n, threads), threads, 0, s>>>(
        (const unsigned int*)table, idx, (unsigned int*)out, n, rows);
  } else if (row_bytes == 8) {
    gather_scalar_kernel<unsigned long long>
        <<<gt_blocks(n, threads), threads, 0, s>>>(
            (const unsigned long long*)table, idx, (unsigned long long*)out,
            n, rows);
  } else {
    const int rows_per_block = threads / 32;
    unsigned int blocks = gt_blocks(n, rows_per_block);
    uintptr_t align = (uintptr_t)table | (uintptr_t)out;
    if (row_bytes % 16 == 0 && align % 16 == 0) {
      gather_row_kernel<uint4><<<blocks, threads, 0, s>>>(
          (const uint4*)table, idx, (uint4*)out, n, rows, (int)(row_bytes / 16));
    } else if (row_bytes % 8 == 0 && align % 8 == 0) {
      gather_row_kernel<uint2><<<blocks, threads, 0, s>>>(
          (const uint2*)table, idx, (uint2*)out, n, rows, (int)(row_bytes / 8));
    } else {
      gather_row_kernel<unsigned int><<<blocks, threads, 0, s>>>(
          (const unsigned int*)table, idx, (unsigned int*)out, n, rows,
          (int)(row_bytes / 4));
    }
  }
  return (int)cudaGetLastError();
}
