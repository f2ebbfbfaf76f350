// K9 edgehash_probe: membership of P keys in the edge hash. From the int32
// key halves klo, khi [P] it computes each key's row, fetches the 512-byte
// row of table [rows, 128], compares its 64 (lo, odd) slots and writes
// found [P] (bool) and payload [P] (int32; 0 for a key that is not there).
//
// Replaces graphtpu/ops/edgehash.py:159-179 _probe_lanes: a row gather
// table[h] (the access pattern of dma_row_gather, pallas_gather.py:95), then
// strided slices, a compare, an any and a masked sum over [P, 128] in XLA.
// Here fetch, compare and payload select are one kernel, and the fetched rows
// never reach device memory.
//
// What it costs on the card: per probe 8 B of key, 5 B of result and one
// 512 B fetch of a random row; a graph-scale table (about 1 GB at RMAT
// s20/ef32) is far beyond the L2, so most rows come from device memory, once
// per probe. The least that must move is less: each distinct row once. Probes
// that share a row are not brought together here.
//
// Design: a warp per probe, each lane loading 16 B of the row (one coalesced
// 512 B request), then a ballot and a warp sum (csrc/edgehash.cuh). A warp
// takes K9_PER_WARP neighbouring probes and starts all their row loads
// before it compares any, so that several rows are in flight per warp.
#include "edgehash.cuh"

#define K9_THREADS 256
#define K9_PER_WARP 4

__global__ void __launch_bounds__(K9_THREADS)
edgehash_probe_kernel(GtEdgeHash eh, const int* __restrict__ klo,
                      const int* __restrict__ khi, bool* __restrict__ found,
                      int* __restrict__ payload, long long p) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * K9_PER_WARP;
  if (first >= p) return;  // the whole warp
  int lo[K9_PER_WARP], hi[K9_PER_WARP];
  int4 v[K9_PER_WARP];
#pragma unroll
  for (int k = 0; k < K9_PER_WARP; ++k) {
    // a probe past the end reads the row of key (0, 0) and writes nothing
    const bool live = first + k < p;
    lo[k] = live ? __ldg(klo + first + k) : 0;
    hi[k] = live ? __ldg(khi + first + k) : 0;
    v[k] = gt_eh_load(eh, lo[k], hi[k], lane);
  }
#pragma unroll
  for (int k = 0; k < K9_PER_WARP; ++k) {
    bool hit;
    const int pay = gt_eh_finish(v[k], lo[k], hi[k], hit);
    if (lane == 0 && first + k < p) {
      found[first + k] = hit;
      payload[first + k] = pay;
    }
  }
}

GT_EXPORT int gt_edgehash_probe(const int* table, long long rows, const int* klo,
                                const int* khi, bool* found, int* payload,
                                long long p, void* stream) {
  if (p == 0) return (int)cudaGetLastError();
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows)) return (int)cudaErrorInvalidValue;
  const long long per_block = (K9_THREADS / 32) * K9_PER_WARP;
  const long long blocks = (p + per_block - 1) / per_block;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  edgehash_probe_kernel<<<(unsigned int)blocks, K9_THREADS, 0,
                          (cudaStream_t)stream>>>(eh, klo, khi, found, payload, p);
  return (int)cudaGetLastError();
}
