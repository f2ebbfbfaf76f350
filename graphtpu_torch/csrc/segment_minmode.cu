// K12 segment_minmode: for each segment s of a CSR-style stream (indptr
// [H+1] int32 over neigh [m] int32), the smallest label among the most
// frequent of
//   gather mode:   labels[neigh[indptr[s] .. indptr[s+1])]   a CDLP step
//   identity mode: neigh[indptr[s] .. indptr[s+1])           iteration 0
// and INT32_INF for a segment without entries. An id outside [0, bound) in
// gather mode, and a label (gathered or the id itself) that is negative or
// INT32_INF, counts as pad: it is not read past the table and not counted.
// The segments come from indptr alone; a caller's per-entry segment ids
// (`centers`) are not read.
//
// Replaces graphtpu/ops/minmode.py:77-150 (stream_minmode: an XLA pair sort
// of (center, label), run-length cummax scans and a segment-end gather),
// which runs on CDLP's heavy rows (every full step, iteration 0 on directed
// graphs), on every active-tier step (graphtpu/ops/active.py) and per rank in
// the distributed slab CDLP. The tie-break is LAGraph_cdlp.c:40-45's.
//
// Bound on an H100 (3.35 TB/s): bytes. neigh is read once (4 B an entry),
// indptr once, the labels once and 4 B written a segment: on the bench
// graph's 1,351 heavy rows (12.8M entries) about 55 MB, 0.017 ms. As in K2,
// one random 4 B label read per entry costs a 32 B sector of L2 or memory.
//
// Design: no host read. The torch-op version learns its run boundaries by
// torch.unique_consecutive, whose size is data-dependent, so each call waits
// for the device; here every size a launch needs is a shape (H, m), and the
// work list of long segments stays on the card.
//  * k12_warp_kernel: a warp per segment. A segment of at most 32 entries is
//    done in registers: each lane holds one label, __match_any_sync finds the
//    lanes of equal label, and the popcount of that mask is the label's
//    count; a warp max of (count << 32 | INT32_MAX - label) is the answer.
//    A longer segment's id is appended to a work list (one atomicAdd on its
//    count, which the entry point sets to 0 first).
//  * k12_block_kernel: a persistent grid (as many 512-thread blocks as the
//    card holds at once) walks the work list, a block per segment. The block
//    counts its segment's labels in an open-addressing table (hash_insert,
//    csrc/minmode.cuh, as K2's wide path does): in shared memory for up to
//    4096 entries (6,144 table entries, 48 KB), else in a global-memory table
//    at entries [lo + lo/2, hi + hi/2) of a scratch the wrapper allocates
//    (m + m/2 entries: at least 3/2 of the segment's length, so larger than
//    its distinct labels). Lanes of a warp with equal labels insert once, by
//    their lowest lane. Each thread keeps four loads in flight a round.
//  * The winner is the block max of the packed keys the inserts return; counts
//    are exact, so the atomics leave the result deterministic.
#include "minmode.cuh"

#define K12_WARPS 8          // segments a block of the warp kernel
#define K12_WARP_LEN 32      // longest segment a warp counts in registers
#define K12_BLOCK 512        // threads of the block kernel
#define K12_UNROLL 4         // entries a thread loads before it counts them
#define K12_SMEM_LEN 4096    // longest segment counted in shared memory
#define K12_SMEM_ENTRIES (K12_SMEM_LEN + K12_SMEM_LEN / 2)
#define K12_SMEM_BYTES (K12_SMEM_ENTRIES * 2 * (int)sizeof(int))
#define K12_MAX_DEVICES 64

// The label of stream entry pos, or INT32_INF for a pad.
__device__ __forceinline__ int k12_label(const int* __restrict__ neigh,
                                         const int* __restrict__ labels,
                                         long long pos, long long bound) {
  const int id = neigh[pos];
  if (id < 0) return GT_INT32_INF;
  if (labels == nullptr) return id;  // INT32_INF stays a pad
  if ((long long)id >= bound) return GT_INT32_INF;
  const int v = __ldg(labels + id);
  return v < 0 ? GT_INT32_INF : v;
}

// Segment s's entries [lo, hi), clamped into [0, m].
__device__ __forceinline__ void k12_segment(const int* __restrict__ indptr,
                                            long long s, long long m,
                                            long long& lo, long long& hi) {
  lo = min(max((long long)indptr[s], 0ll), m);
  hi = min(max((long long)indptr[s + 1], lo), m);
}

__global__ void __launch_bounds__(K12_WARPS * 32)
k12_warp_kernel(const int* __restrict__ labels, const int* __restrict__ neigh,
                const int* __restrict__ indptr, int h, long long m,
                long long bound, int* __restrict__ out, int* __restrict__ wide) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * K12_WARPS + (threadIdx.x >> 5);
  if (s >= h) return;  // warp-uniform
  long long lo, hi;
  k12_segment(indptr, s, m, lo, hi);
  if (hi - lo > K12_WARP_LEN) {
    if (lane == 0) wide[1 + atomicAdd(wide, 1)] = (int)s;
    return;
  }
  const int v = lo + lane < hi ? k12_label(neigh, labels, lo + lane, bound)
                               : GT_INT32_INF;
  const unsigned int peers = __match_any_sync(0xffffffffu, v);
  unsigned long long key = 0;
  if (v != GT_INT32_INF)
    key = ((unsigned long long)__popc(peers) << 32) |
          ((unsigned int)GT_INT32_INF - (unsigned int)v);
  key = warp_max_u64(key);
  if (lane == 0) out[s] = gt_minmode_label(key);
}

// One segment's entries [lo, hi) counted by the whole block in a table of
// `size` entries (keys, cnts); returns the block's best packed key to thread
// 0. Block-uniform control flow throughout.
__device__ __forceinline__ unsigned long long k12_count(
    const int* __restrict__ neigh, const int* __restrict__ labels,
    long long lo, long long hi, long long bound, int* keys, int* cnts, int size,
    unsigned long long* wbest) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < size; i += K12_BLOCK) {
    keys[i] = GT_EMPTY;
    cnts[i] = 0;
  }
  __syncthreads();
  unsigned long long best = 0;
  for (long long w0 = lo; w0 < hi; w0 += K12_BLOCK * K12_UNROLL) {
    int lab[K12_UNROLL];
#pragma unroll
    for (int u = 0; u < K12_UNROLL; ++u) {
      const long long pos = w0 + u * K12_BLOCK + tid;
      lab[u] = pos < hi ? k12_label(neigh, labels, pos, bound) : GT_INT32_INF;
    }
#pragma unroll
    for (int u = 0; u < K12_UNROLL; ++u) {
      const int v = lab[u];
      const unsigned int peers = __match_any_sync(0xffffffffu, v);
      if (v != GT_INT32_INF && __ffs(peers) - 1 == lane)
        best = max(best, hash_insert(keys, cnts, size, v, __popc(peers)));
    }
  }
  best = warp_max_u64(best);
  if (lane == 0) wbest[tid >> 5] = best;
  __syncthreads();
  if (tid == 0)
    for (int j = 1; j < K12_BLOCK / 32; ++j) best = max(best, wbest[j]);
  return best;
}

__global__ void __launch_bounds__(K12_BLOCK)
k12_block_kernel(const int* __restrict__ labels, const int* __restrict__ neigh,
                 const int* __restrict__ indptr, long long m, long long bound,
                 int* __restrict__ out, const int* __restrict__ wide,
                 int* __restrict__ gkeys, int* __restrict__ gcnts) {
  extern __shared__ int tables[];
  __shared__ unsigned long long wbest[K12_BLOCK / 32];
  const int count = wide[0];
  for (int i = blockIdx.x; i < count; i += gridDim.x) {  // block-uniform
    const long long s = wide[1 + i];
    long long lo, hi;
    k12_segment(indptr, s, m, lo, hi);
    const long long len = hi - lo;
    unsigned long long best;
    if (len <= K12_SMEM_LEN) {
      const int size = (int)(len + len / 2);
      best = k12_count(neigh, labels, lo, hi, bound, tables, tables + size, size,
                       wbest);
    } else {
      const long long off = lo + lo / 2;
      best = k12_count(neigh, labels, lo, hi, bound, gkeys + off, gcnts + off,
                       (int)(hi + hi / 2 - off), wbest);
    }
    if (threadIdx.x == 0) out[s] = gt_minmode_label(best);
  }
}

// The persistent grid of the block kernel on the current device: as many
// blocks as its SMs hold at once (found once per device).
static int k12_grid(int* grid) {
  static int cached[K12_MAX_DEVICES];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < K12_MAX_DEVICES && cached[dev] > 0) {
    *grid = cached[dev];
    return 0;
  }
  rc = cudaFuncSetAttribute(k12_block_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            K12_SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k12_block_kernel,
                                                     K12_BLOCK, K12_SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev < K12_MAX_DEVICES) cached[dev] = *grid;
  return 0;
}

// labels (null = identity mode), neigh [m], indptr [h+1], out [h], wide
// [h+1] (the work list: its count, then segment ids). Segments of at most 32
// entries are written here; the longer ones are listed for the block kernel.
GT_EXPORT int gt_segment_minmode_warp(const int* labels, const int* neigh,
                                      const int* indptr, int h, long long m,
                                      long long bound, int* out, int* wide,
                                      void* stream) {
  if (h < 0 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(wide, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  if (h == 0) return (int)cudaGetLastError();
  k12_warp_kernel<<<gt_blocks(h, K12_WARPS), K12_WARPS * 32, 0, s>>>(
      labels, neigh, indptr, h, m, bound, out, wide);
  return (int)cudaGetLastError();
}

// The listed segments of more than 32 entries; gkeys and gcnts hold m + m/2
// entries each where m exceeds 4096, else may be null.
GT_EXPORT int gt_segment_minmode_block(const int* labels, const int* neigh,
                                       const int* indptr, int h, long long m,
                                       long long bound, int* out,
                                       const int* wide, int* gkeys, int* gcnts,
                                       void* stream) {
  if (h < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m > K12_SMEM_LEN && (gkeys == nullptr || gcnts == nullptr))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int rc = k12_grid(&grid);
  if (rc != 0) return rc;
  if (h < grid) grid = h;
  if (grid == 0) return (int)cudaGetLastError();
  k12_block_kernel<<<grid, K12_BLOCK, K12_SMEM_BYTES, (cudaStream_t)stream>>>(
      labels, neigh, indptr, m, bound, out, wide, gkeys, gcnts);
  return (int)cudaGetLastError();
}
