// K18 frontier_starts: the row starts of a frontier's expansion,
//   starts[0] = 0, starts[i + 1] = deg_pad[ids[0]] + ... + deg_pad[ids[i]]
// for ids [k] (int32, padded with n: deg_pad[n] == 0), int32 sums that wrap
// as jnp.cumsum's do; starts[k] is the expansion's edge count.
//
// Replaces graphtpu/ops/frontier.py:118-122 (`lens = table_gather(deg_pad,
// ids)`, the exclusive int32 cumsum and the concatenate), which the port ran
// as three torch ops (a K1 gather, torch.cumsum, torch.cat) before every K5
// expansion of the adaptive loops.
//
// Bound on an H100 (3.35 TB/s): bytes, k ids and their degrees read, k + 1
// starts written: 12 * k bytes, 0.9 us at k = 2^18, the largest tier row
// budget; a call costs its launch.
//
// Design: a single-pass scan with decoupled look-back, one launch. Each block
// takes a tile of K18_TILE ids in the order of a ticket it draws from a
// counter (so a block only ever waits on blocks that already run): its
// threads load the ids coalesced and gather their degrees into shared
// memory, then each thread sums K18_ITEMS consecutive ones and the block
// scans the threads' sums. The tile's total goes out at once as an
// aggregate (flag 1); the block's first warp reads the status of the 32
// tiles before it at once, sums the aggregates after the nearest one that
// has published its inclusive prefix (flag 2), and that prefix, stepping 32
// tiles further back while none has; it publishes its own inclusive prefix
// and the block writes its starts. A status word is (flag << 32 | value),
// written and read whole. The ticket
// and the status words are a scratch the entry zeroes first by a memset on
// the stream. Nothing is read back. An id outside [0, n_pad) reads degree
// 0, as K1 gathers a zero row for it. (One block of 1,024 threads, the first
// design, took 72 us a call at 2^16 ids on an H100: one SM cannot keep
// enough random degree loads in flight; one thread walking back a tile at a
// time, the second, 8.4 us.)
#include "common.cuh"

#define K18_THREADS 256
#define K18_ITEMS 8
#define K18_TILE (K18_THREADS * K18_ITEMS)

__device__ __forceinline__ unsigned long long k18_load(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// scratch: [0] the ticket counter, [1 + t] tile t's status.
__global__ void __launch_bounds__(K18_THREADS)
k18_starts_kernel(const int* __restrict__ ids, long long k, const int* __restrict__ deg_pad,
                  long long n_pad, int* __restrict__ starts,
                  unsigned long long* __restrict__ scratch) {
  __shared__ unsigned int s_lens[K18_TILE + K18_TILE / 32];  // a pad word every 32
  __shared__ unsigned int s_warp[K18_THREADS / 32];
  __shared__ unsigned int s_before;
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const long long tile = s_tile, base = tile * K18_TILE;
#pragma unroll
  for (int j = 0; j < K18_ITEMS; ++j) {
    const long long i = base + j * K18_THREADS + threadIdx.x;
    unsigned int d = 0;
    if (i < k) {
      const int id = __ldg(ids + i);
      if (id >= 0 && (long long)id < n_pad) d = (unsigned int)__ldg(deg_pad + id);
    }
    const int at = j * K18_THREADS + threadIdx.x;
    s_lens[at + (at >> 5)] = d;
  }
  __syncthreads();
  unsigned int v[K18_ITEMS];
  unsigned int sum = 0;  // unsigned: the sums wrap mod 2^32 as an int32 cumsum does
#pragma unroll
  for (int j = 0; j < K18_ITEMS; ++j) {
    const int at = threadIdx.x * K18_ITEMS + j;
    v[j] = s_lens[at + (at >> 5)];
    sum += v[j];
  }
  unsigned int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned int w = lane < K18_THREADS / 32 ? s_warp[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < K18_THREADS / 32) s_warp[lane] = w;  // inclusive scan of the warp totals
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned int agg = s_warp[K18_THREADS / 32 - 1];
    unsigned long long* status = scratch + 1;
    unsigned int before = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, 2ull << 32 | agg);
    } else {
      if (lane == 0) atomicExch(status + tile, 1ull << 32 | agg);
      for (long long end = tile;; end -= 32) {
        // lane 31 reads the tile just before [end - 32, end)'s end; a tile
        // before the first reads as an inclusive prefix of 0
        const long long t = end - 32 + lane;
        unsigned long long w = t >= 0 ? k18_load(status + t) : 2ull << 32;
        while (__any_sync(0xffffffffu, (w >> 32) == 0))
          if ((w >> 32) == 0) w = k18_load(status + t);
        const unsigned int inc = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        const int nearest = inc ? 31 - __clz(inc) : -1;  // -1: every lane adds
        before += __reduce_add_sync(0xffffffffu, lane >= nearest ? (unsigned int)w : 0u);
        if (inc) break;
      }
      if (lane == 0) atomicExch(status + tile, 2ull << 32 | (before + agg));
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  unsigned int run = s_before + (warp ? s_warp[warp - 1] : 0u) + incl - sum;
  const long long first = base + (long long)threadIdx.x * K18_ITEMS;
#pragma unroll
  for (int j = 0; j < K18_ITEMS; ++j) {
    run += v[j];
    if (first + j < k) starts[first + j + 1] = (int)run;
  }
  if (tile == 0 && threadIdx.x == 0) starts[0] = 0;
}

// Tiles of a call at k ids.
static inline long long k18_tiles(long long k) { return k ? (k + K18_TILE - 1) / K18_TILE : 0; }

// ids [k] int32, deg_pad [n_pad] int32, starts [k + 1] int32; scratch:
// scratch_words uint64 (gt_frontier_starts_scratch_words(k)), zeroed here.
GT_EXPORT int gt_frontier_starts(const int* ids, long long k, const int* deg_pad, long long n_pad,
                                 int* starts, unsigned long long* scratch,
                                 long long scratch_words, void* stream) {
  if (k < 0 || k >= 0x7fffffffLL || n_pad < 0 || !starts || !scratch ||
      scratch_words < 1 + k18_tiles(k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!k) {  // starts = [0]
    const cudaError_t z = cudaMemsetAsync(starts, 0, sizeof(int), s);
    return (int)(z != cudaSuccess ? z : cudaGetLastError());
  }
  const cudaError_t z = cudaMemsetAsync(scratch, 0, (1 + k18_tiles(k)) * 8, s);
  if (z != cudaSuccess) return (int)z;
  k18_starts_kernel<<<(unsigned int)k18_tiles(k), K18_THREADS, 0, s>>>(ids, k, deg_pad, n_pad,
                                                                       starts, scratch);
  return (int)cudaGetLastError();
}

// The uint64 words of a call's scratch at k ids.
GT_EXPORT long long gt_frontier_starts_scratch_words(long long k) { return 1 + k18_tiles(k); }
