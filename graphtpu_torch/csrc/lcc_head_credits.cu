// K16 lcc_head_credits: LCC's head-credit sums in slab order. Over the
// buckets of a wedge plan (or of a rank's columns of them), for every slab
// entry e with slab[e] >= 0:
//   num[slab[e]] += edge_cred[e]                              (int64)
// and, where the caller hands the apex credits (the one-device path), for
// every real row r of bucket k:
//   num[rows_k[r]] += u_cred_k[r]
// num [n] is zeroed by the entry point first (a memset on the stream), so
// the result depends on nothing launched before it.
//
// Replaces K7 in mode sum_i64 over the plan's head order (the port's
// counterpart of graphtpu/ops/triangles.py:621 `_aggregate_heads`: a gather
// of the concatenated credit slabs at edge_pos, a prefix sum differenced at
// head_indptr) together with the torch.cat of the credit slabs before it and
// the apex credits' cat and indexed add after it
// (graphtpu_torch/ops/triangles.py numerator_from_credits, and the
// per-rank sums of parallel/wedge_lcc.py).
//
// Bound on an H100 (3.35 TB/s): bytes. Each real entry's head and credit
// read once (8 B), each apex row's id and credit once (12 B), num written
// once (8 B a vertex): at the bench graph (RMAT s20/ef32) 30.2M entries
// and 611K rows, 257 MB or 0.077 ms. The padded slabs streamed whole are
// 296 MB (0.088 ms).
//
// Design: K7's gather in head order reads one 4-byte credit per 32-byte
// sector from 144 MB of slabs that L2 cannot hold; here the credits and
// their heads both stream in slab order with 16-byte loads (the head of a
// slab entry is the entry itself), and the sums scatter into num, 8 MB,
// which L2 holds. Integer sums are exact in any order, so the scatter gives
// the gather's bits. Ids are (degree, id) ranks, so the hub heads that take
// most credits (at the bench graph the top 16,384 take 99.1 % of the edge
// credits' sum) are the top id range: each block keeps the sums of heads
// [n - K16_HUBS, n) in shared memory (two 32-bit words a head, 32-bit
// shared-memory atomics) and flushes each nonzero one with one global atomic
// at its end; every other head takes a global 64-bit atomic in L2 (every
// head there took 1.03 ms: the hubs' atomics queue in L2). Zero credits add
// nothing and are skipped. The window is as wide as one block an SM allows
// with room to spare: 24,576 heads took 131 us at the bench graph against
// 150 for 16,384, 180 for 8,192 and 132 for 28,672, and a probe without
// adds 107-112 us, the stream alone (tools/head_residual_times.py).
// One wave of blocks walks tiles of K16_THREADS quads (4 entries) in a
// grid-stride loop; a bucket's entries and its apex rows are segments of
// whole tiles, so each tile's segment is block-uniform.
#include "common.cuh"

#ifndef K16_HUBS
#define K16_HUBS 24576  // heads summed in shared memory: 192 KB
#endif
#ifndef K16_PROBE
#define K16_PROBE 0  // 1: no adds (a measuring build's probe: wrong sums)
#endif
#define K16_THREADS 1024
#define K16_MAX_BUCKETS 16
#define K16_MAX_DEVICES 64

// One bucket as the host hands it: a [W, R] slab (-1 = pad) and its edge
// credits, both int32 of `entries` = W * R; the apex credits of its first
// r_real rows and their ids (null and 0 when the caller adds them itself).
struct K16Bucket {
  const int* slab;
  const int* cred;
  long long entries;
  const int* u_cred;
  const long long* rows;
  long long r_real;
};

// A segment of the launch: a bucket's entries (heads32) or its apex rows
// (heads64), owning tiles [first_tile, next segment's first_tile).
struct K16Segment {
  const int* heads32;
  const long long* heads64;
  const int* cred;
  long long len;
  long long first_tile;
  int vec;  // 16-byte loads: heads32 and cred both 16-byte aligned
};

struct K16Table {
  K16Segment s[2 * K16_MAX_BUCKETS];
  long long tiles;
  int ns;
};

// Adds c (nonzero) to head h: in the block's window, or in num. The window
// holds a head's sum as two 32-bit words, [0, K16_HUBS) the low ones and
// [K16_HUBS, 2 K16_HUBS) the high ones: a 32-bit shared-memory atomic adds c
// to the low word, and the add that wraps it (or a negative c) adds the
// carry to the high word. (A 64-bit shared-memory atomic add is a
// compare-and-swap loop on this card, ATOMS.CAST.SPIN.64: with 16,384 heads
// it took 178 us against these words' 149 at the bench graph.)
__device__ __forceinline__ void k16_put(long long h, int c, long long lo, unsigned* win,
                                        unsigned long long* num) {
  if (h >= lo) {
    const unsigned u = (unsigned)c;
    const unsigned old = atomicAdd(win + (h - lo), u);
    const unsigned carry = (old + u < old ? 1u : 0u) - (c < 0 ? 1u : 0u);
    if (carry) atomicAdd(win + K16_HUBS + (h - lo), carry);
  } else {
    atomicAdd(num + h, (unsigned long long)(long long)c);
  }
}

// Entry (h, c): a pad, a zero credit or an id outside [0, n) adds nothing.
__device__ __forceinline__ void k16_add(long long h, int c, long long n, long long lo,
                                        unsigned* win, unsigned long long* num) {
#if K16_PROBE
  // the stream alone: no add (wrong sums; a measuring build's probe)
  if (c == 0x7fffffff && h == n) num[0] = 1;
#else
  if (c != 0 && h >= 0 && h < n) k16_put(h, c, lo, win, num);
#endif
}

__global__ void __launch_bounds__(K16_THREADS)
k16_head_credits_kernel(const __grid_constant__ K16Table t, long long n, long long lo,
                        unsigned long long* __restrict__ num) {
  extern __shared__ unsigned win[];
  const int hubs = (int)(n - lo);
  for (int i = threadIdx.x; i < 2 * K16_HUBS; i += K16_THREADS) win[i] = 0u;
  __syncthreads();
  int s = 0;
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    while (s + 1 < t.ns && tile >= t.s[s + 1].first_tile) ++s;  // block-uniform
    const K16Segment& g = t.s[s];
    const long long e0 = ((tile - g.first_tile) * K16_THREADS + threadIdx.x) * 4;
    long long h[4] = {-1, -1, -1, -1};
    int c[4] = {0, 0, 0, 0};
    if (g.heads64) {  // apex rows: ids int64
      for (int k = 0; k < 4 && e0 + k < g.len; ++k) {
        h[k] = __ldcs(g.heads64 + e0 + k);
        c[k] = __ldcs(g.cred + e0 + k);
      }
    } else if (g.vec && e0 + 4 <= g.len) {
      const int4 hv = __ldcs(reinterpret_cast<const int4*>(g.heads32 + e0));
      const int4 cv = __ldcs(reinterpret_cast<const int4*>(g.cred + e0));
      h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
      c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
    } else {
      for (int k = 0; k < 4 && e0 + k < g.len; ++k) {
        h[k] = __ldcs(g.heads32 + e0 + k);
        c[k] = __ldcs(g.cred + e0 + k);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) k16_add(h[k], c[k], n, lo, win, num);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hubs; i += K16_THREADS) {
    const unsigned long long v = (unsigned long long)win[K16_HUBS + i] << 32 | win[i];
    if (v) atomicAdd(num + lo + i, v);
  }
}

// One wave on the current device: as many blocks as its SMs hold at once
// (found once per device).
static int k16_grid(int* grid) {
  static int cached[K16_MAX_DEVICES];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < K16_MAX_DEVICES && cached[dev] > 0) {
    *grid = cached[dev];
    return 0;
  }
  const int smem = K16_HUBS * (int)sizeof(unsigned long long);
  rc = cudaFuncSetAttribute(k16_head_credits_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k16_head_credits_kernel,
                                                     K16_THREADS, smem);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev < K16_MAX_DEVICES) cached[dev] = *grid;
  return 0;
}

static void k16_segment(K16Table& t, const int* h32, const long long* h64, const int* cred,
                        long long len) {
  if (len <= 0) return;
  K16Segment& g = t.s[t.ns++];
  g.heads32 = h32;
  g.heads64 = h64;
  g.cred = cred;
  g.len = len;
  g.first_tile = t.tiles;
  g.vec = h32 && ((uintptr_t)h32 % 16 == 0) && ((uintptr_t)cred % 16 == 0);
  t.tiles += (len + 4LL * K16_THREADS - 1) / (4LL * K16_THREADS);
}

// The hub window's size, for the wrapper and the measuring tools.
GT_EXPORT long long gt_lcc_head_credits_hubs() { return K16_HUBS; }

// buckets [nb] (nb <= K16_MAX_BUCKETS), num [n] int64, written whole.
GT_EXPORT int gt_lcc_head_credits(const K16Bucket* buckets, int nb, long long n,
                                  long long* num, void* stream) {
  if (nb < 0 || nb > K16_MAX_BUCKETS || n < 0 || (nb && !buckets) || (n && !num))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  const cudaError_t z = cudaMemsetAsync(num, 0, (size_t)n * sizeof(long long), s);
  if (z != cudaSuccess) return (int)z;
  K16Table t;
  t.tiles = 0;
  t.ns = 0;
  for (int k = 0; k < nb; ++k) {
    const K16Bucket& b = buckets[k];
    if (b.entries < 0 || b.r_real < 0 || (b.entries && (!b.slab || !b.cred)) ||
        (b.r_real && (!b.u_cred || !b.rows)))
      return (int)cudaErrorInvalidValue;
    k16_segment(t, b.slab, nullptr, b.cred, b.entries);
  }
  for (int k = 0; k < nb; ++k)
    k16_segment(t, nullptr, buckets[k].rows, buckets[k].u_cred, buckets[k].r_real);
  if (t.tiles == 0) return (int)cudaGetLastError();
  int grid = 0;
  const int rc = k16_grid(&grid);
  if (rc != 0) return rc;
  const long long blocks = t.tiles < grid ? t.tiles : grid;
  const long long lo = n > K16_HUBS ? n - K16_HUBS : 0;
  k16_head_credits_kernel<<<(unsigned int)blocks, K16_THREADS,
                            K16_HUBS * sizeof(unsigned long long), s>>>(
      t, n, lo, (unsigned long long*)num);
  return (int)cudaGetLastError();
}
