// K14 frontier_compact: the frontier engine's two compactions into a padded,
// ascending id list ids [k] (int32, padded with n, cut at k) with the true
// count as a 0-d int32 on the device:
//   compact(mask [n] bool, k):             the ids v with mask[v];
//   compact_stream(vals [e], active [e], k, n): the distinct values vals[j]
//                                          with active[j] and vals[j] in [0, n);
//   its row-flag mode (CDLP's tier step): slot j is active when j < edge_count
//     and rowflag[rows_local[j]], the rows of an expansion whose label changed.
// Either stream entry can also add deg_pad[id] of every id it writes into a
// status word (frontier_deg_sum: the degree sum of the ids, pad ids read 0).
//
// Replaces graphtpu/ops/frontier.py:85 `compact` (a sort of where(mask, id,
// n), then a slice) and :145 `compact_stream` (a sort of where(active, vals,
// n), a dedupe mask, a second sort, a slice), which the port ran as
// torch.sort (cub's radix sort, several kernels and passes over the whole
// stream) on every tier, derive and bottom-up step.
//
// Bound on an H100 (3.35 TB/s): bytes. compact reads the mask once (1 B a
// vertex) and writes k ids; compact_stream reads the stream once (5 B a slot),
// touches a bitmap of n bits and writes k ids. At the CDLP and BFS tier shapes
// (n = 2^20, k = 2^16..2^18, e = 2^18..2^22) every call is a few MB, so a
// call costs its launches.
//
// Design: no sort. A frontier's ids are the set bits of a bitmap in order, so
// both entries compact 32-bit words. compact builds a lane's word from its own
// 32 mask bytes: two 16-byte loads and a multiply that packs each 4 bytes'
// low bits into a nibble. A mask that starts off a 16-byte boundary (a rank's
// slice of a longer mask) is read from the boundary below its start, and each
// word takes its high bits from the next lane's first load (the last lane
// loads that one itself). compact_stream marks the values into a bitmap of
// ceil(n / 32) words (zeroed by a memset on the stream first), which dedupes
// and orders them by construction: a slot reads its value's word through L1
// and, unless the bit is set there, sets it by atomicOr (a stale copy in L1
// only misses a mark, which costs a redundant atomic). On BFS's 2^22-slot
// stream over the bench graph the low-id hubs' words take thousands of marks
// each; an atomic a mark queues them in one L2 slice, and each SM's L1
// answers its own repeats once it holds the set bit. (A byte map of plain
// stores, compacted as a mask, the bitmap read in L2, and marks aggregated
// over a warp's lanes were no faster at 2^18 slots and slower at 2^22:
// PERF.md, section 6.) The slots' values and flags are read once, as a
// stream (__ldcs).
// Then two launches over the words: k14_count gives each block's popcount;
// k14_write finds its block's offset and the total by a block-wide sum over
// the (at most K14_MAX_BLOCKS) counts, hands each thread its word's offset by
// a block scan, and writes the set bits' ids below k; its grid also fills the
// pad slots [total, k) with n, and block 0 writes the count. Launch sizes come
// from the shapes alone and nothing is read back to the host. A block takes
// whole steps of K14_THREADS words, as many steps as keep the grid at
// K14_MAX_BLOCKS blocks or fewer.
// The row-flag mode ports graphtpu/ops/active.py:202-207 (the e-wide ch_edge
// mask, built in the port by four torch ops) and the degree sum
// graphtpu/ops/frontier.py:166-170 (a K1 gather and a sum): k14_mark reads a
// slot's row flag in place of a mask byte, and k14_write adds the degrees of
// the ids it writes, summed over the block, by one atomic a block into the
// status word, which k14_count's block 0 zeroes first.
// BFS auto's device loop (algorithms/bfs.py) adds two modes, so that its
// steps hold no torch op:
// * the level mode compacts the frontier `levels == level`
//   (graphtpu/algorithms/bfs.py:185, a compare and the sort of compact) with
//   the level read from a device word: a warp builds its 32 words by 32
//   ballots over 32 consecutive levels each, every load coalesced;
// * the unvisited mode marks the expansion's slots j < edge_count whose
//   neighbour v has levels[v] == INT32_INF (bfs.py:187-189, a gather, two
//   compares and an and over the e slots), read on the card.
// The mask entry can also write the degree sum of the ids (the bottom-up's
// residual rows and their in-degrees, bfs.py:231-232).
// Delta-stepping's device loop (algorithms/sssp.py) adds the bucket mode: the
// vertices whose distance lies in bucket k (read from a device word), and in
// the light derive also marked in the changed mask (graphtpu/algorithms/
// sssp.py:258-261 and :294-297: bucket(dist) == k, an and, and the sort of
// compact), with their degree sum in the class's deg_pad (JAX's fe, which
// equals the written ids' sum whenever the count fits k). A warp builds its
// 32 words by ballots over 32 consecutive distances each, as the level mode.
#include "common.cuh"

// where a compaction's words come from
#define K14_SRC_MASK 0    // a bool mask
#define K14_SRC_BITMAP 1  // the stream entries' bitmap
#define K14_SRC_LEVELS 2  // the int32 levels equal to a level read on the card
#define K14_SRC_BUCKET32 3  // float32 distances in the bucket read on the card
#define K14_SRC_BUCKET64 4  // float64 distances, the same

// which slots of a stream are marked
#define K14_MARK_ACTIVE 0     // active[j]
#define K14_MARK_ROWS 1       // j < *edge_count && rowflag[rows_local[j]]
#define K14_MARK_UNVISITED 2  // j < *edge_count && levels[vals[j]] == INT32_INF

#define K14_THREADS 256
#define K14_MAX_BLOCKS 1024

// steps of K14_THREADS words a block takes, for nwords words
static inline long long k14_steps(long long nwords) {
  const long long per_step = K14_THREADS;
  const long long steps = (nwords + per_step - 1) / per_step;
  return steps <= K14_MAX_BLOCKS ? 1 : (steps + K14_MAX_BLOCKS - 1) / K14_MAX_BLOCKS;
}

// The low bits of 4 mask bytes (0 or 1 each) as a nibble, byte 0 lowest: the
// product puts byte i's bit at bit 24 + i, and no two partial products meet.
__device__ __forceinline__ unsigned int k14_nibble(unsigned int u) {
  return (((u & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

__device__ __forceinline__ unsigned int k14_pack16(uint4 v) {
  return k14_nibble(v.x) | k14_nibble(v.y) << 4 | k14_nibble(v.z) << 8 | k14_nibble(v.w) << 12;
}

// The 16 mask bits of the aligned chunk at byte `at` of the stream that starts
// at `base` (16-byte aligned); 0 for a chunk past the last mask byte (`end`).
__device__ __forceinline__ unsigned int k14_chunk(const unsigned char* __restrict__ base,
                                                  long long at, long long end) {
  if (at >= end) return 0u;
  return k14_pack16(__ldg(reinterpret_cast<const uint4*>(base + at)));
}

// Where a compaction reads its words: a mask's bytes, the bitmap, or the
// levels with the level they are tested against.
struct K14Src {
  const unsigned char* base;  // a mask's bytes, from the 16-byte boundary below its start
  int mis;                    // the mask's start past base
  const unsigned int* bits;
  const int* levels;
  int level;              // the level, or the bucket
  const void* dist;       // the bucket mode's distances
  const bool* bmask;      // the bucket mode's changed mask (null: every vertex)
  double inv;             // the bucket mode's 1 / delta (rounded to float in float32)
};

// Word w of the frontier, for the thread that owns it (word index
// step_base + threadIdx.x). A mask's bytes start `mis` bytes past the aligned
// `base`: the thread reads the two chunks of aligned word w, takes the first
// chunk of aligned word w + 1 from the next lane, and shifts. The levels: the
// warp's 32 words, one ballot each over 32 consecutive levels. Bits past n
// and words past nwords are 0. Every lane of the warp must call.
template <int SRC>
__device__ __forceinline__ unsigned int k14_word(const K14Src& src, long long n, long long nwords,
                                                 long long step_base) {
  const long long w = step_base + threadIdx.x;
  if (SRC == K14_SRC_BITMAP) return w < nwords ? src.bits[w] : 0u;
  if (SRC == K14_SRC_BUCKET32 || SRC == K14_SRC_BUCKET64) {
    const int lane = threadIdx.x & 31;
    const long long first = 32 * (w - lane);  // the warp's first vertex
    unsigned int word = 0u;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const long long v = first + 32 * j + lane;
      bool hit = v < n && (!src.bmask || src.bmask[v]);
      if (hit) {
        if (SRC == K14_SRC_BUCKET32)
          hit = gt_delta_bucket(__ldg((const float*)src.dist + v), (float)src.inv) == src.level;
        else
          hit = gt_delta_bucket(__ldg((const double*)src.dist + v), src.inv) == src.level;
      }
      const unsigned int b = __ballot_sync(0xffffffffu, hit);
      if (lane == j) word = b;
    }
    return word;
  }
  if (SRC == K14_SRC_LEVELS) {
    const int lane = threadIdx.x & 31;
    const long long first = 32 * (w - lane);  // the warp's first vertex
    unsigned int word = 0u;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const long long v = first + 32 * j + lane;
      const unsigned int b =
          __ballot_sync(0xffffffffu, v < n && __ldg(src.levels + v) == src.level);
      if (lane == j) word = b;
    }
    return word;
  }
  const unsigned char* __restrict__ base = src.base;
  const int mis = src.mis;
  const long long end = mis + n, at = 32 * w;
  const unsigned int lo = k14_chunk(base, at, end) | k14_chunk(base, at + 16, end) << 16;
  unsigned int next = __shfl_down_sync(0xffffffffu, lo, 1);
  if ((threadIdx.x & 31) == 31) next = k14_chunk(base, at + 32, end);
  unsigned int word = mis ? (lo >> mis) | (next << (32 - mis)) : lo;
  const long long left = n - 32 * w;  // the word's real bits
  if (left < 32) word = left <= 0 ? 0u : word & ((1u << left) - 1u);
  return word;
}

__device__ __forceinline__ long long k14_block_sum(long long v, long long* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // s_red may still be read from an earlier call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int u = 0; u < K14_THREADS / 32; ++u) t += s_red[u];
  return t;
}

// The level a K14Src of the levels tests against, read on the card.
__device__ __forceinline__ K14Src k14_src(K14Src src, const int* __restrict__ level_at) {
  if (level_at) src.level = __ldg(level_at);
  return src;
}

template <int SRC>
__global__ void __launch_bounds__(K14_THREADS)
k14_count(K14Src src0, const int* __restrict__ level_at, long long n, long long nwords,
          long long steps, int* __restrict__ counts, int* __restrict__ deg_sum) {
  __shared__ long long s_red[K14_THREADS / 32];
  if (deg_sum && blockIdx.x == 0 && threadIdx.x == 0) *deg_sum = 0;  // k14_write adds to it
  const K14Src src = k14_src(src0, level_at);
  long long c = 0;
  for (long long s = 0; s < steps; ++s) {
    const long long base = ((long long)blockIdx.x * steps + s) * K14_THREADS;
    if (base >= nwords) break;  // block-uniform
    c += __popc(k14_word<SRC>(src, n, nwords, base));
  }
  const long long total = k14_block_sum(c, s_red);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)total;
}

template <int SRC>
__global__ void __launch_bounds__(K14_THREADS)
k14_write(K14Src src0, const int* __restrict__ level_at, long long n, long long nwords,
          long long steps, const int* __restrict__ counts, int nb, int* __restrict__ ids,
          long long k, int* __restrict__ count_out, const int* __restrict__ deg_pad,
          int* __restrict__ deg_sum) {
  __shared__ long long s_red[K14_THREADS / 32];
  __shared__ int s_scan[K14_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const K14Src src = k14_src(src0, level_at);
  // the first step's word, read while the counts are read
  const long long first_base = (long long)blockIdx.x * steps * K14_THREADS;
  const unsigned int first_word =
      first_base < nwords ? k14_word<SRC>(src, n, nwords, first_base) : 0u;
  // this block's offset (the counts of the blocks before it) and the total
  long long before = 0, after = 0;
  for (int b = threadIdx.x; b < nb; b += K14_THREADS) {
    if (b < (int)blockIdx.x) before += counts[b]; else after += counts[b];
  }
  long long base = k14_block_sum(before, s_red);
  const long long total = base + k14_block_sum(after, s_red);
  if (blockIdx.x == 0 && threadIdx.x == 0) count_out[0] = (int)total;
  // the pad slots [total, k), over the whole grid
  for (long long q = total + (long long)blockIdx.x * K14_THREADS + threadIdx.x; q < k;
       q += (long long)gridDim.x * K14_THREADS)
    ids[q] = (int)n;
  long long degs = 0;  // the degrees of the ids this thread writes
  for (long long s = 0; s < steps && base < k; ++s) {
    const long long step_base = ((long long)blockIdx.x * steps + s) * K14_THREADS;
    if (step_base >= nwords) break;  // block-uniform
    unsigned int word = s == 0 ? first_word : k14_word<SRC>(src, n, nwords, step_base);
    // exclusive scan of the words' popcounts over the block
    const int c = __popc(word);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    int warp_off = 0, step_total = 0;
#pragma unroll
    for (int u = 0; u < K14_THREADS / 32; ++u) {
      const int t = s_scan[u];
      if (u < warp) warp_off += t;
      step_total += t;
    }
    __syncthreads();  // s_scan is written again by the next step
    long long pos = base + warp_off + incl - c;
    const long long first_id = (step_base + threadIdx.x) * 32;
    while (word && pos < k) {
      const int bit = __ffs(word) - 1;
      const int id = (int)(first_id + bit);
      ids[pos++] = id;
      if (deg_sum) degs += __ldg(deg_pad + id);
      word &= word - 1;
    }
    base += step_total;
  }
  if (deg_sum) {  // block-uniform; the sum wraps mod 2^32 as an int32 sum does
    const long long t = k14_block_sum(degs, s_red);
    if (threadIdx.x == 0 && t)
      atomicAdd(reinterpret_cast<unsigned int*>(deg_sum), (unsigned int)t);
  }
}

// Marks value v = vals[j] of every active slot j with v in [0, n) into the
// bitmap (see the header). MARK: which slots are active (K14_MARK_*): active[j]; j <
// *edge_count and rowflag[rows_local[j]] (the row-flag mode); j < *edge_count
// and levels[v] == INT32_INF (the unvisited mode).
template <int MARK>
__global__ void __launch_bounds__(K14_THREADS)
k14_mark(const int* __restrict__ vals, const bool* __restrict__ active,
         const int* __restrict__ rows_local, const bool* __restrict__ rowflag,
         const int* __restrict__ edge_count, const int* __restrict__ levels, long long e,
         long long n, unsigned int* __restrict__ bits) {
  const long long j = (long long)blockIdx.x * K14_THREADS + threadIdx.x;
  if (j >= e) return;
  if (MARK != K14_MARK_ACTIVE) {
    if (j >= (long long)__ldg(edge_count)) return;
    if (MARK == K14_MARK_ROWS) {
      const int r = __ldcs(rows_local + j);
      if (!__ldg(reinterpret_cast<const unsigned char*>(rowflag) + r)) return;
    }
  } else if (!__ldcs(reinterpret_cast<const unsigned char*>(active) + j)) {
    return;
  }
  const int v = __ldcs(vals + j);
  if (v < 0 || (long long)v >= n) return;
  if (MARK == K14_MARK_UNVISITED && __ldg(levels + v) != GT_INT32_INF) return;
  const unsigned int bit = 1u << (v & 31);
  unsigned int* word = bits + (v >> 5);
  if (!(__ldca(word) & bit)) atomicOr(word, bit);
}

// The scratch of a call: counts [K14_MAX_BLOCKS] int32.
template <int SRC>
static int k14_compact_words(const K14Src& src, const int* level_at, long long n, int* ids,
                             long long k, int* count_out, const int* deg_pad, int* deg_sum,
                             int* counts, long long scratch_ints, cudaStream_t s) {
  const long long nwords = (n + 31) / 32;
  const long long steps = k14_steps(nwords);
  const long long nb_ll = nwords ? (nwords + steps * K14_THREADS - 1) / (steps * K14_THREADS) : 1;
  if (nb_ll > K14_MAX_BLOCKS || scratch_ints < nb_ll) return (int)cudaErrorInvalidValue;
  const int nb = (int)nb_ll;
  k14_count<SRC><<<nb, K14_THREADS, 0, s>>>(src, level_at, n, nwords, steps, counts, deg_sum);
  k14_write<SRC><<<nb, K14_THREADS, 0, s>>>(src, level_at, n, nwords, steps, counts, nb, ids, k,
                                            count_out, deg_pad, deg_sum);
  return (int)cudaGetLastError();
}

// A mask's source: its bytes from the 16-byte boundary below its start.
static K14Src k14_mask_src(const bool* mask) {
  K14Src src = {};
  src.mis = (int)((uintptr_t)mask & 15);
  src.base = (const unsigned char*)mask - src.mis;
  return src;
}

// mask [n] bool; ids [k] int32; count_out 0-d int32; scratch [scratch_ints] int32.
GT_EXPORT int gt_frontier_compact(const bool* mask, long long n, int* ids, long long k,
                                  int* count_out, int* scratch, long long scratch_ints,
                                  void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k < 0 || !count_out || !scratch)
    return (int)cudaErrorInvalidValue;
  return k14_compact_words<K14_SRC_MASK>(k14_mask_src(mask), nullptr, n, ids, k, count_out,
                                         nullptr, nullptr, scratch, scratch_ints,
                                         (cudaStream_t)stream);
}

// The device loop's compactions into its buffers: the v with mask[v] (mask
// [n] bool), or where levels is not null the v with levels[v] == *level_at
// (levels [n] int32, level_at an int32 on the card); ids [k] int32;
// count_out an int32 on the card; deg_sum (null: none) takes the sum of
// deg_pad over the ids written; scratch as above.
GT_EXPORT int gt_frontier_compact_into(const bool* mask, const int* levels, const int* level_at,
                                       long long n, int* ids, long long k, int* count_out,
                                       const int* deg_pad, int* deg_sum, int* scratch,
                                       long long scratch_ints, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k < 0 || !count_out || !scratch || (deg_sum && !deg_pad) ||
      (levels ? !level_at : !mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!levels)
    return k14_compact_words<K14_SRC_MASK>(k14_mask_src(mask), nullptr, n, ids, k, count_out,
                                           deg_pad, deg_sum, scratch, scratch_ints, s);
  K14Src src = {};
  src.levels = levels;
  return k14_compact_words<K14_SRC_LEVELS>(src, level_at, n, ids, k, count_out, deg_pad, deg_sum,
                                           scratch, scratch_ints, s);
}

// vals [e] int32; the active slots (mode, K14_MARK_*): active [e] bool; the
// row-flag mode's rows_local [e] int32, rowflag (bool, one a row) and
// edge_count (a device int32); the unvisited mode's edge_count and levels
// [n] int32; bits: ceil(n / 32) words of scratch, zeroed here; ids,
// count_out and scratch as above; deg_sum (null: none) takes the sum of
// deg_pad over the ids written.
GT_EXPORT int gt_frontier_compact_stream(const int* vals, const bool* active,
                                         const int* rows_local, const bool* rowflag,
                                         const int* edge_count, const int* levels, int mode,
                                         long long e, long long n, unsigned int* bits, int* ids,
                                         long long k, int* count_out, const int* deg_pad,
                                         int* deg_sum, int* scratch, long long scratch_ints,
                                         void* stream) {
  if (n < 0 || n > 0x7fffffffLL || e < 0 || k < 0 || !count_out || !scratch || !bits ||
      mode < K14_MARK_ACTIVE || mode > K14_MARK_UNVISITED ||
      (mode != K14_MARK_ACTIVE && !edge_count) || (mode == K14_MARK_UNVISITED && !levels) ||
      (deg_sum && !deg_pad))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nwords = (n + 31) / 32;
  if (nwords) {
    const cudaError_t z = cudaMemsetAsync(bits, 0, 4 * nwords, s);
    if (z != cudaSuccess) return (int)z;
  }
  if (e && n) {
    const unsigned int g = gt_blocks(e, K14_THREADS);
    if (mode == K14_MARK_ACTIVE)
      k14_mark<K14_MARK_ACTIVE><<<g, K14_THREADS, 0, s>>>(vals, active, nullptr, nullptr,
                                                           nullptr, nullptr, e, n, bits);
    else if (mode == K14_MARK_ROWS)
      k14_mark<K14_MARK_ROWS><<<g, K14_THREADS, 0, s>>>(vals, nullptr, rows_local, rowflag,
                                                         edge_count, nullptr, e, n, bits);
    else
      k14_mark<K14_MARK_UNVISITED><<<g, K14_THREADS, 0, s>>>(vals, nullptr, nullptr, nullptr,
                                                              edge_count, levels, e, n, bits);
  }
  K14Src src = {};
  src.bits = bits;
  return k14_compact_words<K14_SRC_BITMAP>(src, nullptr, n, ids, k, count_out, deg_pad, deg_sum,
                                           scratch, scratch_ints, s);
}

// The bucket mode: the v with bucket(dist[v]) == *k_at (gt_delta_bucket;
// dist [n] float32 or float64 by is_f64, inv_delta = 1 / delta in the run's
// type) and, where mask is not null, mask[v]; ids, count_out, deg_pad,
// deg_sum and scratch as in gt_frontier_compact_into.
GT_EXPORT int gt_frontier_compact_bucket(const void* dist, int is_f64, double inv_delta,
                                         const bool* mask, const int* k_at, long long n,
                                         int* ids, long long k, int* count_out,
                                         const int* deg_pad, int* deg_sum, int* scratch,
                                         long long scratch_ints, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k < 0 || !dist || !k_at || !count_out || !scratch ||
      (deg_sum && !deg_pad))
    return (int)cudaErrorInvalidValue;
  K14Src src = {};
  src.dist = dist;
  src.bmask = mask;
  src.inv = inv_delta;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return k14_compact_words<K14_SRC_BUCKET64>(src, k_at, n, ids, k, count_out, deg_pad, deg_sum,
                                               scratch, scratch_ints, s);
  return k14_compact_words<K14_SRC_BUCKET32>(src, k_at, n, ids, k, count_out, deg_pad, deg_sum,
                                             scratch, scratch_ints, s);
}
