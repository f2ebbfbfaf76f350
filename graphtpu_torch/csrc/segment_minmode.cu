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
// graphs), on every active-tier step (graphtpu/ops/active.py), per rank in
// the distributed slab and sort CDLP, and over the whole incidence in the
// one-device cdlp-impl=sort (graphtpu/algorithms/cdlp.py:85). The tie-break
// is LAGraph_cdlp.c:40-45's.
//
// Bound on an H100 (3.35 TB/s): bytes. neigh is read once (4 B an entry),
// indptr once, the labels once and 4 B written a segment: on the bench
// graph's 1,351 heavy rows (12.8M entries) about 55 MB, 0.017 ms. As in K2,
// one random 4 B label read per entry costs a 32 B sector of L2 or memory.
//
// Design: no host read; both launches are sized from the shapes (H, m) and
// walk work lists that the first one writes on the card. A segment is
// counted by a unit of its size, and no block reads more than K12_CHUNK
// (4,096) of one segment's entries, or of its (label, count) pairs:
//  * k12_warp_kernel: a warp per segment. A segment of at most 32 entries is
//    done in registers: each lane holds one label, __match_any_sync finds the
//    lanes of equal label, and the popcount of that mask is the label's
//    count; a warp max of (count << 32 | INT32_MAX - label) is the answer.
//    A longer segment is listed by its class: medium (up to med_len),
//    block (up to long_len) or long; a long one also gets its bins (about
//    K12_BIN pairs each, at most K12_MAX_BINS) and its chunks of K12_CHUNK
//    entries here.
//  * k12_grid_kernel, a persistent grid of 256-thread blocks, in phases:
//    1. a block per long chunk (fetched from a counter) counts it in a
//       shared-memory open-addressing table (hash_insert, csrc/minmode.cuh,
//       as K2's wide path does; 6,144 entries, 48 KB), writes the table's
//       (label, count) pairs into the chunk's own range of a scratch, and
//       adds their histogram by bin (a hash of the label independent of the
//       table's) to the segment's, one L2 atomic a bin. A hot label is then
//       one pair a chunk. (Identity mode takes each entry as a pair: ids
//       barely repeat there.) The block that finishes a segment's last
//       chunk lays its bins out over the segment's range and queues its
//       chunks.
//    2. a block per block-class segment (strided), counting it in the
//       shared table; 3. a warp per medium segment (strided), in a table of
//       its own (768 entries, 6 KB);
//    4. a block per queued chunk writes each pair into its bin (one L2
//       atomic per bin a chunk reserves its slots); the block that finishes
//       a segment's last chunk queues its bins;
//    5. a block per queued bin counts its pairs in the shared table and
//       merges its best packed key into the segment's by a 64-bit
//       atomicMax. Every pair of a label lies in one bin, so each bin's
//       counts are exact and the largest key over the bins is the segment's
//       min-mode; the block that counts a segment's last item writes its
//       label.
//    A block waits on a queue slot only for work that a running block has
//    taken from a counter (phases 1 and 4), so no wait depends on a block
//    that has not started.
//  * The fallback: a bin of more than K12_TABLE_LEN pairs (a hash that
//    overfills it, or a segment of more than K12_MAX_BINS x K12_BIN
//    entries) is counted in a global-memory table over the segment's own
//    range of the pair scratch (as many entries as the segment, which
//    phase 4 clears after reading its pairs), in queued chunks of
//    K12_CHUNK pairs, a block each; the header counts such bins and chunks.
//    Only there does a long segment pay an L2 atomic per pair.
// Counts are exact everywhere, so the atomics leave the result
// deterministic.
#include "minmode.cuh"

#define K12_WARPS 8          // segments a block of the warp kernel
#define K12_WARP_LEN 32      // longest segment a warp counts in registers
#define K12_THREADS 256      // threads of a block of the grid kernel
#define K12_TWARPS (K12_THREADS / 32)
#define K12_UNROLL 4         // entries a thread loads before it counts them
#define K12_TABLE_LEN 4096   // most entries or pairs one shared table counts
#define K12_TABLE (K12_TABLE_LEN + K12_TABLE_LEN / 2)
#define K12_MED_MAX 512      // longest segment a warp counts in its own table
#define K12_MED_TABLE (K12_MED_MAX + K12_MED_MAX / 2)  // x 2 ints x 8 warps = 48 KB
#define K12_CHUNK 4096       // entries (or pairs) of one segment a block takes
#define K12_PER (K12_CHUNK / K12_THREADS)
#define K12_BIN 2048         // a long segment's entries a bin, at most, on average
#define K12_MAX_BINS 1024    // bins of one segment
// the shared table, then a segment's bin histogram (a chunk's counts and
// slots in phase 4)
#define K12_SMEM_BYTES ((2 * K12_TABLE + K12_MAX_BINS) * (int)sizeof(int))  // 52 KB
#define K12_HDR 16           // header ints of the scratch
#define K12_SPIN_LIMIT (1ll << 24)  // polls of a queue slot before the kernel traps
#define K12_MAX_DEVICES 64

// header: the work lists' lengths and the fallback's work (K12_WORK in
// ops/minmode.py reads the first seven), then the grid kernel's counters
enum { K12_H_MED, K12_H_BLOCK, K12_H_LONG, K12_H_BINS, K12_H_CHUNKS, K12_H_FB_CHUNKS,
       K12_H_FB_BINS, K12_H_NEXT_HIST, K12_H_QS_TAIL, K12_H_QS_HEAD, K12_H_QB_TAIL,
       K12_H_QB_HEAD, K12_H_SEGS_QUEUED };

// The scratch, carved from one int32 buffer the wrapper allocates with a
// size computed from (H, m) alone (gt_segment_minmode_scratch_ints).
struct K12Layout {
  int* hdr;
  int* qs;    // [nch] the chunk queue of phase 4: chunk + 1, 0 = not yet queued
  int* qb;    // [nq] the bin queue of phase 5: bin + 1, or -(bin + 1) for a
              // fallback chunk; 0 = not yet queued
  int* qbj;   // [nq] a fallback chunk's index in its bin
  unsigned long long* best;  // [nl] a long segment's best packed key
  int* med;                  // [h] medium segments
  int* blk;                  // [h] block-class segments
  // [nl] per long segment: its id, bins, first bin, first chunk, chunks not
  // yet counted (phase 1) and not yet binned (phase 4), bin-queue items not
  // yet counted, and whether a bin takes the fallback
  int *lseg, *lnb, *lbin, *lchunk, *lleft, *lleft2, *lremain, *lover;
  // [nbin] per bin: its long segment, pairs, start, slot cursor, and its
  // first item among its segment's bin-queue items
  int *bseg, *bsize, *bstart, *bcur, *bitem;
  int* chunk;   // [nch] a long chunk's segment
  int* npairs;  // [nch] a long chunk's pairs
  int *plab, *pcnt;  // [m] each: the chunks' pairs, at their entries' positions
  int *blab, *bcnt;  // [m] each: the pairs by bin
};

// Carves the layout from base (null: only sizes it); returns its ints and
// sets *zeroed to the ints at its start that a call must zero first.
static long long k12_layout(int* base, int h, long long m, int long_len, K12Layout* L,
                            long long* zeroed) {
  const long long nl = long_len < m ? (m / (long_len + 1) < h ? m / (long_len + 1) : h) : 0;
  const long long nbin = nl ? m / K12_BIN + nl : 0, nch = nl ? m / K12_CHUNK + nl : 0;
  // bins, and fallback chunks: a fallback bin holds more than K12_TABLE_LEN pairs
  const long long nq = nl ? nbin + m / K12_CHUNK + m / (K12_TABLE_LEN + 1) + 1 : 0;
  long long off = 0;
  auto take = [&](long long n) {
    int* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  L->hdr = take(K12_HDR);
  L->qs = take(nch);
  L->qb = take(nq);
  *zeroed = off;
  L->qbj = take(nq);
  off += off & 1;  // 8-byte alignment
  L->best = (unsigned long long*)take(2 * nl);
  L->med = take(h);
  L->blk = take(h);
  int** per_long[] = {&L->lseg, &L->lnb, &L->lbin, &L->lchunk, &L->lleft, &L->lleft2,
                      &L->lremain, &L->lover};
  for (int** p : per_long) *p = take(nl);
  int** per_bin[] = {&L->bseg, &L->bsize, &L->bstart, &L->bcur, &L->bitem};
  for (int** p : per_bin) *p = take(nbin);
  L->chunk = take(nch);
  L->npairs = take(nch);
  int** per_entry[] = {&L->plab, &L->pcnt, &L->blab, &L->bcnt};
  for (int** p : per_entry) *p = take(nl ? m : 0);
  return off;
}

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

// A label's bin among nb, by a hash independent of hash_insert's.
__device__ __forceinline__ int k12_bin_of(int v, int nb) {
  unsigned int x = (unsigned int)v;
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return (int)__umulhi(x, (unsigned int)nb);
}

// A counting table of `size` entries: hash_insert's two int arrays
// (csrc/minmode.cuh), in shared memory or, for the fallback, in global.
struct K12Table {
  int *keys, *cnts;
  int size;
  __device__ void clear(long long i) const {
    keys[i] = GT_EMPTY;
    cnts[i] = 0;
  }
  __device__ unsigned long long insert(int label, int add) const {
    return hash_insert(keys, cnts, size, label, add);
  }
};

// A table of n entries carved from the ints at base.
__device__ __forceinline__ K12Table k12_table(int* base, int n) { return {base, base + n, n}; }

__global__ void __launch_bounds__(K12_WARPS * 32)
k12_warp_kernel(const int* __restrict__ labels, const int* __restrict__ neigh,
                const int* __restrict__ indptr, int h, long long m, long long bound,
                int* __restrict__ out, K12Layout L, int med_len, int long_len) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * K12_WARPS + (threadIdx.x >> 5);
  if (s >= h) return;  // warp-uniform
  long long lo, hi;
  k12_segment(indptr, s, m, lo, hi);
  const long long len = hi - lo;
  if (len <= K12_WARP_LEN) {
    const int v = lo + lane < hi ? k12_label(neigh, labels, lo + lane, bound)
                                 : GT_INT32_INF;
    const unsigned int peers = __match_any_sync(0xffffffffu, v);
    unsigned long long key = 0;
    if (v != GT_INT32_INF)
      key = ((unsigned long long)__popc(peers) << 32) |
            ((unsigned int)GT_INT32_INF - (unsigned int)v);
    key = warp_max_u64(key);
    if (lane == 0) out[s] = gt_minmode_label(key);
    return;
  }
  if (len <= long_len) {
    if (lane == 0) {
      if (len <= med_len)
        L.med[atomicAdd(L.hdr + K12_H_MED, 1)] = (int)s;
      else
        L.blk[atomicAdd(L.hdr + K12_H_BLOCK, 1)] = (int)s;
    }
    return;
  }
  // a long segment: its bins and chunks
  const int nb = (int)min((len + K12_BIN - 1) / K12_BIN, (long long)K12_MAX_BINS);
  const int nc = (int)((len + K12_CHUNK - 1) / K12_CHUNK);
  int li = 0, bb = 0, cb = 0;
  if (lane == 0) {
    li = atomicAdd(L.hdr + K12_H_LONG, 1);
    bb = atomicAdd(L.hdr + K12_H_BINS, nb);
    cb = atomicAdd(L.hdr + K12_H_CHUNKS, nc);
    L.lseg[li] = (int)s;
    L.lnb[li] = nb;
    L.lbin[li] = bb;
    L.lchunk[li] = cb;
    L.lleft[li] = nc;
    L.lleft2[li] = nc;
    L.best[li] = 0;
  }
  li = __shfl_sync(0xffffffffu, li, 0);
  bb = __shfl_sync(0xffffffffu, bb, 0);
  cb = __shfl_sync(0xffffffffu, cb, 0);
  for (int b = lane; b < nb; b += 32) {
    L.bseg[bb + b] = li;
    L.bsize[bb + b] = 0;
  }
  for (int j = lane; j < nc; j += 32) L.chunk[cb + j] = li;
}

// Clears a table, block-wide.
__device__ __forceinline__ void k12_clear(const K12Table& t) {
  for (long long i = threadIdx.x; i < t.size; i += K12_THREADS) t.clear(i);
}

// Entries [lo, hi) counted by the whole block into table t; returns this
// thread's best packed key. Block-uniform loop.
__device__ __forceinline__ unsigned long long k12_block_insert(
    const int* __restrict__ neigh, const int* __restrict__ labels, long long lo,
    long long hi, long long bound, const K12Table& t) {
  const int lane = threadIdx.x & 31;
  unsigned long long best = 0;
  for (long long w0 = lo; w0 < hi; w0 += K12_THREADS * K12_UNROLL) {
    int lab[K12_UNROLL];
#pragma unroll
    for (int u = 0; u < K12_UNROLL; ++u) {
      const long long pos = w0 + u * K12_THREADS + threadIdx.x;
      lab[u] = pos < hi ? k12_label(neigh, labels, pos, bound) : GT_INT32_INF;
    }
#pragma unroll
    for (int u = 0; u < K12_UNROLL; ++u) {
      const int v = lab[u];
      const unsigned int peers = __match_any_sync(0xffffffffu, v);
      if (v != GT_INT32_INF && __ffs(peers) - 1 == lane)
        best = max(best, t.insert(v, __popc(peers)));
    }
  }
  return best;
}

// Pairs [lo, hi) of (plab, pcnt), written earlier in this launch, counted by
// the whole block into table t; returns this thread's best packed key.
__device__ __forceinline__ unsigned long long k12_pair_insert(
    const int* plab, const int* pcnt, long long lo, long long hi, const K12Table& t) {
  unsigned long long best = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += K12_THREADS)
    best = max(best, t.insert(__ldcg(plab + i), __ldcg(pcnt + i)));
  return best;
}

// The block max of the threads' keys, valid at thread 0.
__device__ __forceinline__ unsigned long long k12_block_max(unsigned long long best,
                                                            unsigned long long* wbest) {
  best = warp_max_u64(best);
  if ((threadIdx.x & 31) == 0) wbest[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 1; j < K12_TWARPS; ++j) best = max(best, wbest[j]);
  return best;
}

// Thread 0: the next index of a block-wide counter, to every thread.
__device__ __forceinline__ int k12_fetch(int* counter, int* sval) {
  if (threadIdx.x == 0) *sval = atomicAdd(counter, 1);
  __syncthreads();
  const int v = *sval;
  __syncthreads();
  return v;
}

// Thread 0: waits until queue slot i holds an item and returns it. Where
// `tail` is given (the slots reserved so far), slot i is read only below
// it, and 0 is returned once *done reaches `all` with i past *tail (no item
// will come); without it, every slot i up to the queue's length fills.
__device__ int k12_wait(const int* q, int i, const int* done, int all, const int* tail) {
  for (long long spins = 0;; ++spins) {
    if (tail == nullptr || i < *(const volatile int*)tail) {
      const int v = *(const volatile int*)(q + i);
      if (v != 0) {
        __threadfence();
        return v;
      }
    } else if (*(const volatile int*)done == all) {
      __threadfence();
      if (i >= *(const volatile int*)tail) return 0;
    }
    if (spins > K12_SPIN_LIMIT) __trap();  // a queue that never fills: fail, never hang
    __nanosleep(100);
  }
}

// Block exclusive scans of two per-thread values; returns the prefixes in
// a, b and the totals in ta, tb (every thread).
__device__ __forceinline__ void k12_scan2(int& a, int& b, int& ta, int& tb) {
  __shared__ int wsum[2][K12_TWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, off);
    const int xb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = ia;
    wsum[1][warp] = ib;
  }
  __syncthreads();
  int pa = ia - a, pb = ib - b;
  ta = tb = 0;
  for (int w = 0; w < K12_TWARPS; ++w) {
    if (w < warp) {
      pa += wsum[0][w];
      pb += wsum[1][w];
    }
    ta += wsum[0][w];
    tb += wsum[1][w];
  }
  a = pa;
  b = pb;
  __syncthreads();
}

// Bin-queue items of a bin of `size` pairs: one, or its fallback chunks.
__device__ __forceinline__ int k12_bin_items(int size) {
  return size > K12_TABLE_LEN ? (size + K12_CHUNK - 1) / K12_CHUNK : 1;
}

// Phase 1's last block of long segment li: lays its nb bins out over the
// pair positions from lo, counts the fallback's bins and chunks, sets the
// bin-queue items the segment waits for, and queues its chunks for
// phase 4. Block-uniform.
__device__ void k12_plan(int li, long long lo, long long hi, int nb, int bb,
                         const K12Layout& L, int* sint) {
  const int per = (nb + K12_THREADS - 1) / K12_THREADS;
  const int b0 = min((int)threadIdx.x * per, nb), b1 = min(b0 + per, nb);
  int start = 0, item = 0, total_pairs, total_items;
  for (int b = b0; b < b1; ++b) {
    const int size = __ldcg(L.bsize + bb + b);
    start += size;
    item += k12_bin_items(size);
  }
  k12_scan2(start, item, total_pairs, total_items);
  start += (int)lo;
  int over = 0;
  for (int b = b0; b < b1; ++b) {
    const int k = bb + b, size = __ldcg(L.bsize + k);
    L.bstart[k] = start;
    L.bcur[k] = start;
    L.bitem[k] = item;
    if (size > K12_TABLE_LEN) {
      atomicAdd(L.hdr + K12_H_FB_BINS, 1);
      atomicAdd(L.hdr + K12_H_FB_CHUNKS, k12_bin_items(size));
      over = 1;
    }
    start += size;
    item += k12_bin_items(size);
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    L.lremain[li] = total_items;
    L.lover[li] = over;
  }
  __threadfence();
  __syncthreads();
  const int nc = (int)((hi - lo + K12_CHUNK - 1) / K12_CHUNK), cb = L.lchunk[li];
  if (threadIdx.x == 0) sint[2] = atomicAdd(L.hdr + K12_H_QS_TAIL, nc);
  __syncthreads();
  for (int j = threadIdx.x; j < nc; j += K12_THREADS)
    ((volatile int*)L.qs)[sint[2] + j] = cb + j + 1;
}

// Appends the pairs (v, n) of a warp's lanes that hold one (has) to the
// chunk's pairs from p0, counting them in the bin histogram shist of nb
// bins; *count is the chunk's pairs so far. Warp-uniform.
__device__ __forceinline__ void k12_emit(bool has, int v, int n, int nb, long long p0,
                                         const K12Layout& L, int* shist, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned int mask = __ballot_sync(0xffffffffu, has);
  int base = 0;
  if (lane == 0 && mask != 0) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  const int b = has ? k12_bin_of(v, nb) : -1;
  const unsigned int peers = __match_any_sync(0xffffffffu, b);
  if (has) {
    const long long q = p0 + base + __popc(mask & ((1u << lane) - 1));
    L.plab[q] = v;
    L.pcnt[q] = n;
    if (__ffs(peers) - 1 == lane) atomicAdd(shist + b, __popc(peers));
  }
}

// Phase 1: long chunk c as (label, count) pairs at the chunk's own
// positions of (plab, pcnt), their bins counted into the segment's
// histogram. In gather mode the chunk is counted in the shared table first
// (a CDLP step's labels repeat, a hot one across a whole row); in identity
// mode each entry is its own pair (an id repeats at most once in a
// directed graph's incidence, for the two directions of an edge; a stream
// whose ids repeat more stays exact, through the fallback's bins).
__device__ void k12_count_chunk(int c, const int* __restrict__ labels,
                                const int* __restrict__ neigh,
                                const int* __restrict__ indptr, long long m, long long bound,
                                const K12Layout& L, int* sm, int* sint) {
  const K12Table table = k12_table(sm, K12_TABLE);
  int* shist = sm + 2 * K12_TABLE;
  const int tid = threadIdx.x;
  const int li = L.chunk[c];
  long long lo, hi;
  k12_segment(indptr, L.lseg[li], m, lo, hi);
  const int nb = L.lnb[li], bb = L.lbin[li];
  const long long p0 = lo + (long long)(c - L.lchunk[li]) * K12_CHUNK;
  const long long p1 = min(p0 + K12_CHUNK, hi);
  if (labels != nullptr) k12_clear(table);
  for (int b = tid; b < nb; b += K12_THREADS) shist[b] = 0;
  if (tid == 0) sint[0] = 0;
  __syncthreads();
  if (labels != nullptr) {
    k12_block_insert(neigh, labels, p0, p1, bound, table);
    __syncthreads();
    for (int t = tid; t < K12_TABLE; t += K12_THREADS) {  // K12_TABLE: a multiple of the block
      const int key = table.keys[t];
      k12_emit(key != GT_EMPTY, key, table.cnts[t], nb, p0, L, shist, sint);
    }
  } else {
    int v[K12_PER];
#pragma unroll
    for (int u = 0; u < K12_PER; ++u) {
      const long long pos = p0 + u * K12_THREADS + tid;
      v[u] = pos < p1 ? k12_label(neigh, nullptr, pos, bound) : GT_INT32_INF;
    }
#pragma unroll
    for (int u = 0; u < K12_PER; ++u)
      k12_emit(v[u] != GT_INT32_INF, v[u], 1, nb, p0, L, shist, sint);
  }
  __syncthreads();
  if (tid == 0) L.npairs[c] = sint[0];
  for (int b = tid; b < nb; b += K12_THREADS) {
    const int k = shist[b];
    if (k) atomicAdd(L.bsize + bb + b, k);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sint[1] = atomicSub(L.lleft + li, 1) == 1;
  __syncthreads();
  if (sint[1]) {  // every chunk of the segment is histogrammed
    __threadfence();
    k12_plan(li, lo, hi, nb, bb, L, sint);
  }
  __syncthreads();
}

// Phase 4's last block of long segment li queues its bins (each bin, or
// each fallback chunk of a bin past the shared table) for phase 5.
__device__ void k12_queue_bins(int li, int nb, int bb, const K12Layout& L, int* sint) {
  if (threadIdx.x == 0) sint[2] = atomicAdd(L.hdr + K12_H_QB_TAIL, __ldcg(L.lremain + li));
  __syncthreads();
  const int pos = sint[2];
  for (int b = threadIdx.x; b < nb; b += K12_THREADS) {
    const int k = bb + b, size = __ldcg(L.bsize + k), at = pos + __ldcg(L.bitem + k);
    const int n = k12_bin_items(size);
    for (int j = 0; j < n; ++j) {
      L.qbj[at + j] = j;
      __threadfence();
      ((volatile int*)L.qb)[at + j] = size > K12_TABLE_LEN ? -(k + 1) : k + 1;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(L.hdr + K12_H_SEGS_QUEUED, 1);
}

// Phase 4: the pairs of long chunk c written into their bins.
__device__ void k12_bin_chunk(int c, const int* __restrict__ indptr, long long m,
                              const K12Layout& L, int* sm, int* sint) {
  int *scount = sm, *sbase = sm + K12_MAX_BINS;
  const int tid = threadIdx.x, lane = tid & 31;
  const int li = L.chunk[c];
  long long lo, hi;
  k12_segment(indptr, L.lseg[li], m, lo, hi);
  const int nb = L.lnb[li], bb = L.lbin[li], n = __ldcg(L.npairs + c);
  const long long p0 = lo + (long long)(c - L.lchunk[li]) * K12_CHUNK;
  const long long p1 = min(p0 + K12_CHUNK, hi);
  for (int b = tid; b < nb; b += K12_THREADS) scount[b] = 0;
  __syncthreads();
  int r[K12_PER];
#pragma unroll
  for (int u = 0; u < K12_PER; ++u) {  // a slot in its bin, a warp's equal bins at once
    const int i = u * K12_THREADS + tid;
    const int b = i < n ? k12_bin_of(__ldcg(L.plab + p0 + i), nb) : -1;
    const unsigned int peers = __match_any_sync(0xffffffffu, b);
    const int leader = __ffs(peers) - 1;
    int old = 0;
    if (b >= 0 && lane == leader) old = atomicAdd(scount + b, __popc(peers));
    r[u] = __shfl_sync(0xffffffffu, old, leader) + __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();
  for (int b = tid; b < nb; b += K12_THREADS) {
    const int k = scount[b];
    if (k) sbase[b] = atomicAdd(L.bcur + bb + b, k);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < K12_PER; ++u) {
    const int i = u * K12_THREADS + tid;
    if (i < n) {
      const int v = __ldcg(L.plab + p0 + i), q = sbase[k12_bin_of(v, nb)] + r[u];
      L.blab[q] = v;
      L.bcnt[q] = __ldcg(L.pcnt + p0 + i);
    }
  }
  if (__ldcg(L.lover + li)) {  // the segment's pair range becomes its fallback table
    __syncthreads();
    for (long long i = p0 + tid; i < p1; i += K12_THREADS) {
      L.plab[i] = GT_EMPTY;
      L.pcnt[i] = 0;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sint[1] = atomicSub(L.lleft2 + li, 1) == 1;
  __syncthreads();
  if (sint[1]) {  // every chunk of the segment is binned
    __threadfence();
    k12_queue_bins(li, nb, bb, L, sint);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(K12_THREADS)
k12_grid_kernel(const int* __restrict__ labels, const int* __restrict__ neigh,
                const int* __restrict__ indptr, long long m, long long bound,
                int* __restrict__ out, K12Layout L) {
  extern __shared__ int sm[];
  __shared__ unsigned long long wbest[K12_TWARPS];
  __shared__ int sint[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nchunk = L.hdr[K12_H_CHUNKS], nblk = L.hdr[K12_H_BLOCK];
  const int nmed = L.hdr[K12_H_MED], nlong = L.hdr[K12_H_LONG];
  // 1. long chunks, from a counter
  if (nchunk > 0)
    for (int c; (c = k12_fetch(L.hdr + K12_H_NEXT_HIST, sint + 7)) < nchunk;)
      k12_count_chunk(c, labels, neigh, indptr, m, bound, L, sm, sint);
  // 2. a block per block-class segment
  for (int i = blockIdx.x; i < nblk; i += gridDim.x) {
    const long long s = L.blk[i];
    long long lo, hi;
    k12_segment(indptr, s, m, lo, hi);
    const K12Table table = k12_table(sm, (int)((hi - lo) + (hi - lo) / 2));
    k12_clear(table);
    __syncthreads();
    unsigned long long best = k12_block_insert(neigh, labels, lo, hi, bound, table);
    best = k12_block_max(best, wbest);
    if (tid == 0) out[s] = gt_minmode_label(best);
    __syncthreads();
  }
  // 3. a warp per medium segment, in its own part of the shared memory
  if (nmed > 0) {
    int* base = sm + warp * 2 * K12_MED_TABLE;
    for (long long i = (long long)blockIdx.x * K12_TWARPS + warp; i < nmed;
         i += (long long)gridDim.x * K12_TWARPS) {  // warp-uniform
      const long long s = L.med[i];
      long long lo, hi;
      k12_segment(indptr, s, m, lo, hi);
      const K12Table table = k12_table(base, (int)((hi - lo) + (hi - lo) / 2));
      for (int j = lane; j < table.size; j += 32) table.clear(j);
      __syncwarp();
      unsigned long long best = 0;
      for (long long w0 = lo; w0 < hi; w0 += 32 * K12_UNROLL) {
        int lab[K12_UNROLL];
#pragma unroll
        for (int u = 0; u < K12_UNROLL; ++u) {
          const long long pos = w0 + u * 32 + lane;
          lab[u] = pos < hi ? k12_label(neigh, labels, pos, bound) : GT_INT32_INF;
        }
#pragma unroll
        for (int u = 0; u < K12_UNROLL; ++u) {
          const int v = lab[u];
          const unsigned int peers = __match_any_sync(0xffffffffu, v);
          if (v != GT_INT32_INF && __ffs(peers) - 1 == lane)
            best = max(best, table.insert(v, __popc(peers)));
        }
      }
      best = warp_max_u64(best);
      if (lane == 0) out[s] = gt_minmode_label(best);
      __syncwarp();
    }
    __syncthreads();
  }
  if (nchunk == 0) return;  // block-uniform: no long segment
  // 4. the queued chunks' pairs into their bins
  for (int i; (i = k12_fetch(L.hdr + K12_H_QS_HEAD, sint + 7)) < nchunk;) {
    if (tid == 0) sint[6] = k12_wait(L.qs, i, nullptr, 0, nullptr) - 1;
    __syncthreads();
    k12_bin_chunk(sint[6], indptr, m, L, sm, sint);
  }
  // 5. the queued bins, and the fallback's chunks
  for (;;) {
    if (tid == 0) {
      const int i = atomicAdd(L.hdr + K12_H_QB_HEAD, 1);
      const int v = k12_wait(L.qb, i, L.hdr + K12_H_SEGS_QUEUED, nlong, L.hdr + K12_H_QB_TAIL);
      sint[6] = v;
      sint[7] = v < 0 ? __ldcg(L.qbj + i) : 0;
    }
    __syncthreads();
    const int v = sint[6];
    if (v == 0) break;  // block-uniform
    const int k = (v > 0 ? v : -v) - 1, li = L.bseg[k];
    const long long start = __ldcg(L.bstart + k), size = __ldcg(L.bsize + k);
    unsigned long long best;
    if (v > 0) {  // a bin, in the shared table
      const K12Table table = k12_table(sm, (int)(size + size / 2));
      k12_clear(table);
      __syncthreads();
      best = k12_pair_insert(L.blab, L.bcnt, start, start + size, table);
    } else {  // a fallback chunk, in the segment's global-memory table
      long long lo, hi;
      k12_segment(indptr, L.lseg[li], m, lo, hi);
      const long long p0 = start + (long long)sint[7] * K12_CHUNK;
      const K12Table table{L.plab + lo, L.pcnt + lo, (int)(hi - lo)};
      best = k12_pair_insert(L.blab, L.bcnt, p0, min(p0 + K12_CHUNK, start + size), table);
    }
    best = k12_block_max(best, wbest);
    if (tid == 0) {
      atomicMax(L.best + li, best);
      __threadfence();
      if (atomicSub(L.lremain + li, 1) == 1) {  // the segment's last item
        __threadfence();
        out[L.lseg[li]] = gt_minmode_label(atomicAdd(L.best + li, 0ull));
      }
    }
    __syncthreads();
  }
}

// The persistent grid of the grid kernel on the current device: as many
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
  rc = cudaFuncSetAttribute(k12_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            K12_SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k12_grid_kernel, K12_THREADS,
                                                     K12_SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev < K12_MAX_DEVICES) cached[dev] = *grid;
  return 0;
}

// Both entry points take the same arguments: labels (null = identity
// mode), neigh [m], indptr [h+1], out [h], the scratch and its size in
// ints, and the class bounds: a segment of up to med_len entries is counted
// by a warp's table, up to long_len by a block's, a longer one by bins
// (K12_WARP_LEN <= med_len <= K12_MED_MAX, med_len <= long_len <=
// K12_TABLE_LEN). The warp launch runs first; the grid launch only where
// m > K12_WARP_LEN. Every caller in the package passes the same two bounds
// (ops/minmode.py K12_MED_LEN, K12_SMEM_LEN); they are arguments only so
// that tools/minmode_times.py --classes can time one class under each unit
// in one build.
#define K12_ARGS                                                                \
  const int *labels, const int *neigh, const int *indptr, int h, long long m,   \
      long long bound, int *out, int *scratch, long long scratch_ints,          \
      int med_len, int long_len, void *stream

static int k12_prepare(int h, long long m, int* scratch, long long scratch_ints, int med_len,
                       int long_len, K12Layout* L, long long* zeroed) {
  if (h < 0 || m < 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (med_len < K12_WARP_LEN || med_len > K12_MED_MAX || long_len < med_len ||
      long_len > K12_TABLE_LEN)
    return (int)cudaErrorInvalidValue;
  if (k12_layout(scratch, h, m, long_len, L, zeroed) > scratch_ints)
    return (int)cudaErrorInvalidValue;
  return 0;
}

GT_EXPORT long long gt_segment_minmode_scratch_ints(int h, long long m, int long_len) {
  K12Layout L;
  long long zeroed = 0;
  return k12_layout(nullptr, h, m, long_len, &L, &zeroed);
}

GT_EXPORT int gt_segment_minmode_warp(K12_ARGS) {
  K12Layout L;
  long long zeroed = 0;
  int rc = k12_prepare(h, m, scratch, scratch_ints, med_len, long_len, &L, &zeroed);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(L.hdr, 0, zeroed * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (h == 0) return (int)cudaGetLastError();
  k12_warp_kernel<<<gt_blocks(h, K12_WARPS), K12_WARPS * 32, 0, s>>>(
      labels, neigh, indptr, h, m, bound, out, L, med_len, long_len);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_segment_minmode_grid(K12_ARGS) {
  K12Layout L;
  long long zeroed = 0;
  int rc = k12_prepare(h, m, scratch, scratch_ints, med_len, long_len, &L, &zeroed);
  int grid = 0;
  if (rc == 0) rc = k12_grid(&grid);
  if (rc != 0) return rc;
  k12_grid_kernel<<<grid, K12_THREADS, K12_SMEM_BYTES, (cudaStream_t)stream>>>(
      labels, neigh, indptr, m, bound, out, L);
  return (int)cudaGetLastError();
}
