// K2 slab_minmode: for each column r of a transposed [W, R] int32 slab
// (-1 = pad), the smallest label among the most frequent of lab[0..W), with
//   mode 0 (gather):   lab[w] = labels[slab[w, r]]   a full CDLP step
//   mode 1 (identity): lab[w] = slab[w, r]           iteration 0, labels = ids
//   mode 2 (min):      the minimum of slab[w, r]     iteration 0, no duplicates
// and INT32_INF for a column without entries. Slab ids outside [0, bound)
// count as pad, and so does a gathered label of INT32_INF.
//
// Replaces graphtpu/ops/minmode.py:49-70 (_slab_minmode and
// _rowwise_minmode: an XLA sort along the slab axis, cummax run lengths and
// two masked reductions) and the bucket bodies of _iter0_mode (:171-189) and
// _iter0_minmode (:154-168). The tie-break is LAGraph_cdlp.c:40-45's.
//
// Bound on an H100 (3.35 TB/s): bytes, not operations. The slab is read
// once, 4 B per stored slot, the labels (4 B per vertex) once, and 4 B per
// row are written: on the CDLP plan of RMAT scale 20, edge factor 32
// (53,769,647 slots in 10 buckets, 1,048,576 labels, 737,858 rows) that is
// 222 MB or 0.066 ms a step. What a step can reach is set by the label
// gather: one random 4 B read per slot costs a 32 B sector of L2. A bare
// gather of the same ids (K1 gather_rows, C=1, which also writes 4 B per
// slot) takes 0.277 ms over the ten buckets; this kernel takes 0.35 ms, the
// earlier one 2.64 ms (PERF.md has the table per bucket).
//
// What the earlier design (a block per row of a wide bucket, a bitonic sort
// in shared memory) lost, and what this one does about it:
//  1. It read wide buckets with a stride of R: 4 useful bytes per 32 B
//     sector. A block cannot take a tile of many neighbouring rows of a wide
//     bucket instead, because the rows' tables do not fit: at W = 2668 two
//     rows fill 64 KB, and tiles of 2 to 8 rows (8 to 32 contiguous bytes per
//     w) measured 2 to 3 times slower than tiles of 32. So the wide buckets
//     are read from a row-major copy [R, W], made once with the plan's table
//     (4 B more per wide slot): a row's W ids are contiguous and a warp
//     reads 128 B at a time, whatever R and W are; no alignment is asked.
//  2. It sorted where a count does: each row has an open-addressing table of
//     (label, count) in shared memory and every label is inserted once. With
//     the inserts taken out the kernel is 5 % faster: counting is not what
//     the time goes to, the gather is.
//  3. It padded W to a power of two: the table has W + W/2 entries, and
//     every loop runs to W.
//  4. It launched a grid per bucket, a block per row: one launch now serves
//     every wide bucket of a plan (a table of bucket descriptors, common.cuh;
//     each block finds its bucket), one more the narrow ones, and a block
//     holds up to 16 rows. The widest buckets' blocks come first.
//
// Design.
//  * W <= 32: one thread per row of the [W, R] slab, lanes along r
//    (coalesced). The labels live in registers, padded with INT32_INF to a
//    power of two, and are sorted by a fully unrolled bitonic network; one
//    pass keeps the first of the longest runs. Measured at the gather floor
//    bucket by bucket, so it stays a sort.
//  * W in (32, 4096]: a group of G threads per row of the row-major copy, G
//    a power of two from 32 (a warp) to 512 (the block) with about four slots
//    a thread, 512 / G rows a block. Each thread starts four slab loads, then
//    their four label gathers, then counts; the first round's loads are in
//    flight while the tables are cleared, each later round's while the round
//    before it is counted. A label is inserted with
//    atomicCAS on the key and atomicAdd on the count; the value the add
//    returns is the label's running count, so the largest
//    (count << 32 | INT32_MAX - label) over all inserts is the answer: the
//    last insert of the most frequent label carries its full count, and among
//    equal counts the smaller label packs larger. That holds in any insertion
//    order, and no pass over the table is needed. The lanes of a warp share a
//    row: lanes with the same label are found by __match_any_sync and their
//    lowest lane inserts for all of them, so a row of equal labels does not
//    serialize on one shared-memory word (without it the kernel is 1.6 to 2
//    times slower). Pads never enter a table; INT32_INF marks an empty entry.
//    Tables take at most 48 KB a block (W = 4096: 6144 entries of 8 B).
//  * mode 2 takes the same kernels without the sort or the tables.
#include "common.cuh"

#define GT_MODE_GATHER 0
#define GT_MODE_IDENTITY 1
#define GT_MODE_MIN 2
#define GT_SMALL_W 32
#define GT_MAX_W 4096
#define GT_SMALL_THREADS 128
#define GT_WIDE_THREADS 512
#define GT_WIDE_UNROLL 4
#define GT_WIDE_SLOTS 4  // a row is shared by more threads while each keeps this many slots
#define GT_EMPTY GT_INT32_INF

__device__ __forceinline__ int load_label(const int* __restrict__ slab,
                                          const int* __restrict__ labels,
                                          long long pos, long long bound,
                                          int mode) {
  int s = slab[pos];
  if (s < 0 || (long long)s >= bound) return GT_INT32_INF;
  return mode == GT_MODE_GATHER ? __ldg(labels + s) : s;
}

template <int P>
__device__ __forceinline__ void bitonic_sort_regs(int (&v)[P]) {
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int a = v[i], b = v[l];
          if ((a > b) == ((i & k) == 0)) {
            v[i] = b;
            v[l] = a;
          }
        }
      }
    }
  }
}

// One row in registers: the min-mode (or the minimum) of its w <= P labels.
template <int P>
__device__ __forceinline__ int minmode_regs(const int* __restrict__ slab,
                                            const int* __restrict__ labels,
                                            int w, long long R, long long r,
                                            long long bound, int mode) {
  int v[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    v[i] = i < w ? load_label(slab, labels, i * R + r, bound, mode)
                 : GT_INT32_INF;
  int best = GT_INT32_INF;
  if (mode == GT_MODE_MIN) {
#pragma unroll
    for (int i = 0; i < P; ++i) best = min(best, v[i]);
  } else {
    bitonic_sort_regs<P>(v);
    int best_count = 0, run = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      // neighbour indices are masked into range; the guards decide
      run = (i > 0 && v[i] == v[(i + P - 1) & (P - 1)]) ? run + 1 : 1;
      const bool last = i + 1 == P || v[i] != v[(i + 1) & (P - 1)];
      if (last && v[i] != GT_INT32_INF && run > best_count) {
        best_count = run;
        best = v[i];
      }
    }
  }
  return best;
}

// Buckets of W <= 32: one thread per row, GT_SMALL_THREADS rows a block.
__global__ void __launch_bounds__(GT_SMALL_THREADS)
minmode_small_kernel(const __grid_constant__ GtTable t,
                     const int* __restrict__ labels, int* __restrict__ out,
                     long long bound, int mode) {
  const int k = gt_find_bucket(t);
  const long long R = t.b[k].R;
  const long long r =
      (blockIdx.x - t.first_block[k]) * (long long)GT_SMALL_THREADS + threadIdx.x;
  if (r >= R) return;
  const int* __restrict__ slab = t.b[k].slab;
  const int w = t.b[k].W;
  int best;
  if (w <= 1) best = minmode_regs<1>(slab, labels, w, R, r, bound, mode);
  else if (w <= 2) best = minmode_regs<2>(slab, labels, w, R, r, bound, mode);
  else if (w <= 4) best = minmode_regs<4>(slab, labels, w, R, r, bound, mode);
  else if (w <= 8) best = minmode_regs<8>(slab, labels, w, R, r, bound, mode);
  else if (w <= 16) best = minmode_regs<16>(slab, labels, w, R, r, bound, mode);
  else best = minmode_regs<32>(slab, labels, w, R, r, bound, mode);
  out[t.b[k].out_off + r] = best;
}

// Counts `add` more of `label` in a row's table; returns the packed key
// (running count << 32 | INT32_MAX - label): larger is better.
__device__ __forceinline__ unsigned long long hash_insert(int* keys, int* cnts,
                                                          int size, int label,
                                                          int add) {
  int idx = (int)__umulhi((unsigned int)label * 2654435761u, (unsigned int)size);
  for (;;) {
    const int prev = atomicCAS(keys + idx, GT_EMPTY, label);
    if (prev == GT_EMPTY || prev == label) break;
    if (++idx == size) idx = 0;  // size > W >= distinct labels: an entry is free
  }
  const unsigned long long c =
      (unsigned long long)(atomicAdd(cnts + idx, add) + add);
  return (c << 32) | ((unsigned int)GT_INT32_INF - (unsigned int)label);
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// The labels of one round of a row: slots w, w + G, .., w + (UNROLL - 1) G of
// the row-major slab; all slab loads are started before the first gather.
// INT32_INF for a pad or a slot past W.
__device__ __forceinline__ void load_round(const int* __restrict__ row,
                                           const int* __restrict__ labels,
                                           int w, int G, int W, bool live,
                                           long long bound, int mode,
                                           int (&lab)[GT_WIDE_UNROLL]) {
#pragma unroll
  for (int u = 0; u < GT_WIDE_UNROLL; ++u)
    lab[u] = (live && w + u * G < W) ? row[w + u * G] : -1;
#pragma unroll
  for (int u = 0; u < GT_WIDE_UNROLL; ++u) {
    const int s = lab[u];
    int v = GT_INT32_INF;
    if (s >= 0 && (long long)s < bound)
      v = mode == GT_MODE_GATHER ? __ldg(labels + s) : s;
    lab[u] = v;
  }
}

// Buckets of W in (32, 4096], read from their row-major copy [R, W]: tile[k]
// rows a block, a group of G = blockDim.x / tile[k] threads (whole warps) per
// row, a hash table of aux[k] entries a row in dynamic shared memory.
__global__ void __launch_bounds__(GT_WIDE_THREADS)
minmode_wide_kernel(const __grid_constant__ GtTable t,
                    const int* __restrict__ labels, int* __restrict__ out,
                    long long bound, int mode) {
  extern __shared__ int tables[];
  __shared__ unsigned long long wbest[GT_WIDE_THREADS / 32];
  const int k = gt_find_bucket(t);
  const long long R = t.b[k].R;
  const int W = t.b[k].W, rows = t.tile[k], size = t.aux[k];
  const int G = GT_WIDE_THREADS >> (__ffs(rows) - 1);
  const int tid = threadIdx.x, g = tid & (G - 1), grp = tid >> (__ffs(G) - 1);
  const long long r = (blockIdx.x - t.first_block[k]) * (long long)rows + grp;
  const bool live = r < R;  // the same for all lanes of a warp
  const int* __restrict__ row = t.b[k].slab + (live ? r : 0) * W;
  int* keys = tables + grp * 2 * size;
  int* cnts = keys + size;
  // the first round's loads are in flight while the tables are cleared, and
  // each later round's while the round before it is counted
  const int step = G * GT_WIDE_UNROLL;
  int lab[GT_WIDE_UNROLL], nxt[GT_WIDE_UNROLL];
  load_round(row, labels, g, G, W, live, bound, mode, lab);
  if (mode != GT_MODE_MIN) {
    for (int i = g; i < size; i += G) {
      keys[i] = GT_EMPTY;
      cnts[i] = 0;
    }
    __syncthreads();
  }
  // packed key: larger is better; 0 means no entry
  unsigned long long best = 0;
  for (int w0 = 0; w0 < W; w0 += step) {  // warp-uniform trips
    const bool more = w0 + step < W;
    if (more) load_round(row, labels, w0 + step + g, G, W, live, bound, mode, nxt);
#pragma unroll
    for (int u = 0; u < GT_WIDE_UNROLL; ++u) {
      const int v = lab[u];
      if (mode == GT_MODE_MIN) {
        if (v != GT_INT32_INF)
          best = max(best, (unsigned long long)((unsigned int)GT_INT32_INF -
                                                (unsigned int)v));
        continue;
      }
      // the lanes of a warp share a row: one insert per distinct label
      const unsigned int peers = __match_any_sync(0xffffffffu, v);
      if (v != GT_INT32_INF && __ffs(peers) - 1 == (tid & 31))
        best = max(best, hash_insert(keys, cnts, size, v, __popc(peers)));
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < GT_WIDE_UNROLL; ++u) lab[u] = nxt[u];
    }
  }
  best = warp_max_u64(best);
  if ((tid & 31) == 0) wbest[tid >> 5] = best;
  __syncthreads();
  if (g == 0 && live) {
    for (int j = 1; j < (G >> 5); ++j) best = max(best, wbest[(tid >> 5) + j]);
    out[t.b[k].out_off + r] = GT_INT32_INF - (int)(best & 0xffffffffull);
  }
}

// All buckets of one call lie on one side of GT_SMALL_W: one launch. Narrow
// buckets come as [W, R] slabs, wide ones as their row-major copies [R, W].
GT_EXPORT int gt_slab_minmode(const GtBucket* buckets, int nb, const int* labels,
                              int* out, long long bound, int mode,
                              void* stream) {
  if (nb < 1 || nb > GT_MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  if (mode < GT_MODE_GATHER || mode > GT_MODE_MIN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = buckets[0].W <= GT_SMALL_W;
  const int threads = small ? GT_SMALL_THREADS : GT_WIDE_THREADS;
  GtTable t;
  size_t smem = 0;
  for (int k = 0; k < nb; ++k) {
    const int W = buckets[k].W;
    if (W < 1 || W > GT_MAX_W || (W <= GT_SMALL_W) != small ||
        (buckets[k].row_major != 0) == small)
      return (int)cudaErrorInvalidValue;
    if (small) {
      t.tile[k] = threads;
      t.aux[k] = 0;
      continue;
    }
    const int size = W + W / 2;
    int G = 32;
    while (G < threads && G * GT_WIDE_SLOTS < W) G <<= 1;
    t.tile[k] = threads / G;
    t.aux[k] = size;
    const size_t need = (size_t)(threads / G) * size * 2 * sizeof(int);
    if (need > smem) smem = need;
  }
  if (!gt_table_blocks(t, buckets, nb)) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = t.first_block[nb];
  if (blocks == 0) return (int)cudaGetLastError();
  if (small) {
    minmode_small_kernel<<<blocks, threads, 0, s>>>(t, labels, out, bound, mode);
  } else {
    if (smem + GT_WIDE_THREADS / 32 * sizeof(unsigned long long) > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(
          minmode_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    minmode_wide_kernel<<<blocks, threads, smem, s>>>(t, labels, out, bound, mode);
  }
  return (int)cudaGetLastError();
}
