// K7 csr_pull_reduce: per row v of a pull CSR (in-edges of v at
// [indptr[v], indptr[v + 1]) of src), the reduction over its in-edges of
//   mode 0 (max_i32):  x[src[e]]            identity 0          (BFS frontier)
//   mode 1 (min_i32):  x[src[e]]            identity INT32_INF  (WCC labels)
//   mode 2 (min_plus): x[src[e]] + w[e]     identity +inf, float32 (SSSP)
//   mode 3 (min_plus): x[src[e]] + w[e]     identity +inf, float64 (SSSP)
//   mode 4 (sum):      x[src[e]]            identity 0, float32 (PageRank)
//   mode 5 (sum):      x[src[e]]            identity 0, float64 (PageRank)
//   mode 6 (sum_i64):  x[src[e]]            identity 0, int32 values summed
//                                           into int64 (LCC's edge credits)
// The identity is the value of a row without in-edges only: a max over
// negative values stays negative, as in the JAX reduction. In the int32 modes
// a null x reads the stored id src[e] itself (WCC's gather-free iteration 0,
// where the labels are the vertex ids).
//
// Replaces the dense steps' edge-stream gather and segment reduce:
// table_gather(x, edges_src) (+ w) followed by pull_reduce(max/min) in
// graphtpu/algorithms/bfs.py:54-56, :75-77, wcc.py:47-49, :210-213,
// :220-222 and sssp.py:52-55, :72-75 (an XLA gather, then a packed-key
// cummax over every edge), and PageRank's segment-sum pull,
// pull_reduce("sum", table_gather(contrib, edges_src), ...) in
// graphtpu/algorithms/pr.py:71-73 (a gather, then a float64 prefix sum
// differenced at the row ends). Mode 6 replaces the int64 sums of LCC's
// edge credits per head, a gather and a prefix sum differenced at the head
// starts in graphtpu/ops/triangles.py:620-642 `_aggregate_heads` and
// graphtpu/parallel/wedge_lcc.py:149-160; integer sums are exact in any
// order, so it equals the plain version bit for bit. The plain version is
// the port's K1 gather,
// then a scatter_reduce (an index_add_ in float64 for sum) that widens all m
// segment ids to int64 on every call.
//
// Bound on the card: bytes, and of those the gather. The src read (4 B per
// edge) and the w read in min_plus (4 or 8 B per edge) are coalesced streams;
// x is read once per edge at a random place of a table of 4 or 8 MB, which
// stays in L2 but costs a 32 B sector per edge wherever L1 misses. RMAT rows
// run from none to 10^5 in-edges: half of the rows of the benchmark graph hold
// at most four, and 1,351 rows hold a fifth of all edges. Work dealt out by
// rows (a warp each) leaves most lanes idle on the short rows and a hub to one
// warp; and RMAT's sources are as skewed as its rows, so how much of L1 a
// block leaves to x decides what a gather costs.
//
// Design: work is dealt out by items of the merged list of row ends and edges
// (the merge-path partition of Merrill and Garland's CSR SpMV), so a block
// always holds K7_THREADS * IPT items, whatever the rows look like: a hub is
// split over many blocks, a run of empty rows costs one item a row. Three
// kernels on one stream:
//   1. k7_partition: one thread per block border searches indptr for the row
//      its diagonal falls in (64-bit diagonals: n + m may pass 2^31);
//   2. k7_reduce: a block loads its slice of indptr into shared memory, reads
//      its edges' src (and w) coalesced, with loads that do not stay in the
//      caches, and starts every x gather of a thread before it uses any,
//      parks the terms in shared memory behind the row starts (rows + edges
//      never pass the block's items, so one buffer holds both), then each
//      thread walks IPT items of the block's merged list (its own start found
//      by a search in shared memory; IPT edges of one row, the common case,
//      take a path without tests), stores each row that ends in its items,
//      and a segmented scan over the threads (shuffles, then the warps'
//      totals) hands every thread the part of its first row that earlier
//      threads saw. The row that runs past the block's end goes to a
//      per-block carry (row, value);
//   3. k7_fixup: a warp per run of carries of one row folds them into y.
// Where x is gathered the launch asks for the 32 KB shared-memory
// configuration: three blocks an SM, and over 200 KB of L1 for x. Measured on
// the benchmark graph, more resident blocks (and less L1) cost 5-20 % of a
// gathering sweep, while a sweep over the stored ids (x null) is a third
// faster at full occupancy, so it asks for the default.
// Min and max are exact in any order and every candidate is the same single
// addition as the plain version's, so the result is bit-identical to it; no
// atomics, so two runs give the same bits even for -0.0 against +0.0 (which
// of the two a row keeps, and where a NaN survives, follows the fixed order
// of the walk, not the plain version's). A sum adds in the walk's fixed
// order (a thread's items, the scan over threads, a hub's carries block by
// block), so two runs give the same bits too; it rounds in the value type
// where the plain version sums in float64, so the two agree to the rounding
// of the row's additions. IPT is odd, so that the threads' walks through
// shared memory fall on distinct banks.
//
// Mode sum over float32 and float64 x also runs on a sliced pull (PageRank's
// pull; ops/spmv.py PullSlices, built once per CSR and value size). The
// merge-path walk above gathers x at random, one L2 sector a value (about
// 200 G gathers/s), and spends as much again walking its items. The sliced
// pull turns every gather into a read of shared memory and walks edges only:
//   layout: x's index range is cut into slices of `width` entries (192 KB of
//     values: 49,152 float32 or 24,576 float64). The edges are regrouped by
//     slice, keeping the pull CSR's (row, src) order inside one, each with a
//     16-bit slice-local id; a slice is padded to a whole group of 16 edges
//     and one group closes the stream. Each (row, slice) run of edges (and
//     each slice's pad) starts at a head bit; a run is numbered by the heads
//     before it. Each slice's edges are cut into tiles of K7S_THREADS * 16
//     edges, each with the count of heads before it, and a group's 32-bit
//     head word holds its 16 head bits and the heads of its tile before it.
//     The real runs listed row-major (a row's in slice order) give each row
//     its partial sums;
//   pass 1 (k7_reduce_sliced): one block an SM (its shared memory holds a
//     slice), each over an equal run of tiles. A block copies a slice of x
//     into shared memory when its next tile is of another slice (cp.async,
//     16 bytes a copy). A thread takes a group of 16 edges: its ids in two
//     16-byte loads and its head word, loaded one tile ahead while the
//     current tile is reduced. It adds its values (shared-memory reads) into
//     the parts between its heads, and each head but its first closes the
//     run before it: its sum goes to part[run], in run order, so that a
//     warp's stores fall on few sectors (stored in the rows' order instead,
//     the scattered 4-byte stores cost more than all the rest of the pass).
//     A segmented scan over the block's threads (shuffles, then the warps'
//     totals, which every warp scans itself past the tile's one barrier)
//     gives each thread the sum of the run it began in, which its first
//     head closes. The run open at a tile's end is carried
//     into the next tile, the one open at the block's end to k7_fixup,
//     which adds it to part;
//   pass 2 (k7_fold_slices): a thread a row adds its runs' partial sums in
//     slice order into y (0 for a row without edges), gathered by the
//     row-major list of runs.
// The order of every addition is fixed by the layout and the grid, so two
// runs give the same bits. The bytes a call must move: 2 B an edge, 4 B a
// group's head word, a run's partial written and read and its place in the
// row-major list, the row offsets, x and y. Where runs are short (more than
// one in 8 edges) the merge path is faster, and ops/spmv.py takes it.
#include "common.cuh"

#include <limits>

#define K7_THREADS 256
// shared memory an SM sets aside while a gathering k7_reduce runs, in percent
// of its most: the 32 KB configuration, which holds three blocks and leaves
// the rest of the 256 KB to L1
#define K7_GATHER_CARVEOUT 14

// items of the merged list per thread, by the size of a value; the Python
// wrapper sizes the scratch by the same numbers (ops/spmv.py CSR_ITEMS)
template <typename T>
struct K7Items {
  static constexpr int value = sizeof(T) == 8 ? 5 : 9;
};

// the reduction of a mode
enum K7Op { K7_MIN = 0, K7_MAX = 1, K7_SUM = 2 };

template <typename T, int OP>
__device__ __forceinline__ T fold(T a, T b) {
  return OP == K7_SUM ? a + b : OP == K7_MAX ? (b > a ? b : a) : (b < a ? b : a);
}

// start_row[b] = row ends that precede diagonal b * ipb of the merged list:
// the first row r in [max(d - m, 0), min(d, n)] whose end indptr[r + 1] lies
// past edge d - r - 1
__global__ void k7_partition(const int* __restrict__ indptr, long long n,
                             long long m, int ipb, long long nb,
                             int* __restrict__ start_row) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b > nb) return;
  long long d = b * ipb;
  if (d > n + m) d = n + m;
  long long lo = d > m ? d - m : 0, hi = d < n ? d : n;
  while (lo < hi) {
    const long long p = (lo + hi) >> 1;
    if ((long long)indptr[p + 1] <= d - p - 1) lo = p + 1; else hi = p;
  }
  start_row[b] = (int)lo;
}

// T is the type of the sums and of y; X that of the gathered x (mode 6 sums
// int32 values into int64, every other mode has X = T)
template <typename T, int OP, bool PLUS, int IPT, typename X>
__global__ void __launch_bounds__(K7_THREADS)
k7_reduce(const int* __restrict__ indptr, const int* __restrict__ src,
          const X* __restrict__ x, const T* __restrict__ w,
          T* __restrict__ y, long long n, long long m,
          const int* __restrict__ start_row, int* __restrict__ carry_row,
          T* __restrict__ carry_val, T neutral, T identity) {
  constexpr int IPB = K7_THREADS * IPT;
  // one buffer for the block's nrows + 1 row starts and its nedges terms:
  // nrows + nedges <= IPB, so IPB + 2 values of T hold both
  __shared__ __align__(8) unsigned char s_raw[(IPB + 2) * sizeof(T)];
  __shared__ int s_wk[K7_THREADS / 32];
  __shared__ T s_wv[K7_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d0 = blockIdx.x * (long long)IPB;
  const long long d1 = d0 + IPB < n + m ? d0 + IPB : n + m;
  const int i0 = start_row[blockIdx.x], i1 = start_row[blockIdx.x + 1];
  const int j0 = (int)(d0 - i0), j1 = (int)(d1 - i1);
  const int nrows = i1 - i0, nedges = j1 - j0;

  int* s_ind = reinterpret_cast<int*>(s_raw);  // indptr[i0 .. i1]
  // the block's terms, in edge order, behind the row starts
  T* s_val = reinterpret_cast<T*>(
      s_raw + ((nrows + 1) * sizeof(int) + sizeof(T) - 1) / sizeof(T) * sizeof(T));
  for (int k = tid; k <= nrows; k += K7_THREADS) s_ind[k] = indptr[i0 + k];
  {
    int s[IPT];
    T v[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int e = k * K7_THREADS + tid;
      s[k] = e < nedges ? __ldcs(src + j0 + e) : 0;
    }
    if (x) {
#pragma unroll
      for (int k = 0; k < IPT; ++k)
        v[k] = k * K7_THREADS + tid < nedges ? (T)__ldg(x + s[k]) : neutral;
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k) v[k] = (T)s[k];
    }
    if (PLUS) {
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        const int e = k * K7_THREADS + tid;
        if (e < nedges) v[k] = v[k] + __ldcs(w + j0 + e);
      }
    }
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int e = k * K7_THREADS + tid;
      if (e < nedges) s_val[e] = v[k];
    }
  }
  __syncthreads();

  // this thread's IPT items of the block's merged list start at (rx, ey):
  // rx row ends and ey edges of the block precede them
  const int items = nrows + nedges;
  const int dt = tid * IPT < items ? tid * IPT : items;
  int lo = dt > nedges ? dt - nedges : 0, hi = dt < nrows ? dt : nrows;
  while (lo < hi) {
    const int p = (lo + hi) >> 1;
    if (s_ind[p + 1] <= j0 + dt - p - 1) lo = p + 1; else hi = p;
  }
  int rx = lo;
  const int ey = dt - lo;
  const int none = GT_INT32_INF;  // no row ends past the block's last
  int row_end = rx < nrows ? s_ind[rx + 1] : none;
  int left = items - dt < IPT ? items - dt : IPT;
  T acc = neutral, first_val = neutral;
  int first_row = -1;  // the first row that ends here may have begun earlier
  if (left == IPT && j0 + ey <= row_end - IPT) {
    // the common case: IPT edges of one row, no row end among them
#pragma unroll
    for (int i = 0; i < IPT; ++i) acc = fold<T, OP>(acc, s_val[ey + i]);
  } else {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      // the rows that end before edge ey + i
      while (left > 0 && j0 + ey + i >= row_end) {
        if (first_row < 0) {
          first_row = rx;
          first_val = acc;
        } else {
          y[i0 + rx] = (OP == K7_MAX && s_ind[rx] == s_ind[rx + 1]) ? identity : acc;
        }
        acc = neutral;
        ++rx;
        row_end = rx < nrows ? s_ind[rx + 1] : none;
        --left;
      }
      if (left > 0) {
        acc = fold<T, OP>(acc, s_val[ey + i]);
        --left;
      }
    }
  }

  // inclusive scan of (row the thread ends in, its open part of that row),
  // segmented by row; rows ascend with the thread, so equal keys are a run
  const unsigned full = 0xffffffffu;
  int key = rx;
  T val = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_up_sync(full, key, off);
    const T v2 = __shfl_up_sync(full, val, off);
    if (lane >= off && k2 == key) val = fold<T, OP>(v2, val);
  }
  if (lane == 31) {
    s_wk[warp] = key;
    s_wv[warp] = val;
  }
  __syncthreads();
  int pk = -1;
  T pv = neutral;
  for (int u = 0; u < warp; ++u) {
    if (s_wk[u] == pk) {
      pv = fold<T, OP>(pv, s_wv[u]);
    } else {
      pk = s_wk[u];
      pv = s_wv[u];
    }
  }
  if (pk == key) val = fold<T, OP>(pv, val);
  int in_key = __shfl_up_sync(full, key, 1);
  T in_val = __shfl_up_sync(full, val, 1);
  if (lane == 0) {
    in_key = pk;
    in_val = pv;
  }
  if (first_row >= 0) {
    if (in_key == first_row) first_val = fold<T, OP>(in_val, first_val);
    y[i0 + first_row] =
        (OP == K7_MAX && s_ind[first_row] == s_ind[first_row + 1]) ? identity : first_val;
  }
  if (tid == K7_THREADS - 1) {
    carry_row[blockIdx.x] = i0 + key;  // n in the last block: no such row
    carry_val[blockIdx.x] = val;
  }
}

// A warp per block carry: the first carry of a row folds the run of carries
// of that row into y, which the block the row ends in has written.
// With ``slot`` the carries are of segments of a sliced pull and go to
// y[slot[row]] (the partial sums).
template <typename T, int OP>
__global__ void k7_fixup(const int* __restrict__ carry_row,
                         const T* __restrict__ carry_val, T* __restrict__ y,
                         long long n, long long nb, T neutral,
                         const int* __restrict__ slot) {
  const long long b = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= nb) return;  // the whole warp shares one carry
  const int r = carry_row[b];
  if (r >= n || (b > 0 && carry_row[b - 1] == r)) return;
  const unsigned full = 0xffffffffu;
  T v = neutral;
  for (long long base = b;; base += 32) {
    const long long b2 = base + lane;
    const bool same = b2 < nb && carry_row[b2] == r;
    if (same) v = fold<T, OP>(v, carry_val[b2]);
    if (!__all_sync(full, same)) break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fold<T, OP>(v, __shfl_xor_sync(full, v, off));
  if (lane == 0) {
    const long long at = slot ? slot[r] : r;
    y[at] = fold<T, OP>(v, y[at]);
  }
}

// The scratch of one call: start_row [nb + 1], carry_row [nb], then, at the
// next multiple of 8 bytes, carry_val [nb] (ops/spmv.py csr_scratch_layout).
template <typename T, int OP, bool PLUS, typename X = T>
static int launch(const int* indptr, const int* src, const void* x,
                  const void* w, void* y, long long n, long long m,
                  T identity, int items_per_block, void* scratch,
                  long long scratch_bytes, cudaStream_t s) {
  constexpr int IPT = K7Items<T>::value;
  constexpr int IPB = K7_THREADS * IPT;
  const long long nb = (n + m + IPB - 1) / IPB;
  const long long val_off = (4 * (2 * nb + 1) + 7) / 8 * 8;
  if (items_per_block != IPB || nb > 0x7fffffffLL ||
      scratch_bytes < val_off + (long long)sizeof(T) * nb)
    return (int)cudaErrorInvalidValue;
  int* start_row = (int*)scratch;
  int* carry_row = start_row + nb + 1;
  T* carry_val = (T*)((char*)scratch + val_off);
  // the min and sum modes' identities (INT32_MAX, +inf, 0) are their
  // neutral values
  const T neutral = OP == K7_MAX ? std::numeric_limits<T>::lowest() : identity;
  // where x is gathered: few blocks an SM, and the L1 the gathers need
  const cudaError_t carved = cudaFuncSetAttribute(
      k7_reduce<T, OP, PLUS, IPT, X>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      x ? K7_GATHER_CARVEOUT : (int)cudaSharedmemCarveoutDefault);
  if (carved != cudaSuccess) return (int)carved;
  k7_partition<<<gt_blocks(nb + 1, 256), 256, 0, s>>>(indptr, n, m, IPB, nb,
                                                      start_row);
  k7_reduce<T, OP, PLUS, IPT, X><<<(unsigned int)nb, K7_THREADS, 0, s>>>(
      indptr, src, (const X*)x, (const T*)w, (T*)y, n, m, start_row, carry_row,
      carry_val, neutral, identity);
  k7_fixup<T, OP><<<gt_blocks(nb * 32, 256), 256, 0, s>>>(
      carry_row, carry_val, (T*)y, n, nb, neutral, nullptr);
  return (int)cudaGetLastError();
}

// m = len(src) = indptr[n]; scratch as laid out above, uninitialised. Without
// edges src and w may be null (an empty tensor has no storage).
GT_EXPORT int gt_csr_pull_reduce(const int* indptr, const int* src,
                                 const void* x, const void* w, void* y,
                                 long long n, long long m, int mode,
                                 int items_per_block, void* scratch,
                                 long long scratch_bytes, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (n < 0 || m < 0 || n > 0x7fffffffLL || m > 0x7fffffffLL || !scratch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ipb = items_per_block;
  const float finf = std::numeric_limits<float>::infinity();
  const double dinf = std::numeric_limits<double>::infinity();
  switch (mode) {
    case 0:
      return launch<int, K7_MAX, false>(indptr, src, x, w, y, n, m, 0, ipb,
                                        scratch, scratch_bytes, s);
    case 1:
      return launch<int, K7_MIN, false>(indptr, src, x, w, y, n, m,
                                        GT_INT32_INF, ipb, scratch,
                                        scratch_bytes, s);
    case 2:
      if (!x || (!w && m > 0)) return (int)cudaErrorInvalidValue;
      return launch<float, K7_MIN, true>(indptr, src, x, w, y, n, m, finf, ipb,
                                         scratch, scratch_bytes, s);
    case 3:
      if (!x || (!w && m > 0)) return (int)cudaErrorInvalidValue;
      return launch<double, K7_MIN, true>(indptr, src, x, w, y, n, m, dinf,
                                          ipb, scratch, scratch_bytes, s);
    case 4:
      if (!x) return (int)cudaErrorInvalidValue;
      return launch<float, K7_SUM, false>(indptr, src, x, w, y, n, m, 0.0f,
                                          ipb, scratch, scratch_bytes, s);
    case 5:
      if (!x) return (int)cudaErrorInvalidValue;
      return launch<double, K7_SUM, false>(indptr, src, x, w, y, n, m, 0.0,
                                           ipb, scratch, scratch_bytes, s);
    case 6:
      if (!x) return (int)cudaErrorInvalidValue;
      return launch<long long, K7_SUM, false, int>(indptr, src, x, w, y, n, m,
                                                   0LL, ipb, scratch,
                                                   scratch_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Mode sum on a sliced pull (the design is in the header above).

// threads of a k7_reduce_sliced block (a measuring tool's own build may set
// another, with layouts built to match); each takes a group of 16 edges, so
// a tile holds K7S_TILE edges and at most as many runs (ops/spmv.py
// SLICE_ITEMS)
#ifndef K7S_THREADS
#define K7S_THREADS 512
#endif
#define K7S_EPT 16
#define K7S_TILE (K7S_THREADS * K7S_EPT)
#define K7S_WARPS (K7S_THREADS / 32)
// Probes. A build with K7S_PROBE set (tools/pull_sum_times.py's own library)
// leaves one part of pass 1 out, so that the tool sees what it costs; its
// sums are wrong. 1: the slice copies; 2: the gathers (a value is its id);
// 4: the partial sums' bookkeeping and stores.
#ifndef K7S_PROBE
#define K7S_PROBE 0
#endif

// A tile's loads into registers, one tile ahead: the thread's group of ids
// (two 16-byte loads) and its head word. A thread past the tile's groups
// loads its last one, unpredicated, so that nothing waits on the loads
// before the next tile uses them (the caller drops what it read).
struct K7sRegs {
  uint4 ids[2];
  unsigned int head;
};

__device__ __forceinline__ void k7s_load(const uint4* __restrict__ lid,
                                         const unsigned int* __restrict__ head, int e0,
                                         int e1, K7sRegs& r) {
  const int last = (e1 - e0) / K7S_EPT - 1;
  const int g = e0 / K7S_EPT + ((int)threadIdx.x < last ? (int)threadIdx.x : last);
  r.ids[0] = __ldcs(lid + 2 * g);
  r.ids[1] = __ldcs(lid + 2 * g + 1);
  r.head = __ldcs(head + g);
}

// x[slice * width, + width) (fewer in the last slice) into s_x, then a barrier.
template <typename T>
__device__ __forceinline__ void k7s_stage(T* s_x, const T* __restrict__ x, long long nx,
                                          int slice, int width) {
  const long long base = (long long)slice * width;
  const long long left = nx - base;
  const int cnt = (int)(left < 0 ? 0 : left < width ? left : width);
  const T* src = x + base;
  int done = K7S_PROBE == 1 ? cnt : 0;
  if (K7S_PROBE != 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int PER = 16 / sizeof(T);
    const int n16 = cnt / PER;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(s_x);
    for (int k = threadIdx.x; k < n16; k += K7S_THREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * k),
                   "l"(src + PER * k)
                   : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    done = n16 * PER;
  }
  for (int k = done + threadIdx.x; k < cnt; k += K7S_THREADS) s_x[k] = __ldg(src + k);
  __syncthreads();
}

// The segmented-scan element of a run of threads: whether it holds a head,
// and the sum since its last head (all of it without one). a then b: b's sum
// restarts at b's first head.
template <typename T>
struct K7sScan {
  int f;
  T v;
};

template <typename T>
__device__ __forceinline__ K7sScan<T> k7s_then(const K7sScan<T>& a, const K7sScan<T>& b) {
  return {a.f | b.f, b.f ? b.v : a.v + b.v};
}

template <typename T>
__device__ __forceinline__ K7sScan<T> k7s_up(const K7sScan<T>& a, int off) {
  const unsigned full = 0xffffffffu;
  return {__shfl_up_sync(full, a.f, off), __shfl_up_sync(full, a.v, off)};
}

// A group's walk: its values added into the parts between its heads; the
// k-th head (k >= 1) stores the run it closes at out[k], the first one leaves
// its part in pre, for the scan. Selects and predicated stores: nothing for
// a warp to diverge on.
template <typename T>
__device__ __forceinline__ void k7s_walk(const T (&v)[K7S_EPT], unsigned int hb, T* out,
                                         T& acc, T& pre) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < K7S_EPT; ++i) {
    const bool h = (hb >> i) & 1u;
    pre = h && k == 0 ? acc : pre;
    if (h && k != 0 && K7S_PROBE != 4) out[k] = acc;
    k += h;
    acc = (h ? T(0) : acc) + v[i];
  }
}

// Pass 1: block b reduces tiles [b * ntiles / grid, (b + 1) * ntiles / grid).
// Tile t holds edges [tile_edge[t], tile_edge[t + 1]) (whole groups) of slice
// tile_slice[t], and runs tile_run[t] .. tile_run[t + 1] - 1 start in it; a
// group's head word holds its 16 head bits and, above them, the heads of its
// tile before it. part [runs]: each run's sum.
template <typename T>
__global__ void __launch_bounds__(K7S_THREADS, 1)
k7_reduce_sliced(const uint4* __restrict__ lid, const unsigned int* __restrict__ head,
                 const int* __restrict__ tile_edge, const int* __restrict__ tile_run,
                 const int* __restrict__ tile_slice, int ntiles, int nseg,
                 const T* __restrict__ x, long long nx, int width, T* __restrict__ part,
                 int* __restrict__ carry_seg, T* __restrict__ carry_val) {
  extern __shared__ __align__(16) unsigned char k7s_smem[];
  T* s_x = reinterpret_cast<T*>(k7s_smem);
  __shared__ int s_wf[2][K7S_WARPS];
  __shared__ T s_wv[2][K7S_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const int t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  T carry = T(0);  // the sum of the run open at the end of the last tile
  // tile t's edges, first run and slice; tile t + 1's edge end, run end, slice
  int e0 = 0, e1 = 0, r0 = 0, sl = 0, ne1 = 0, nr0 = 0, nsl = 0;
  K7sRegs reg;
  if (t0 < t1) {
    e0 = tile_edge[t0];
    e1 = tile_edge[t0 + 1];
    r0 = tile_run[t0];
    sl = tile_slice[t0];
    nr0 = tile_run[t0 + 1];
    if (t0 + 1 < t1) {
      ne1 = tile_edge[t0 + 2];
      nsl = tile_slice[t0 + 1];
    }
    k7s_load(lid, head, e0, e1, reg);
  }
  int staged = -1;
  for (int t = t0; t < t1; ++t) {
    if (sl != staged) {
      k7s_stage(s_x, x, nx, sl, width);  // ends in a barrier
      staged = sl;
    }
    const bool has = tid * K7S_EPT < e1 - e0;
    const unsigned int hw = has ? reg.head : 0u;
    const unsigned int hb = hw & 0xffffu;
    const int rb = r0 + (int)(hw >> 16);  // the run the group's first head starts
    const unsigned int w[8] = {reg.ids[0].x, reg.ids[0].y, reg.ids[0].z, reg.ids[0].w,
                               reg.ids[1].x, reg.ids[1].y, reg.ids[1].z, reg.ids[1].w};
    // the next tile's loads are in flight while this one is reduced
    const int pe1 = ne1, pr0 = nr0, psl = nsl;
    if (t + 1 < t1) {
      k7s_load(lid, head, e1, pe1, reg);
      nr0 = tile_run[t + 2];
      if (t + 2 < t1) {
        ne1 = tile_edge[t + 3];
        nsl = tile_slice[t + 2];
      }
    }
    // the group's values (shared-memory reads) added into the parts between
    // its heads (k7s_walk: each head but the first stores the run it closes)
    T v[K7S_EPT];
#pragma unroll
    for (int i = 0; i < K7S_EPT; ++i) {
      const unsigned int id = i & 1 ? w[i >> 1] >> 16 : w[i >> 1] & 0xffffu;
      v[i] = K7S_PROBE == 2 ? T(id) : s_x[id];
    }
    T acc = T(0), pre = T(0);
    k7s_walk(v, hb, part + (rb - 1), acc, pre);
    // the block's exclusive scan of (holds a head, sum since it), seeded
    // with the run carried in: the sum of the run the thread began in. The
    // warps' totals go to one of two buffers by the tile's parity, and
    // every warp scans them itself, past one barrier a tile (a buffer is
    // written again two tiles later, past the next tile's barrier)
    K7sScan<T> inc = {hb != 0u, has ? acc : T(0)};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const K7sScan<T> up = k7s_up(inc, off);
      if (lane >= off) inc = k7s_then(up, inc);
    }
    const int par = (t - t0) & 1;
    if (lane == 31) {
      s_wf[par][warp] = inc.f;
      s_wv[par][warp] = inc.v;
    }
    __syncthreads();
    {
      const K7sScan<T> seed = {0, carry};
      K7sScan<T> wt = lane < K7S_WARPS ? K7sScan<T>{s_wf[par][lane], s_wv[par][lane]}
                                       : K7sScan<T>{0, T(0)};
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const K7sScan<T> up = k7s_up(wt, off);
        if (lane >= off) wt = k7s_then(up, wt);
      }
      const int src = warp > 0 ? warp - 1 : 0;
      const K7sScan<T> before = {__shfl_sync(full, wt.f, src), __shfl_sync(full, wt.v, src)};
      const K7sScan<T> last = {__shfl_sync(full, wt.f, K7S_WARPS - 1),
                               __shfl_sync(full, wt.v, K7S_WARPS - 1)};
      const K7sScan<T> wx = warp == 0 ? seed : k7s_then(seed, before);
      const K7sScan<T> lane_ex = k7s_up(inc, 1);
      const K7sScan<T> ex = lane == 0 ? wx : k7s_then(wx, lane_ex);
      carry = k7s_then(seed, last).v;  // the same in every thread
      // the first head closes the run the thread began in
      if (hb != 0u && rb > 0 && K7S_PROBE != 4) part[rb - 1] = ex.v + pre;
    }
    // a slice is copied in only past this tile's barrier, which every read
    // of s_x precedes
    e0 = e1;
    r0 = pr0;
    e1 = pe1;
    sl = psl;
  }
  if (tid == 0) {
    carry_seg[blockIdx.x] = t0 < t1 ? r0 - 1 : nseg;  // nseg: no open run
    carry_val[blockIdx.x] = carry;
  }
}

// Pass 2: y[r] = the sum of part[row_runs[k]] for k in [part_ptr[r],
// part_ptr[r + 1]), in order.
template <typename T>
__global__ void k7_fold_slices(const int* __restrict__ part_ptr,
                               const int* __restrict__ row_runs, const T* __restrict__ part,
                               T* __restrict__ y, long long n) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int a = part_ptr[r], b = part_ptr[r + 1];
  T acc = T(0);
  for (int k = a; k < b; ++k) acc += part[row_runs[k]];
  y[r] = acc;
}

template <typename T>
static int launch_sliced(const uint4* lid, const unsigned int* head, const int* row_runs,
                         const int* part_ptr, const int* tile_edge, const int* tile_run,
                         const int* tile_slice, long long ntiles, long long nseg, long long n,
                         const T* x, long long nx, int width, int grid, T* part,
                         void* scratch, long long scratch_bytes, T* y, cudaStream_t s) {
  const long long val_off = (4LL * grid + 7) / 8 * 8;
  const size_t smem = (size_t)width * sizeof(T);
  if (width < 8 || width > 65536 || width % 8 || (ntiles > 0 && grid < 1) ||
      grid > ntiles || (ntiles > 0 && (!x || !lid || !head || !part || !scratch ||
                                       scratch_bytes < val_off + (long long)sizeof(T) * grid)))
    return (int)cudaErrorInvalidValue;
  if (ntiles > 0) {
    const cudaError_t set = cudaFuncSetAttribute(
        k7_reduce_sliced<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (set != cudaSuccess) return (int)set;
    int* carry_seg = (int*)scratch;
    T* carry_val = (T*)((char*)scratch + val_off);
    k7_reduce_sliced<T><<<grid, K7S_THREADS, smem, s>>>(
        lid, head, tile_edge, tile_run, tile_slice, (int)ntiles, (int)nseg, x, nx, width,
        part, carry_seg, carry_val);
    k7_fixup<T, K7_SUM><<<gt_blocks(32LL * grid, 256), 256, 0, s>>>(
        carry_seg, carry_val, part, nseg, grid, T(0), nullptr);
  }
  k7_fold_slices<T><<<gt_blocks(n, 256), 256, 0, s>>>(part_ptr, row_runs, part, y, n);
  return (int)cudaGetLastError();
}

// K7 in mode sum over a sliced pull (ops/spmv.py PullSlices): y [n] of x's
// type (is_f64: double, else float); part [nseg] (a sum a run, pad runs
// included) of it and scratch (grid carry runs, then at the next multiple of
// 8 bytes grid carry values) uninitialised; lid 16-byte aligned; grid <=
// ntiles blocks, each with width values of x in shared memory. items: the
// layout's edges a tile, which must be this build's K7S_TILE.
GT_EXPORT int gt_csr_pull_slices(const void* lid, const unsigned int* head,
                                 const int* row_runs, const int* part_ptr,
                                 const int* tile_edge, const int* tile_run,
                                 const int* tile_slice, long long ntiles, long long nseg,
                                 long long n, const void* x, long long nx, int width,
                                 int items, int is_f64, int grid, void* part, void* scratch,
                                 long long scratch_bytes, void* y, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (n < 0 || n > 0x7fffffffLL || nseg < 0 || nseg > 0x7fffffffLL || ntiles < 0 ||
      ntiles > 0x7fffffffLL || nx < 0 || !part_ptr || !y || items != K7S_TILE ||
      (reinterpret_cast<uintptr_t>(lid) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* ids = (const uint4*)lid;
  if (is_f64)
    return launch_sliced<double>(ids, head, row_runs, part_ptr, tile_edge, tile_run,
                                 tile_slice, ntiles, nseg, n, (const double*)x, nx, width,
                                 grid, (double*)part, scratch, scratch_bytes, (double*)y, s);
  return launch_sliced<float>(ids, head, row_runs, part_ptr, tile_edge, tile_run, tile_slice,
                              ntiles, nseg, n, (const float*)x, nx, width, grid,
                              (float*)part, scratch, scratch_bytes, (float*)y, s);
}
