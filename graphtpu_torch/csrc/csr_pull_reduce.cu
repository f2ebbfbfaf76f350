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
template <typename T, int OP>
__global__ void k7_fixup(const int* __restrict__ carry_row,
                         const T* __restrict__ carry_val, T* __restrict__ y,
                         long long n, long long nb, T neutral) {
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
  if (lane == 0) y[r] = fold<T, OP>(v, y[r]);
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
      carry_row, carry_val, (T*)y, n, nb, neutral);
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
