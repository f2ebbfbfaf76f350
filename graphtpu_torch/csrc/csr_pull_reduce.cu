// K7 csr_pull_reduce: per row v of a pull CSR (in-edges of v at
// [indptr[v], indptr[v + 1]) of src), the reduction over its in-edges of
//   mode 0 (max_i32):  x[src[e]]            identity 0          (BFS frontier)
//   mode 1 (min_i32):  x[src[e]]            identity INT32_INF  (WCC labels)
//   mode 2 (min_plus): x[src[e]] + w[e]     identity +inf, float32 (SSSP)
//   mode 3 (min_plus): x[src[e]] + w[e]     identity +inf, float64 (SSSP)
// The identity is the value of a row without in-edges only: a max over
// negative values stays negative, as in the JAX reduction. In the int32 modes
// a null x reads the stored id src[e] itself (WCC's gather-free iteration 0,
// where the labels are the vertex ids).
//
// Replaces the dense steps' edge-stream gather and segment reduce:
// table_gather(x, edges_src) (+ w) followed by pull_reduce(max/min) in
// graphtpu/algorithms/bfs.py:54-56, :75-77, wcc.py:47-49, :210-213,
// :220-222 and sssp.py:52-55, :72-75 (an XLA gather, then a packed-key
// cummax over every edge). The plain version is the port's K1 gather, then a
// scatter_reduce that widens all m segment ids to int64 on every call.
//
// Bound on the card: the src read (4 B per edge, coalesced within a row),
// the w read in min_plus (4 or 8 B per edge, coalesced) and one random read
// of x per edge from a table of 4 or 8 MB that stays in L2. Min and max are
// exact in any order and every candidate is the same single addition as the
// plain version's, so the result is bit-identical to it.
//
// Design: one warp per row. RMAT hubs hold 10^4-10^5 in-edges, so one
// thread per row would leave a hub to one thread; the 32 lanes stride the
// row's in-edges, then a shuffle reduction leaves the row's value in lane 0.
#include "common.cuh"

#include <limits>

template <typename T, bool IS_MAX>
__device__ __forceinline__ T pick(T a, T b) {
  return IS_MAX ? (a > b ? a : b) : (b < a ? b : a);
}

template <typename T, bool IS_MAX, bool PLUS>
__global__ void csr_pull_reduce_kernel(const int* __restrict__ indptr,
                                       const int* __restrict__ src,
                                       const T* __restrict__ x,
                                       const T* __restrict__ w,
                                       T* __restrict__ y, long long n,
                                       T neutral, T identity) {
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp shares one row
  const int begin = indptr[row], end = indptr[row + 1];
  T acc = neutral;
  for (int e = begin + lane; e < end; e += 32) {
    const int s = src[e];
    T v = x ? __ldg(x + s) : (T)s;
    if (PLUS) v = v + __ldg(w + e);
    acc = pick<T, IS_MAX>(acc, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = pick<T, IS_MAX>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[row] = begin == end ? identity : acc;
}

template <typename T, bool IS_MAX, bool PLUS>
static void launch(const int* indptr, const int* src, const void* x,
                   const void* w, void* y, long long n, T identity,
                   cudaStream_t s) {
  const int threads = 256;  // 8 rows per block
  // the min modes' identities (INT32_MAX, +inf) are their neutral values
  const T neutral = IS_MAX ? std::numeric_limits<T>::lowest() : identity;
  csr_pull_reduce_kernel<T, IS_MAX, PLUS>
      <<<gt_blocks(n * 32, threads), threads, 0, s>>>(
          indptr, src, (const T*)x, (const T*)w, (T*)y, n, neutral, identity);
}

GT_EXPORT int gt_csr_pull_reduce(const int* indptr, const int* src,
                                 const void* x, const void* w, void* y,
                                 long long n, int mode, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: launch<int, true, false>(indptr, src, x, w, y, n, 0, s); break;
    case 1:
      launch<int, false, false>(indptr, src, x, w, y, n, GT_INT32_INF, s);
      break;
    case 2:
      if (!x || !w) return (int)cudaErrorInvalidValue;
      launch<float, false, true>(indptr, src, x, w, y, n,
                                 std::numeric_limits<float>::infinity(), s);
      break;
    case 3:
      if (!x || !w) return (int)cudaErrorInvalidValue;
      launch<double, false, true>(indptr, src, x, w, y, n,
                                  std::numeric_limits<double>::infinity(), s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
