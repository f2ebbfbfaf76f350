// K3 slab_spmv_sum: y[r] = sum over w of x[slab[w, r]] for a transposed
// [W, R] int32 slab (-1 = pad; ids outside [0, n) count as pad), in float32
// or float64, summed in slab order.
//
// Replaces the per-bucket body of graphtpu/ops/spmv.py:82-134 slab_spmv
// (:107-112, an XLA gather and row sum) for plus without edge values, the
// whole of PageRank's slab step (plus.second).
//
// Bound on the card: the slab read, 4 B per slot and coalesced, plus one
// random read of x per slot from a table of 4 or 8 MB that stays in L2;
// one add per slot is negligible.
//
// Design: one thread per row, walking w. At each w neighbouring threads
// read neighbouring r, so the transposed layout makes every slab load one
// coalesced access per warp.
#include "common.cuh"

template <typename T>
__global__ void slab_spmv_sum_kernel(const int* __restrict__ slab,
                                     const T* __restrict__ x,
                                     T* __restrict__ y, int w, long long R,
                                     long long n) {
  long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  T acc = 0;
  for (int k = 0; k < w; ++k) {
    const int s = slab[k * R + r];
    if (s >= 0 && s < n) acc += __ldg(x + s);
  }
  y[r] = acc;
}

GT_EXPORT int gt_slab_spmv_sum(const int* slab, const void* x, void* y, int w,
                               long long R, long long n, int is_f64,
                               void* stream) {
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (is_f64) {
    slab_spmv_sum_kernel<double><<<gt_blocks(R, threads), threads, 0, s>>>(
        slab, (const double*)x, (double*)y, w, R, n);
  } else {
    slab_spmv_sum_kernel<float><<<gt_blocks(R, threads), threads, 0, s>>>(
        slab, (const float*)x, (float*)y, w, R, n);
  }
  return (int)cudaGetLastError();
}

// K6 slab_spmv_min: y[r] = min over w of x[slab[w, r]] (gather mode, int32 x)
// or of slab[w, r] itself (identity mode, x null), for the same transposed
// [W, R] int32 slab (-1 = pad; ids outside [0, n) count as pad). A row
// without entries gives INT32_INF.
//
// Replaces the per-bucket body of graphtpu/ops/spmv.py:82-134 slab_spmv for
// min.second (an XLA gather, a where and a row min), which carries WCC's
// full steps, and the bucket bodies of WCC's gather-free iteration 0
// (graphtpu/algorithms/wcc.py:257-260, a masked row min of the stored ids).
//
// Bound on the card: as K3, the coalesced slab read plus one random 4 B read
// of x per slot from a 4 MB table that stays in L2. Min is exact in any
// order, so the result is bit-identical to the plain version's.
//
// Design: K3's, one thread per row walking w.
template <bool GATHER>
__global__ void slab_spmv_min_kernel(const int* __restrict__ slab,
                                     const int* __restrict__ x,
                                     int* __restrict__ y, int w, long long R,
                                     long long n) {
  long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  int acc = GT_INT32_INF;
  for (int k = 0; k < w; ++k) {
    const int s = slab[k * R + r];
    if (s >= 0 && s < n) acc = min(acc, GATHER ? __ldg(x + s) : s);
  }
  y[r] = acc;
}

GT_EXPORT int gt_slab_spmv_min(const int* slab, const int* x, int* y, int w,
                               long long R, long long n, void* stream) {
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (x) {
    slab_spmv_min_kernel<true><<<gt_blocks(R, threads), threads, 0, s>>>(
        slab, x, y, w, R, n);
  } else {
    slab_spmv_min_kernel<false><<<gt_blocks(R, threads), threads, 0, s>>>(
        slab, x, y, w, R, n);
  }
  return (int)cudaGetLastError();
}
