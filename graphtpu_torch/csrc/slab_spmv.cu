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
