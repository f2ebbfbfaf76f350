// K21 wcc_jump: the first half of WCC's full step after the neighbours'
// minimum, for the device loop of WCC auto and adaptive (algorithms/wcc.py).
//
// Ports graphtpu/algorithms/wcc.py:202-207 `finish` (and :46-50 in the slab
// kernel): new = min(labels, neigh_min), then two pointer jumps new =
// min(new, new[new]). The second jump reads the first jump's output at
// arbitrary vertices, so it needs a launch boundary: K21 computes the first,
// and K20's status entry in its jump mode (cdlp_loop.cu) the second, with the
// changed mask, the labels' update and the loop's status in the same pass.
// For each vertex v: a = min(labels[v], neigh_min[v]) and out[v] = min(a,
// min(labels[a], neigh_min[a])): the first jump reads min(labels, neigh_min)
// at a on the fly, so `new` is never stored, and it writes a buffer of its
// own (never labels, which other threads read at arbitrary a).
//
// Bound: bytes, labels and neigh_min read and out written once, 12 bytes a
// vertex (n = 2^20: 3.8 us); the reads at a are random, but a label is its
// component's smallest id or near it, so most fall on a few hot lines. One
// thread a vertex.
#include "common.cuh"

#define K21_THREADS 256

__global__ void __launch_bounds__(K21_THREADS)
k21_jump_kernel(const int* __restrict__ labels, const int* __restrict__ neigh_min,
                int* __restrict__ out, long long n) {
  const long long v = (long long)blockIdx.x * K21_THREADS + threadIdx.x;
  if (v >= n) return;
  const int a = min(labels[v], neigh_min[v]);
  out[v] = min(a, min(__ldg(labels + a), __ldg(neigh_min + a)));
}

// labels, neigh_min [n] int32 (ids in [0, n)), out [n] int32, none aliased.
GT_EXPORT int gt_wcc_jump(const int* labels, const int* neigh_min, int* out, long long n,
                          void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n)
    k21_jump_kernel<<<gt_blocks(n, K21_THREADS), K21_THREADS, 0, (cudaStream_t)stream>>>(
        labels, neigh_min, out, n);
  return (int)cudaGetLastError();
}
