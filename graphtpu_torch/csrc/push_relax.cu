// K8 push_relax_min: SSSP's push relaxation over a frontier expansion. For
// each slot e in [0, e_cap) with valid[e]:
//   out[neigh[e]] = min(out[neigh[e]], dist[row_ids[e]] + w[gpos[e]])
// where out starts as a copy of dist (the wrapper makes it), in float32 or
// float64.
//
// Replaces graphtpu/algorithms/sssp.py:140-145 (and relax_frontier at
// :249-256): two gathers, dist[row_ids] and w[gpos], an add, and a
// scatter-min of the candidates into dist with the invalid slots dropped.
//
// Bound on the card: per slot the four int32 slot streams (coalesced), two
// random reads (dist, w) and one atomic on a random target; a tier step has
// at most 2^18 slots, so the kernel is launch- and latency-bound.
//
// Design: one thread per slot. Min is order-independent, so atomics give the
// plain version's result bit for bit. A float's bits, read as a signed int,
// order like the float when the sign bit is clear, and read as an unsigned
// int they order in reverse when it is set: an atomicMin on the int form
// (sign clear) or an atomicMax on the unsigned form (sign set) is an exact
// float min for either sign. Float64 uses the 64-bit forms. A thread whose
// candidate is not below the target's current value skips the atomic:
// values only fall, so a read that is stale is still an upper bound.
#include "common.cuh"

__device__ __forceinline__ void atomic_min_value(float* addr, float v) {
  if (!signbit(v))
    atomicMin((int*)addr, __float_as_int(v));
  else
    atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_min_value(double* addr, double v) {
  if (!signbit(v))
    atomicMin((long long*)addr, __double_as_longlong(v));
  else
    atomicMax((unsigned long long*)addr,
              (unsigned long long)__double_as_longlong(v));
}

template <typename T>
__global__ void push_relax_min_kernel(const T* __restrict__ dist,
                                      const int* __restrict__ row_ids,
                                      const int* __restrict__ neigh,
                                      const int* __restrict__ gpos,
                                      const bool* __restrict__ valid,
                                      const T* __restrict__ w, T* out,
                                      int e_cap) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_cap || !valid[e]) return;
  const T cand = __ldg(dist + row_ids[e]) + __ldg(w + gpos[e]);
  T* target = out + neigh[e];
  if (cand < *(volatile T*)target) atomic_min_value(target, cand);
}

GT_EXPORT int gt_push_relax_min(const void* dist, const int* row_ids,
                                const int* neigh, const int* gpos,
                                const bool* valid, const void* w, void* out,
                                int e_cap, int is_f64, void* stream) {
  if (e_cap == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (is_f64) {
    push_relax_min_kernel<double><<<gt_blocks(e_cap, threads), threads, 0, s>>>(
        (const double*)dist, row_ids, neigh, gpos, valid, (const double*)w,
        (double*)out, e_cap);
  } else {
    push_relax_min_kernel<float><<<gt_blocks(e_cap, threads), threads, 0, s>>>(
        (const float*)dist, row_ids, neigh, gpos, valid, (const float*)w,
        (float*)out, e_cap);
  }
  return (int)cudaGetLastError();
}
