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

// K8's int32 mode, the distributed WCC's active step: for each slot e in
// [0, total) of an expansion of e_cap slots,
//   out[neigh[e]] = min(out[neigh[e]], labels[row_ids[e] + row_offset])
// where out starts at INT32_INF (the wrapper fills it) and a target at or past
// n_out is dropped. Replaces the scatter-min of
// graphtpu/parallel/adaptive_wcc.py:82-95 (`active_block`: a gather of the
// owners' labels, then .at[targets].min into a vector of INT32_INF), which
// the port ran as scatter_reduce_ amin. Int min is exact in any order, so the
// atomics give the plain version's result bit for bit.
// Bound: the fill of out and, per real slot, row_ids, neigh and a label; an
// active step has a few hundred real slots in 2^18, so launch-bound.
// Design: K5's expansion fills its slots from 0 (valid = slot < total), and
// total is the frontier's degree sum, already on the card: the kernel reads
// it there (no host read, no valid mask) and walks [0, total) as one wave of
// `grid` blocks (about two an SM, the wrapper's choice) in a grid-stride loop.
__global__ void push_relax_min_i32_kernel(const int* __restrict__ labels,
                                          const int* __restrict__ row_ids,
                                          const int* __restrict__ neigh,
                                          const int* __restrict__ total, int* out,
                                          int e_cap, long long row_offset,
                                          long long n_out) {
  int real = *total;
  if (real > e_cap) real = e_cap;
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < real; e += stride) {
    const int t = neigh[e];
    if (t < 0 || (long long)t >= n_out) continue;
    const int cand = __ldg(labels + row_offset + row_ids[e]);
    int* target = out + t;
    if (cand < *(volatile int*)target) atomicMin(target, cand);
  }
}

// total: a device int32, the count of real slots (the rest are pad).
GT_EXPORT int gt_push_relax_min_i32(const int* labels, const int* row_ids,
                                    const int* neigh, const int* total, int* out,
                                    int e_cap, long long row_offset, long long n_out,
                                    int grid, void* stream) {
  if (e_cap < 0 || row_offset < 0 || n_out < 0 || grid < 1 || !total)
    return (int)cudaErrorInvalidValue;
  if (e_cap == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned int blocks = gt_blocks(e_cap, threads);
  push_relax_min_i32_kernel<<<blocks < (unsigned int)grid ? blocks : (unsigned int)grid,
                              threads, 0, (cudaStream_t)stream>>>(
      labels, row_ids, neigh, total, out, e_cap, row_offset, n_out);
  return (int)cudaGetLastError();
}

// K8's in-place mode, SSSP auto's tier round (algorithms/sssp.py): for each
// real slot e in [0, total) of the expansion of the frontier ids [k],
//   dist[neigh[e]] = min(dist[neigh[e]], du[rows_local[e]] + w[gpos[e]])
// in place, where du[r] = dist[ids[r]] as it was before the round, and
// mask[v] = 1 for each vertex v the round lowered (0 elsewhere). Replaces
// the round of graphtpu/algorithms/sssp.py:135-147 (the two gathers, the
// scatter-min into a new vector and derive's `new < dist`), which the port
// ran as dist.clone(), K8 and a comparison. A vertex is lowered exactly
// when some candidate falls below the value it held before the round (the
// first atomic that finds a value above its candidate stores it, and any
// later smaller one lowers it again), so the marks are JAX's `new < dist`;
// the distances are the minimum of the same candidates, exact in any order.
// The candidates read du, a snapshot of the frontier's distances taken by a
// first kernel, so a frontier vertex lowered in the round does not feed a
// candidate of the same round (JAX's rounds are synchronous). The entry
// zeroes the mask (a memset), takes the snapshot (one thread a frontier row;
// a block of pad ids, which ascend, exits at once) and relaxes the slots
// [0, total) in a grid-stride loop of `grid` blocks; total, the expansion's
// edge count, is read on the card. Bound: the mask's memset, per real row
// its id and distance, per real slot rows_local, neigh, gpos, w and the
// target's distance, and the lowered targets' writes: launch-bound at a
// tier round's few thousand slots.
template <typename T>
__device__ __forceinline__ T atomic_min_old(T* addr, T v);

template <>
__device__ __forceinline__ float atomic_min_old(float* addr, float v) {
  if (!signbit(v)) return __int_as_float(atomicMin((int*)addr, __float_as_int(v)));
  return __uint_as_float(atomicMax((unsigned int*)addr, __float_as_uint(v)));
}

template <>
__device__ __forceinline__ double atomic_min_old(double* addr, double v) {
  if (!signbit(v))
    return __longlong_as_double(atomicMin((long long*)addr, __double_as_longlong(v)));
  return __longlong_as_double((long long)atomicMax(
      (unsigned long long*)addr, (unsigned long long)__double_as_longlong(v)));
}

// du (null: none) takes the frontier's distances; clear (null: none) has the
// frontier's entries set to 0 (the settle mode's first half).
template <typename T>
__device__ __forceinline__ void k8_snapshot(const T* __restrict__ dist,
                                            const int* __restrict__ ids, long long k,
                                            long long n, T* __restrict__ du,
                                            bool* __restrict__ clear) {
  const long long r0 = (long long)blockIdx.x * blockDim.x, r = r0 + threadIdx.x;
  if (r0 >= k || (long long)ids[r0] >= n) return;  // a block of pad ids
  if (r < k) {
    const int id = ids[r];
    if (id >= 0 && (long long)id < n) {
      if (du) du[r] = dist[id];
      if (clear) clear[id] = false;
    }
  }
}

template <typename T>
__global__ void k8_snapshot_kernel(const T* __restrict__ dist, const int* __restrict__ ids,
                                   long long k, long long n, T* __restrict__ du) {
  k8_snapshot<T>(dist, ids, k, n, du, nullptr);
}

// The settle mode's own kernels (names of their own, so that a trace tells
// the two modes apart): the snapshot that clears, then the relaxation.
template <typename T>
__global__ void k8_settle_clear_kernel(const T* __restrict__ dist, const int* __restrict__ ids,
                                       long long k, long long n, T* __restrict__ du,
                                       bool* __restrict__ clear) {
  k8_snapshot<T>(dist, ids, k, n, du, clear);
}

template <typename T>
__device__ __forceinline__ void k8_relax_inplace(T* dist, const T* __restrict__ du,
                                                 const int* __restrict__ rows_local,
                                                 const int* __restrict__ neigh,
                                                 const int* __restrict__ gpos,
                                                 const T* __restrict__ w,
                                                 const int* __restrict__ total, int e_cap,
                                                 bool* __restrict__ mask) {
  int real = *total;
  if (real > e_cap) real = e_cap;
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < real; e += stride) {
    const int v = neigh[e];
    const T cand = du[rows_local[e]] + __ldg(w + gpos[e]);
    T* target = dist + v;
    if (cand < *(volatile T*)target && cand < atomic_min_old(target, cand)) mask[v] = true;
  }
}

template <typename T>
__global__ void push_relax_inplace_kernel(T* dist, const T* __restrict__ du,
                                          const int* __restrict__ rows_local,
                                          const int* __restrict__ neigh,
                                          const int* __restrict__ gpos,
                                          const T* __restrict__ w, const int* __restrict__ total,
                                          int e_cap, bool* __restrict__ mask) {
  k8_relax_inplace<T>(dist, du, rows_local, neigh, gpos, w, total, e_cap, mask);
}

template <typename T>
__global__ void push_relax_settle_kernel(T* dist, const T* __restrict__ du,
                                         const int* __restrict__ rows_local,
                                         const int* __restrict__ neigh,
                                         const int* __restrict__ gpos,
                                         const T* __restrict__ w, const int* __restrict__ total,
                                         int e_cap, bool* __restrict__ mask) {
  k8_relax_inplace<T>(dist, du, rows_local, neigh, gpos, w, total, e_cap, mask);
}

template <typename T>
static void k8_inplace(void* dist, const int* ids, long long k, long long n, void* du,
                       const int* rows_local, const int* neigh, const int* gpos, const void* w,
                       const int* total, int e_cap, bool* mask, bool settle, unsigned int grid,
                       cudaStream_t s) {
  const int threads = 256;
  T* snap = e_cap ? (T*)du : nullptr;
  if (k && settle)
    k8_settle_clear_kernel<T><<<gt_blocks(k, threads), threads, 0, s>>>((const T*)dist, ids, k,
                                                                         n, snap, mask);
  else if (k)
    k8_snapshot_kernel<T><<<gt_blocks(k, threads), threads, 0, s>>>((const T*)dist, ids, k, n,
                                                                     snap);
  if (e_cap && settle)
    push_relax_settle_kernel<T><<<grid, threads, 0, s>>>((T*)dist, (const T*)du, rows_local,
                                                         neigh, gpos, (const T*)w, total, e_cap,
                                                         mask);
  else if (e_cap)
    push_relax_inplace_kernel<T><<<grid, threads, 0, s>>>((T*)dist, (const T*)du, rows_local,
                                                          neigh, gpos, (const T*)w, total,
                                                          e_cap, mask);
}

// dist [n] float32/float64 (is_f64; written in place), ids [k] int32 (the
// frontier, ascending, padded with n), du [k] of dist's type (scratch),
// rows_local, neigh, gpos [e_cap] int32 and total (a device int32) of the
// frontier's expansion, w the push weights, mask [n] bool (zeroed here).
GT_EXPORT int gt_push_relax_min_inplace(void* dist, const int* ids, long long k, long long n,
                                        void* du, const int* rows_local, const int* neigh,
                                        const int* gpos, const void* w, const int* total,
                                        int e_cap, bool* mask, int is_f64, int grid,
                                        void* stream) {
  if (k < 0 || n < 0 || e_cap < 0 || grid < 1 || !total || !mask)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n) {
    const cudaError_t z = cudaMemsetAsync(mask, 0, (size_t)n, s);
    if (z != cudaSuccess) return (int)z;
  }
  const unsigned int blocks = e_cap ? gt_blocks(e_cap, 256) : 1;
  const unsigned int g = blocks < (unsigned int)grid ? blocks : (unsigned int)grid;
  if (is_f64)
    k8_inplace<double>(dist, ids, k, n, du, rows_local, neigh, gpos, w, total, e_cap, mask,
                       false, g, s);
  else
    k8_inplace<float>(dist, ids, k, n, du, rows_local, neigh, gpos, w, total, e_cap, mask,
                      false, g, s);
  return (int)cudaGetLastError();
}

// K8's settle mode, delta-stepping's frontier step (algorithms/sssp.py): the
// in-place mode's relaxation, but the mask is the loop's changed set, kept
// across steps: the frontier's own entries are cleared first (by the snapshot
// kernel, which takes the frontier's distances in the same pass), then the
// relaxation marks the vertices it lowered. Replaces
// graphtpu/algorithms/sssp.py:249-256 and :277 / :321 (relax_frontier's two
// gathers and scatter-min into a new vector, `new < dist`, and
// `changed.at[ids].set(False, mode="drop") | improved`), which the port ran
// as K8 into a copy of dist, a compare, a cat, an index_fill_ and an or.
// Clear before mark gives JAX's order: a frontier vertex lowered in the
// step stays marked. e_cap 0 is a class without edges: the frontier's
// entries are cleared and nothing is relaxed (du, rows_local, neigh, gpos, w
// and total may be null). Bound: per frontier row its id, distance and
// mark; per real slot as the in-place mode; launch-sized at a delta step.
GT_EXPORT int gt_push_relax_min_settle(void* dist, const int* ids, long long k, long long n,
                                       void* du, const int* rows_local, const int* neigh,
                                       const int* gpos, const void* w, const int* total,
                                       int e_cap, bool* mask, int is_f64, int grid,
                                       void* stream) {
  if (k < 0 || n < 0 || e_cap < 0 || grid < 1 || !mask || (e_cap && (!total || !du)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = e_cap ? gt_blocks(e_cap, 256) : 1;
  const unsigned int g = blocks < (unsigned int)grid ? blocks : (unsigned int)grid;
  if (is_f64)
    k8_inplace<double>(dist, ids, k, n, du, rows_local, neigh, gpos, w, total, e_cap, mask,
                       true, g, s);
  else
    k8_inplace<float>(dist, ids, k, n, du, rows_local, neigh, gpos, w, total, e_cap, mask,
                      true, g, s);
  return (int)cudaGetLastError();
}
