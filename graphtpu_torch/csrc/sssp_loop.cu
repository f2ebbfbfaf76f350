// K22 sssp_apply: the status and routing of every step of SSSP auto's device
// loop (algorithms/sssp.py), in float32 or float64.
//
// Ports the rounds of graphtpu/algorithms/sssp.py:80-193
// `_sssp_adaptive_kernel`: a full round's `new = minimum(dist, relaxed)` and
// `new < dist` (:67-68, the relaxation itself stays on K7 min_plus), derive's
// `mask_status` (:125-128), `chosen` over the tier ladder (:113-118), the
// phase loops' conditions (:166-179) and their counters (it, counts[T+1]).
// One pass over n vertices, in one of three modes:
// * init (stage 0): dist[v] = 0 at the source, +inf elsewhere, and the mask
//   the source alone (fmask0, :181-182), its count 1 and the source's
//   degree; the pass writes +inf and 0, and the last block reads the source
//   from pinned host memory (one read: a read a block, a host round trip
//   each, took 1.06 ms of the pass at n = 2^20) and sets its two entries,
//   so one graph serves every source;
// * full (stage 1): where relaxed[v] < dist[v], dist[v] = relaxed[v] and
//   mask[v] = 1, else mask[v] = 0 (bit for bit min(dist, relaxed) and its
//   changed mask; relaxed is never NaN);
// * mask (stage 2 + i, after a step of tier i): the mask as K8's in-place
//   mode left it, read only.
// Each counts the marked vertices and sums their out-degrees (64-bit
// atomics, one a block, into a scratch the entry zeroes first); the last
// block to finish stores acnt and ae (saturated at INT32_MAX), adds the step
// to it and to its phase's count, and writes every condition: live = acnt >
// 0 && it < itermax; outer = live; tier i = live && chosen == i; full =
// live && chosen == T, into ctl and, inside the graph, into the conditional
// nodes' handles (cudaGraphSetConditional). So a step's status and routing
// are one launch. Layout of ctl: algorithms/sssp.py SCTL_*.
//
// Bound: bytes. Full mode reads dist and relaxed and writes the mask (and
// the changed entries of dist): 9 bytes a vertex in float32 (n = 2^20: 2.8
// us), 17 in float64; mask mode reads the mask and the marked vertices'
// degrees; init writes dist and the mask.
#include "common.cuh"

// ctl words: algorithms/sssp.py SCTL_* names the same slots
#define SCTL_ACNT 0
#define SCTL_AE 1
#define SCTL_IT 2
#define SCTL_ITERMAX 3
#define SCTL_COND 4  // conditions: outer, tier 0 .. T-1, full; then T + 1 phase counts

#define SSTAGE_INIT 0
#define SSTAGE_FULL 1
#define SSTAGE_TIER 2  // tier i is stage SSTAGE_TIER + i

#define K22_THREADS 256

template <typename T>
__device__ __forceinline__ T k22_inf();
template <>
__device__ __forceinline__ float k22_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double k22_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000ll);
}

// tiers [2 * t]: (rows, edges) of each tier, ascending.
__device__ int k22_chosen(int acnt, int ae, const int* tiers, int t) {
  for (int i = 0; i < t; ++i)
    if (acnt <= tiers[2 * i] && ae <= tiers[2 * i + 1]) return i;
  return t;
}

// acc: [0] marked count, [1] their degree sum, [2] (low word) blocks done.
template <typename T, int STAGE>
__global__ void __launch_bounds__(K22_THREADS)
k22_apply_kernel(T* __restrict__ dist, const T* __restrict__ relaxed, bool* __restrict__ mask,
                 long long n, const int* __restrict__ deg, const int* source,
                 unsigned long long* __restrict__ acc, int* __restrict__ ctl,
                 const int* __restrict__ tiers, int t, int stage, int itermax,
                 const unsigned long long* __restrict__ handles) {
  __shared__ unsigned long long s_c[K22_THREADS / 32], s_e[K22_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long c = 0, e = 0;
  for (long long v = (long long)blockIdx.x * K22_THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * K22_THREADS) {
    bool m = false;
    if (STAGE == SSTAGE_INIT) {
      dist[v] = k22_inf<T>();
      mask[v] = false;
    } else if (STAGE == SSTAGE_FULL) {
      const T r = __ldcs(relaxed + v);
      m = r < dist[v];
      if (m) dist[v] = r;
      mask[v] = m;
    } else {
      m = mask[v];
    }
    if (m) {
      c += 1;
      e += (unsigned long long)(long long)__ldg(deg + v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(0xffffffffu, c, off);
    e += __shfl_xor_sync(0xffffffffu, e, off);
  }
  if (lane == 0) s_c[warp] = c, s_e[warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tc = 0, te = 0;
    for (int u = 0; u < K22_THREADS / 32; ++u) tc += s_c[u], te += s_e[u];
    if (tc) atomicAdd(acc, tc);
    if (te) atomicAdd(acc + 1, te);
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned int*>(acc + 2), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  unsigned long long tc, te;
  if (STAGE == SSTAGE_INIT) {  // every block's writes are done: the source's entries last
    const int src = *(volatile const int*)source;
    dist[src] = T(0);
    mask[src] = true;
    tc = 1;
    te = (unsigned long long)(long long)deg[src];
  } else {
    tc = atomicAdd(acc, 0ull);
    te = atomicAdd(acc + 1, 0ull);
  }
  const int acnt = (int)(tc < GT_INT32_INF ? tc : GT_INT32_INF);
  const int ae = (int)(te < GT_INT32_INF ? te : GT_INT32_INF);
  int* cond = ctl + SCTL_COND;
  int* counts = cond + t + 2;
  ctl[SCTL_ACNT] = acnt;
  ctl[SCTL_AE] = ae;
  if (stage == SSTAGE_INIT) {
    ctl[SCTL_IT] = 0;
    ctl[SCTL_ITERMAX] = itermax;
    for (int i = 0; i <= t; ++i) counts[i] = 0;
  } else {
    ctl[SCTL_IT] += 1;
    counts[stage == SSTAGE_FULL ? t : stage - SSTAGE_TIER] += 1;
  }
  const bool live = acnt > 0 && ctl[SCTL_IT] < ctl[SCTL_ITERMAX];
  const int chosen = k22_chosen(acnt, ae, tiers, t);
  cond[0] = live;
  for (int i = 0; i <= t; ++i) cond[1 + i] = live && chosen == i;
  if (handles)
    for (int j = 0; j < t + 2; ++j)
      cudaGraphSetConditional((cudaGraphConditionalHandle)handles[j], (unsigned int)cond[j]);
}

template <typename T>
static void k22_launch(int stage, unsigned int g, cudaStream_t s, void* dist, const void* relaxed,
                       bool* mask, long long n, const int* deg, const int* source,
                       unsigned long long* acc, int* ctl, const int* tiers, int t, int itermax,
                       const unsigned long long* handles) {
  T* d = (T*)dist;
  const T* r = (const T*)relaxed;
  if (stage == SSTAGE_INIT)
    k22_apply_kernel<T, SSTAGE_INIT><<<g, K22_THREADS, 0, s>>>(d, r, mask, n, deg, source, acc,
                                                               ctl, tiers, t, stage, itermax,
                                                               handles);
  else if (stage == SSTAGE_FULL)
    k22_apply_kernel<T, SSTAGE_FULL><<<g, K22_THREADS, 0, s>>>(d, r, mask, n, deg, source, acc,
                                                               ctl, tiers, t, stage, itermax,
                                                               handles);
  else
    k22_apply_kernel<T, SSTAGE_TIER><<<g, K22_THREADS, 0, s>>>(d, r, mask, n, deg, source, acc,
                                                               ctl, tiers, t, stage, itermax,
                                                               handles);
}

// dist [n] float32/float64 (is_f64), relaxed [n] of the same type (full
// stage only, else null), mask [n] bool, deg [>= n] int32 out-degrees,
// source one int32 in [0, n) the card can read (pinned host memory; init
// only), acc 3
// uint64 of scratch (zeroed here), ctl the loop's control words, tiers [2 *
// t] int32 on the device, stage as above, itermax the rounds' limit (n),
// handles null outside the graph, else t + 2 conditional handles in the
// order of the conditions.
GT_EXPORT int gt_sssp_apply(void* dist, const void* relaxed, bool* mask, long long n,
                            const int* deg, const int* source, unsigned long long* acc, int* ctl,
                            const int* tiers, int t, int stage, int itermax, int is_f64,
                            const unsigned long long* handles, int grid, void* stream) {
  if (n < 0 || !acc || !ctl || !tiers || t < 1 || grid < 1 || stage < 0 ||
      stage >= SSTAGE_TIER + t || (stage == SSTAGE_INIT && (!source || n == 0)) ||
      (stage == SSTAGE_FULL && !relaxed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z = cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned long long), s);
  if (z != cudaSuccess) return (int)z;
  const long long want = (n + K22_THREADS - 1) / K22_THREADS;
  const unsigned int g = (unsigned int)(want < grid ? (want ? want : 1) : grid);
  if (is_f64)
    k22_launch<double>(stage, g, s, dist, relaxed, mask, n, deg, source, acc, ctl, tiers, t,
                       itermax, handles);
  else
    k22_launch<float>(stage, g, s, dist, relaxed, mask, n, deg, source, acc, ctl, tiers, t,
                      itermax, handles);
  return (int)cudaGetLastError();
}
