// K24 sssp_delta_route: the status and routing of every step of
// delta-stepping's device loop (algorithms/sssp.py, sssp-impl=delta), in
// float32 or float64.
//
// Ports the control of graphtpu/algorithms/sssp.py:211-365
// `_sssp_delta_kernel`: the source's distance and changed bit (:339-340), the
// derives' `fits` and `any` (:258-261, :294-297), the phase loops'
// conditions (:266-268, :285-287, :305-308, :324-327, :347-349), the bucket
// advance `k_next = min(where(bucket(dist) > k, bucket(dist), imax))`
// (:358-359) and the step counter it against its 4n limit; and the port's
// counters of buckets and of light-active, light-dense, heavy-active and
// heavy-dense steps. The steps' relaxations stay on K5, K7, K8 (its settle
// mode), K18 and K22, and their derives' compactions on K14's bucket mode,
// which writes the count and degree sum this kernel reads.
//
// Stages (algorithms/sssp.py DSTAGE_*):
// * init: dist = +inf and changed = 0 over every vertex; the last block reads
//   the source from pinned host memory (one read, as K22), sets its distance
//   to 0 and its changed bit, and zeroes the loop's words;
// * after derive_light, a light step or a light dense step: buckets or the
//   step's count and it; inner = any && it < limit, light_active = inner &&
//   fits, light_dense = inner && !fits;
// * after derive_heavy: heavy_active = it < limit && fits, heavy_dense = it <
//   limit && !fits;
// * after a heavy or heavy dense step: its count and it;
// * advance: the smallest bucket above k over every vertex (each block's
//   maximum of INT32_INF - bucket into one word by atomicMax, the word zeroed
//   by a memset in the entry: 0 stands for none, INT32_INF), then outer = k <
//   INT32_INF && it < limit.
// fits = count <= k_cap && degree sum <= e_cap, any = count > 0, from K14's
// status words. Every stage writes the six conditions into the graph's
// conditional handles when it is given them (cudaGraphSetConditional).
//
// Bound: the init and advance stages are one pass over n distances (4 or 8
// bytes each, plus the changed mask at init): bytes; the others are one
// thread: the launch.
#include "common.cuh"

// ctl words: algorithms/sssp.py DCTL_* names the same slots
#define DCTL_K 0
#define DCTL_IT 1
#define DCTL_LIMIT 2
#define DCTL_CNT 3
#define DCTL_FE 4
#define DCTL_COND 5    // outer, inner, light_active, light_dense, heavy_active, heavy_dense
#define DCTL_NCOND 6
#define DCTL_COUNTS 11  // buckets, light_active, light_dense, heavy_active, heavy_dense
#define DCTL_NCOUNTS 5
#define DCTL_WORDS 16

#define DSTAGE_INIT 0
#define DSTAGE_DERIVE_LIGHT 1
#define DSTAGE_LIGHT 2
#define DSTAGE_DENSE_LIGHT 3
#define DSTAGE_DERIVE_HEAVY 4
#define DSTAGE_HEAVY 5
#define DSTAGE_DENSE_HEAVY 6
#define DSTAGE_ADVANCE 7

#define K24_THREADS 256

template <typename T>
__device__ __forceinline__ T k24_inf();
template <>
__device__ __forceinline__ float k24_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double k24_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000ll);
}

// The route of a stage, by the one thread that runs it; the advance's
// minimum, INT32_INF - its word, comes in best.
template <typename T>
__device__ void k24_route(int stage, T* dist, bool* mask, const int* source, int* ctl,
                          int limit, int k_cap, int e_cap, unsigned int best,
                          const unsigned long long* handles) {
  int* cond = ctl + DCTL_COND;
  int* counts = ctl + DCTL_COUNTS;
  const bool fits = ctl[DCTL_CNT] <= k_cap && ctl[DCTL_FE] <= e_cap;
  switch (stage) {
    case DSTAGE_INIT: {
      const int src = *(volatile const int*)source;
      dist[src] = T(0);
      mask[src] = true;
      for (int i = 0; i < DCTL_WORDS; ++i) ctl[i] = 0;
      ctl[DCTL_LIMIT] = limit;
      cond[0] = 0 < limit;
      break;
    }
    case DSTAGE_DERIVE_LIGHT:
    case DSTAGE_LIGHT:
    case DSTAGE_DENSE_LIGHT: {
      if (stage == DSTAGE_DERIVE_LIGHT) {
        counts[0] += 1;
      } else {
        ctl[DCTL_IT] += 1;
        counts[stage == DSTAGE_LIGHT ? 1 : 2] += 1;
      }
      const bool inner = ctl[DCTL_CNT] > 0 && ctl[DCTL_IT] < ctl[DCTL_LIMIT];
      cond[1] = inner;
      cond[2] = inner && fits;
      cond[3] = inner && !fits;
      break;
    }
    case DSTAGE_DERIVE_HEAVY: {
      const bool live = ctl[DCTL_IT] < ctl[DCTL_LIMIT];
      cond[4] = live && fits;
      cond[5] = live && !fits;
      break;
    }
    case DSTAGE_HEAVY:
    case DSTAGE_DENSE_HEAVY:
      ctl[DCTL_IT] += 1;
      counts[stage == DSTAGE_HEAVY ? 3 : 4] += 1;
      break;
    default:  // DSTAGE_ADVANCE
      ctl[DCTL_K] = GT_INT32_INF - (int)best;
      cond[0] = ctl[DCTL_K] < GT_INT32_INF && ctl[DCTL_IT] < ctl[DCTL_LIMIT];
  }
  if (handles)
    for (int j = 0; j < DCTL_NCOND; ++j)
      cudaGraphSetConditional((cudaGraphConditionalHandle)handles[j], (unsigned int)cond[j]);
}

// The init and advance stages: a pass over the vertices, then the last block
// to finish routes. acc: [0] the advance's word, [1] blocks done.
template <typename T, int STAGE>
__global__ void __launch_bounds__(K24_THREADS)
k24_pass_kernel(T* __restrict__ dist, bool* __restrict__ mask, long long n, T inv,
                const int* source, unsigned int* __restrict__ acc, int* __restrict__ ctl,
                int limit, int k_cap, int e_cap, const unsigned long long* __restrict__ handles) {
  __shared__ unsigned int s_best[K24_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every block reads k before the last block writes it: a block counts
  // itself done only after its pass
  const int k = STAGE == DSTAGE_ADVANCE ? ctl[DCTL_K] : 0;
  unsigned int best = 0;  // INT32_INF - the smallest bucket above k seen
  for (long long v = (long long)blockIdx.x * K24_THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * K24_THREADS) {
    if (STAGE == DSTAGE_INIT) {
      dist[v] = k24_inf<T>();
      mask[v] = false;
    } else {
      const int b = gt_delta_bucket(__ldcs(dist + v), inv);
      if (b > k) {
        const unsigned int c = (unsigned int)(GT_INT32_INF - b);
        best = c > best ? c : best;
      }
    }
  }
  if (STAGE == DSTAGE_ADVANCE) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned int o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0) s_best[warp] = best;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (STAGE == DSTAGE_ADVANCE) {
      unsigned int b = 0;
      for (int u = 0; u < K24_THREADS / 32; ++u) b = s_best[u] > b ? s_best[u] : b;
      if (b) atomicMax(acc, b);
    }
    __threadfence();
    s_last = atomicAdd(acc + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  k24_route<T>(STAGE, dist, mask, source, ctl, limit, k_cap, e_cap,
               STAGE == DSTAGE_ADVANCE ? atomicAdd(acc, 0u) : 0u, handles);
}

// The routes that read only the control words: one thread.
template <typename T>
__global__ void k24_route_kernel(int stage, int* ctl, int k_cap, int e_cap,
                                 const unsigned long long* handles) {
  k24_route<T>(stage, nullptr, nullptr, nullptr, ctl, 0, k_cap, e_cap, 0u, handles);
}

template <typename T>
static int k24_launch(int stage, unsigned int g, cudaStream_t s, void* dist, bool* mask,
                      long long n, double inv, const int* source, unsigned int* acc, int* ctl,
                      int limit, int k_cap, int e_cap, const unsigned long long* handles) {
  if (stage == DSTAGE_INIT)
    k24_pass_kernel<T, DSTAGE_INIT><<<g, K24_THREADS, 0, s>>>(
        (T*)dist, mask, n, (T)inv, source, acc, ctl, limit, k_cap, e_cap, handles);
  else if (stage == DSTAGE_ADVANCE)
    k24_pass_kernel<T, DSTAGE_ADVANCE><<<g, K24_THREADS, 0, s>>>(
        (T*)dist, mask, n, (T)inv, source, acc, ctl, limit, k_cap, e_cap, handles);
  else
    k24_route_kernel<T><<<1, 1, 0, s>>>(stage, ctl, k_cap, e_cap, handles);
  return (int)cudaGetLastError();
}

// dist [n] float32/float64 (is_f64), mask [n] bool (the changed set), inv
// 1 / delta in the run's type, source one int32 in [0, n) the card can read
// (pinned host memory; init only), acc 2 uint32 of scratch (zeroed here;
// init and advance only), ctl the loop's DCTL_WORDS control words, stage as
// above, limit the steps' limit (4n), k_cap and e_cap the frontier's
// capacities, handles null outside the graph, else DCTL_NCOND conditional
// handles in the order of the conditions.
GT_EXPORT int gt_sssp_delta_route(void* dist, bool* mask, long long n, double inv,
                                  const int* source, unsigned int* acc, int* ctl, int stage,
                                  int limit, int k_cap, int e_cap, int is_f64,
                                  const unsigned long long* handles, int grid, void* stream) {
  const bool pass = stage == DSTAGE_INIT || stage == DSTAGE_ADVANCE;
  if (n < 0 || !ctl || grid < 1 || stage < DSTAGE_INIT || stage > DSTAGE_ADVANCE ||
      (pass && (!dist || !acc)) || (stage == DSTAGE_INIT && (!source || !mask || n == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int g = 1;
  if (pass) {
    const cudaError_t z = cudaMemsetAsync(acc, 0, 2 * sizeof(unsigned int), s);
    if (z != cudaSuccess) return (int)z;
    const long long want = (n + K24_THREADS - 1) / K24_THREADS;
    g = (unsigned int)(want < grid ? (want ? want : 1) : grid);
  }
  if (is_f64)
    return k24_launch<double>(stage, g, s, dist, mask, n, inv, source, acc, ctl, limit, k_cap,
                              e_cap, handles);
  return k24_launch<float>(stage, g, s, dist, mask, n, inv, source, acc, ctl, limit, k_cap,
                           e_cap, handles);
}
