// K25 fixed_point_route: the end of every step of the one-WHILE fixed-point
// loops (ops/fixed_point.py): sssp-impl=device, wcc-impl=device,
// cdlp-impl=slab and cdlp-impl=sort, each one CUDA graph.
//
// Ports the loop control of graphtpu/algorithms/sssp.py:38-62
// `_sssp_kernel`, graphtpu/algorithms/wcc.py:35-60 `_wcc_kernel`,
// graphtpu/ops/minmode.py:205-233 `_cdlp_slab_kernel` and
// graphtpu/algorithms/cdlp.py:84-120 `_cdlp_sort_kernel`: each is
// `while changed & (it < limit): body`, with changed = `any(new != labels)`
// (WCC, CDLP; sort CDLP's new taken where the vertex has a neighbour, else
// its old label, `where(has_neighbors, best, labels)`), or `any(new < dist)`
// (SSSP), or `(it < skip_checks) | any(...)` (sort CDLP), and it + 1.
// Two modes:
// * compare: old [n] and new [n] int32 (and deg [n], null: every vertex has
//   a neighbour): where new differs from old, old := new, in one pass whose
//   blocks or their "any" into one word; the last block to finish routes.
//   The port ran this as `torch.where`, `(new != labels).any()` and a host
//   read each iteration;
// * flag: the step's changed count or flag is a word on the card that an
//   earlier kernel wrote (K22's changed count for SSSP, K20's ch for WCC):
//   one thread routes.
// The route: at init (stage 0) it = start (0, or 1 where iteration 0 ran
// before the WHILE), limit and skip read from pinned host memory (one read,
// so one graph serves every itermax), cond = it < limit; after a step cond =
// (it < skip || any) && it + 1 < limit and it += 1. cond goes into ctl and,
// inside the graph, into the WHILE node's handle (cudaGraphSetConditional).
//
// Bound: compare mode reads old, new (and deg) and writes the changed labels:
// 8 (12) bytes a vertex, 2.5 (3.8) us at n = 2^20; the others one thread, the
// launch.
#include "common.cuh"

// ctl words: ops/fixed_point.py FCTL_* names the same slots
#define FCTL_IT 0
#define FCTL_LIMIT 1
#define FCTL_SKIP 2
#define FCTL_ANY 3
#define FCTL_COND 4

#define FSTAGE_INIT 0
#define FSTAGE_STEP 1

#define K25_THREADS 256

__device__ void k25_route(int stage, int start, bool any, int* ctl, const int* params,
                          const unsigned long long* handles) {
  int cond;
  if (stage == FSTAGE_INIT) {
    const int limit = ((volatile const int*)params)[0], skip = ((volatile const int*)params)[1];
    ctl[FCTL_IT] = start;
    ctl[FCTL_LIMIT] = limit;
    ctl[FCTL_SKIP] = skip;
    ctl[FCTL_ANY] = 1;
    cond = start < limit;
  } else {
    const int it = ctl[FCTL_IT];
    cond = (it < ctl[FCTL_SKIP] || any) && it + 1 < ctl[FCTL_LIMIT];
    ctl[FCTL_IT] = it + 1;
    ctl[FCTL_ANY] = any;
  }
  ctl[FCTL_COND] = cond;
  if (handles) cudaGraphSetConditional((cudaGraphConditionalHandle)handles[0], (unsigned int)cond);
}

// acc: [0] any, [1] blocks done.
__global__ void __launch_bounds__(K25_THREADS)
k25_compare_kernel(int* __restrict__ old, const int* __restrict__ nw, const int* __restrict__ deg,
                   long long n, unsigned int* __restrict__ acc, int* __restrict__ ctl,
                   const unsigned long long* __restrict__ handles) {
  __shared__ bool s_last;
  bool ch = false;
  for (long long v = (long long)blockIdx.x * K25_THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * K25_THREADS) {
    const int o = old[v];
    const int x = deg && __ldg(deg + v) == 0 ? o : __ldcs(nw + v);
    if (x != o) {
      old[v] = x;
      ch = true;
    }
  }
  const int any = __syncthreads_or(ch);
  if (threadIdx.x == 0) {
    if (any) atomicOr(acc, 1u);
    __threadfence();
    s_last = atomicAdd(acc + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  k25_route(FSTAGE_STEP, 0, atomicOr(acc, 0u) != 0, ctl, nullptr, handles);
}

__global__ void k25_route_kernel(int stage, int start, const int* flag_at, int* ctl,
                                 const int* params, const unsigned long long* handles) {
  k25_route(stage, start, stage == FSTAGE_STEP && *flag_at != 0, ctl, params, handles);
}

// old [n] int32 (updated in place), nw [n] int32 (null: the flag mode), deg
// [n] int32 (null: none), flag_at an int32 on the card (the flag mode's
// changed word), acc 2 uint32 of scratch (zeroed here; compare mode), ctl
// the loop's 5 control words, params (limit, skip) int32 the card can read
// (pinned host memory; init only), stage 0 (init) or 1 (a step), start the
// iterations done before the WHILE, handles null outside the graph, else the
// WHILE node's handle.
GT_EXPORT int gt_fixed_point_route(int* old, const int* nw, const int* deg, long long n,
                                   const int* flag_at, unsigned int* acc, int* ctl,
                                   const int* params, int stage, int start,
                                   const unsigned long long* handles, int grid, void* stream) {
  const bool compare = stage == FSTAGE_STEP && nw;
  if (n < 0 || !ctl || grid < 1 || (stage != FSTAGE_INIT && stage != FSTAGE_STEP) ||
      (stage == FSTAGE_INIT && !params) || (compare && (!old || !acc)) ||
      (stage == FSTAGE_STEP && !nw && !flag_at))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!compare) {
    k25_route_kernel<<<1, 1, 0, s>>>(stage, start, flag_at, ctl, params, handles);
    return (int)cudaGetLastError();
  }
  const cudaError_t z = cudaMemsetAsync(acc, 0, 2 * sizeof(unsigned int), s);
  if (z != cudaSuccess) return (int)z;
  const long long want = (n + K25_THREADS - 1) / K25_THREADS;
  const unsigned int g = (unsigned int)(want < grid ? (want ? want : 1) : grid);
  k25_compare_kernel<<<g, K25_THREADS, 0, s>>>(old, nw, deg, n, acc, ctl, handles);
  return (int)cudaGetLastError();
}
