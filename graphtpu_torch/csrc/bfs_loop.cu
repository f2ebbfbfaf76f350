// K23 bfs_apply: the status, update and routing of every step of BFS's
// device loops (algorithms/bfs.py): BFS auto's phases and bfs-impl=device's
// dense steps.
//
// Ports the step ends of graphtpu/algorithms/bfs.py:87 `_bfs_adaptive_kernel`
// and :39 `_bfs_kernel`: the source's level and status (:287-288), a tier
// step's `applied` and its level scatter (:194-209), the bottom-up's `ok`,
// its claims and status (:233-260), the dense step's new frontier and
// status (:57-59, :78-79, :271), `chosen` over the tier ladder (:154-160,
// :274-276), the phase loops' conditions (:278-298) and the per-phase
// counters, aborted steps included. The level, the frontier's count and
// edge sum, min_tier and the counters live in an int32 control vector, so
// one captured launch serves every level. One pass, in one of four modes:
// * init (stage 0): levels := INT32_INF and the dense frontier fmask := 0;
//   the last block reads the source from pinned host memory (one read, not
//   one a block) and sets levels[source] = 0, fmask[source] = 1, count 1
//   and the source's out-degree;
// * tier i (stage 3 + i), after a push step whose K14 wrote its new
//   frontier ids [k] (deduped, ascending, padded with n) with their true
//   count and degree sum: applied = count <= k; only then the ids get level
//   + 1 and become the frontier; else min_tier = i + 1. No pass over n;
// * bottom-up (stage 1), after K13's claim mask, the residual rows' K14
//   count and in-degree sum and K17's claimed ids [k_bu]: ok = count <= k_bu
//   and sum <= e_bu; only then the claims and the claimed ids get level + 1
//   and are counted as the new frontier (the two are disjoint: a claimed row
//   missed the probe, and no vertex held level + 1 before), else min_tier =
//   dense and fmask := levels == level, the frontier the dense step reads;
// * dense (stage 2), after K7 max_i32 over fmask: the unvisited vertices it
//   reached get level + 1 and are the new fmask and frontier.
// Each counts the new frontier and sums its out-degrees (64-bit atomics, one
// a block, into a scratch the entry zeroes first); the last block to finish
// stores count and sum, the level, min_tier and the counters, and writes
// every condition: outer = count > 0 && level < levelmax; phase j = outer &&
// chosen == j, chosen = max(first_fit(count, sum), min_tier) (tiers 0..T-1,
// bottom-up T, dense T + 1), into ctl and, inside the graph, into the first
// nh conditional nodes' handles (cudaGraphSetConditional). So a step's
// update, status and routing are one launch. Layout of ctl: algorithms/
// bfs.py BCTL_*.
//
// Bound: bytes, or the launch. Init writes levels and fmask (8 B a vertex:
// 2.5 us at n = 2^20); dense reads levels and reached and writes fmask (12 B
// a vertex) and the new levels; bottom-up reads the claims (1 B a vertex,
// 5 more for an abort's levels and fmask) and the claimed ids; a tier step
// reads and scatters its k ids (at most 1 MB at k = 2^18).
#include "common.cuh"

// ctl words: algorithms/bfs.py BCTL_* names the same slots
#define BCTL_CNT 0
#define BCTL_FE 1
#define BCTL_LEVEL 2
#define BCTL_MINTIER 3
#define BCTL_LEVELMAX 4
#define BCTL_COND 5  // conditions: outer, tier 0 .. T-1, bottom-up, dense; then T + 2 counts

#define BSTAGE_INIT 0
#define BSTAGE_BU 1
#define BSTAGE_DENSE 2
#define BSTAGE_TIER 3  // tier i is stage BSTAGE_TIER + i

#define K23_THREADS 256

// tiers [2 * t]: (rows, edges) of each tier, ascending; t (bottom-up) if none fits.
__device__ int k23_first_fit(int cnt, int fe, const int* tiers, int t) {
  for (int i = 0; i < t; ++i)
    if (cnt <= tiers[2 * i] && fe <= tiers[2 * i + 1]) return i;
  return t;
}

__device__ __forceinline__ void k23_mark(int* __restrict__ levels, int v, int next,
                                         const int* __restrict__ deg, unsigned long long& c,
                                         unsigned long long& e) {
  levels[v] = next;
  c += 1;
  if (deg) e += (unsigned long long)(long long)__ldg(deg + v);
}

// acc: [0] the new frontier's count, [1] its out-degree sum, [2] (low word)
// blocks done. `go` of a tier step (applied) and of the bottom-up (ok) is
// read by every block from stat, written by the step's K14 before.
template <int STAGE>
__global__ void __launch_bounds__(K23_THREADS)
k23_apply_kernel(int* __restrict__ levels, long long n, int* __restrict__ fmask,
                 const int* __restrict__ reached, const bool* __restrict__ claim,
                 const int* __restrict__ ids, long long k, const int* __restrict__ stat,
                 const int* __restrict__ deg, const int* source,
                 unsigned long long* __restrict__ acc, int* __restrict__ ctl,
                 const int* __restrict__ tiers, int t, int stage, int k_bu, int e_bu,
                 int itermax, const unsigned long long* __restrict__ handles, int nh) {
  __shared__ unsigned long long s_c[K23_THREADS / 32], s_e[K23_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every block reads the level before its ticket; the last block writes it
  const int lv = ctl[BCTL_LEVEL], next = lv + 1;
  bool go = true;
  if (STAGE == BSTAGE_TIER) go = (long long)stat[0] <= k;
  if (STAGE == BSTAGE_BU) go = stat[0] <= k_bu && stat[1] <= e_bu;
  const long long stride = (long long)gridDim.x * K23_THREADS;
  const long long first = (long long)blockIdx.x * K23_THREADS + threadIdx.x;
  unsigned long long c = 0, e = 0;
  if (STAGE == BSTAGE_INIT) {
    for (long long v = first; v < n; v += stride) {
      levels[v] = GT_INT32_INF;
      fmask[v] = 0;
    }
  } else if (STAGE == BSTAGE_TIER) {
    if (go)
      for (long long j = first; j < k; j += stride) {
        const int v = ids[j];
        if (v >= 0 && (long long)v < n) levels[v] = next;
      }
  } else if (STAGE == BSTAGE_BU) {
    if (go) {
      for (long long v = first; v < n; v += stride)
        if (claim[v]) k23_mark(levels, (int)v, next, deg, c, e);
      for (long long j = first; j < k; j += stride) {
        const int v = ids[j];
        if (v >= 0 && (long long)v < n) k23_mark(levels, v, next, deg, c, e);
      }
    } else {
      for (long long v = first; v < n; v += stride) fmask[v] = levels[v] == lv;
    }
  } else {  // dense
    for (long long v = first; v < n; v += stride) {
      const bool nf = levels[v] == GT_INT32_INF && __ldcs(reached + v) == 1;
      if (nf) k23_mark(levels, (int)v, next, deg, c, e);
      fmask[v] = nf;
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
    for (int u = 0; u < K23_THREADS / 32; ++u) tc += s_c[u], te += s_e[u];
    if (tc) atomicAdd(acc, tc);
    if (te) atomicAdd(acc + 1, te);
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned int*>(acc + 2), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  int* cond = ctl + BCTL_COND;
  int* counts = cond + t + 3;
  int cnt = ctl[BCTL_CNT], fe = ctl[BCTL_FE], level = lv, min_tier = ctl[BCTL_MINTIER];
  if (STAGE == BSTAGE_INIT) {  // every block's writes are done: the source's entries last
    const int src = *(volatile const int*)source;
    levels[src] = 0;
    fmask[src] = 1;
    cnt = 1;
    fe = deg ? deg[src] : 0;
    level = min_tier = 0;
    ctl[BCTL_LEVELMAX] = itermax;
    for (int j = 0; j < t + 2; ++j) counts[j] = 0;
  } else if (STAGE == BSTAGE_TIER) {
    const int i = stage - BSTAGE_TIER;
    if (go) {
      cnt = stat[0];
      fe = stat[1];
      level = next;
      min_tier = 0;
    } else {
      min_tier = i + 1;
    }
    counts[i] += 1;
  } else {
    if (go) {
      const unsigned long long tc = atomicAdd(acc, 0ull), te = atomicAdd(acc + 1, 0ull);
      cnt = (int)(tc < GT_INT32_INF ? tc : GT_INT32_INF);
      fe = (int)(te < GT_INT32_INF ? te : GT_INT32_INF);
      level = next;
      min_tier = 0;
    } else {
      min_tier = t + 1;  // a bottom-up that overflowed: the level goes dense
    }
    counts[STAGE == BSTAGE_BU ? t : t + 1] += 1;
  }
  ctl[BCTL_CNT] = cnt;
  ctl[BCTL_FE] = fe;
  ctl[BCTL_LEVEL] = level;
  ctl[BCTL_MINTIER] = min_tier;
  const bool outer = cnt > 0 && level < ctl[BCTL_LEVELMAX];
  const int ff = k23_first_fit(cnt, fe, tiers, t);
  const int chosen = ff > min_tier ? ff : min_tier;
  cond[0] = outer;
  for (int j = 0; j < t + 2; ++j) cond[1 + j] = outer && chosen == j;
  if (handles)
    for (int j = 0; j < nh; ++j)
      cudaGraphSetConditional((cudaGraphConditionalHandle)handles[j], (unsigned int)cond[j]);
}

// levels [n] int32; fmask [n] int32 (the dense frontier); reached [n] int32
// (dense stage only, else null); claim [n] bool (bottom-up only); ids [k]
// int32 (a tier step's new frontier, the bottom-up's claimed ids; padded
// with n); stat the step's K14 count and degree sum (tier, bottom-up); deg
// [>= n] int32 out-degrees (null: sums of 0); source one int32 in [0, n)
// the card can read (pinned host memory; init only); acc 3 uint64 of
// scratch (zeroed here); ctl the loop's control words; tiers [2 * t] int32
// on the device (null when t is 0); k_bu, e_bu the bottom-up's budgets;
// itermax the levels' limit (n); handles null outside the graph, else the
// nh conditional handles of the nest's first nh conditions.
GT_EXPORT int gt_bfs_apply(int* levels, long long n, int* fmask, const int* reached,
                           const bool* claim, const int* ids, long long k, const int* stat,
                           const int* deg, const int* source, unsigned long long* acc, int* ctl,
                           const int* tiers, int t, int stage, int k_bu, int e_bu, int itermax,
                           const unsigned long long* handles, int nh, int grid, void* stream) {
  if (n < 1 || k < 0 || !levels || !fmask || !acc || !ctl || t < 0 || (t && !tiers) ||
      grid < 1 || stage < 0 || stage >= BSTAGE_TIER + t || nh < 0 || nh > t + 3 ||
      (stage == BSTAGE_INIT && !source) || (stage == BSTAGE_DENSE && !reached) ||
      (stage == BSTAGE_BU && !claim) ||
      (stage != BSTAGE_INIT && stage != BSTAGE_DENSE && !stat) || (k && !ids))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z = cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned long long), s);
  if (z != cudaSuccess) return (int)z;
  const long long work = stage >= BSTAGE_TIER ? k : n;
  const long long want = (work + K23_THREADS - 1) / K23_THREADS;
  const unsigned int g = (unsigned int)(want < grid ? (want ? want : 1) : grid);
#define K23_LAUNCH(ST)                                                                     \
  k23_apply_kernel<ST><<<g, K23_THREADS, 0, s>>>(levels, n, fmask, reached, claim, ids, k, \
                                                 stat, deg, source, acc, ctl, tiers, t,    \
                                                 stage, k_bu, e_bu, itermax, handles, nh)
  if (stage == BSTAGE_INIT)
    K23_LAUNCH(BSTAGE_INIT);
  else if (stage == BSTAGE_BU)
    K23_LAUNCH(BSTAGE_BU);
  else if (stage == BSTAGE_DENSE)
    K23_LAUNCH(BSTAGE_DENSE);
  else
    K23_LAUNCH(BSTAGE_TIER);
#undef K23_LAUNCH
  return (int)cudaGetLastError();
}
