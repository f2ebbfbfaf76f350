// The device loop's kernels K19 and K20, shared by the loops of CDLP auto
// (ops/active.py) and WCC auto and adaptive (algorithms/wcc.py); the host
// functions that assemble a loop's CUDA graph are in device_loop.cu.
//
// Ports graphtpu/ops/active.py:102-296 `_cdlp_adaptive_kernel`, which runs
// the whole itermax run as one compiled program (nested while_loops, no host
// traffic between iterations), and graphtpu/algorithms/wcc.py:63-185
// `_wcc_adaptive_loop`, whose nest has the same shape (a full phase, a
// derive, an active phase of one tier). The port captures each step (the
// first iteration, a full step, the boundary derive, the boundary's routing,
// one tier step per tier) as a CUDA graph and nests them under conditional
// nodes shaped like the JAX kernels' loops: an outer WHILE holding the full
// phase's WHILE, derive under an IF, the boundary and one WHILE per tier.
// The loop state lives on the device in a small int32 control vector ctl
// (layout: ops/active.py, CTL_*), and K20's route writes every loop
// condition into it and, inside the graph, into the conditional nodes'
// handles.
//
// K19 cdlp_tier_apply ports active.py:194-199 (valid_row, old, changed_row,
// labels.at[...].set) and the any() of :209: for each row r of a tier step,
// id = ids[r] < n and winners[r] != labels[id] marks the row changed and
// writes labels[id] = winners[r] in place (the winners are complete before it
// launches and the ids are distinct, so this equals JAX's functional update);
// rowflag[r] says whether it changed, for K14's row-flag mode, and *ch is 1
// if any row changed. Its min mode is WCC's active-step update
// (graphtpu/algorithms/wcc.py:123-129: winners = min(old, mins), changed =
// winners < old): a row changes when winners[r] < labels[id]. Bound: bytes,
// 13 bytes a row (k = 2^16: 0.26 us); a call costs its launch. Design: one
// thread a row, 1,024 rows a block (k = 2^16: 64 blocks); ids ascend and
// are padded with n, so a block whose first id is pad reads nothing more
// and only clears its flags. *ch is written by the last block to finish,
// from one 64-bit device word that each block adds to once (1, plus 2^32
// when one of its rows changed; one atomic carries both, so no fence is
// needed) and that the last block resets: the entry needs no memset, so a
// call is one kernel node in a graph.
//
// K20 cdlp_route, two entries:
// * status (a full step's, active.py:154-161, :175-178, and
//   graphtpu/ops/frontier.py:48 mask_status): one pass over n vertices that
//   writes mask[v] = next[v] != labels[v] and labels[v] = next[v], counts the
//   changed vertices and sums their degrees (64-bit atomics, one a block, into
//   a scratch the entry zeroes first); the last block to finish sets
//   ctl[ACNT] to -1 (the changed set fits the largest tier: derive at the
//   boundary) or INT32_MAX (stay full), ctl[CH] and the count and edge sum,
//   each saturated at INT32_MAX. Its jump mode is WCC's full step after K21
//   (graphtpu/algorithms/wcc.py:202-207, :94-96): next holds the first
//   pointer jump, and the pass takes min(next[v], next[next[v]]), the second
//   jump, as the new label. Bound: bytes, 10 bytes a vertex read or written
//   (n = 2^20: 3.1 us), the jump's reads at next[next[v]] on top.
// * route (one thread): the stage's update of the loop state (active.py:222,
//   :209 it and nf; :279-287 the boundary's forward-progress rule; the
//   derive's adoption is its writing ctl directly), then every condition:
//   live = ch && it < itermax; outer = live; full = live && acnt ==
//   INT32_MAX; derive = live && acnt == -1; tier i = live && chosen(acnt,
//   ae) == i, chosen being the smallest tier whose (rows, edges) budgets
//   hold the active set (active.py:144-152). Each is stored in ctl and, when
//   a handle array is given (inside the graph), passed to its conditional
//   node by cudaGraphSetConditional. The handles are read from a device
//   array, written once the graph is built, so a step is captured before
//   its handles exist. WCC's loop takes the same stages with one tier, its
//   (rows, edges) capacities, and itermax = n: the JAX conditions changed &
//   it < n & !ok (full), ok (active) are live with acnt at STAY_FULL, and
//   live with the one tier chosen. Bound: a launch.
#include "common.cuh"

// ctl words: ops/active.py CTL_* names the same slots
#define CTL_ACNT 0
#define CTL_AE 1
#define CTL_CH 2
#define CTL_IT 3
#define CTL_NF 4
#define CTL_ITERMAX 5
#define CTL_MCNT 6
#define CTL_MES 7
#define CTL_DERIVES 8
#define CTL_OUTERS 9
#define CTL_COND 10  // conditions: outer, full, derive, tier 0 .. T-1; then T tier-step counts
#define COND_OUTER 0
#define COND_FULL 1
#define COND_DERIVE 2
#define COND_TIER 3

#define STAGE_INIT 0
#define STAGE_FULL 1
#define STAGE_DERIVE 2
#define STAGE_BOUNDARY 3
#define STAGE_TIER 4  // tier i is stage STAGE_TIER + i

#define K19_THREADS 1024
#define K20_THREADS 256

// K19's blocks done (low 32 bits) and blocks with a changed row (high 32
// bits): zero between launches (the last block of each launch resets it)
__device__ unsigned long long k19_state = 0;

template <bool MIN>
__global__ void __launch_bounds__(K19_THREADS)
k19_apply_kernel(int* __restrict__ labels, long long n, const int* __restrict__ ids,
                 const int* __restrict__ winners, long long k, bool* __restrict__ rowflag,
                 int* __restrict__ ch) {
  const long long r0 = (long long)blockIdx.x * K19_THREADS, r = r0 + threadIdx.x;
  int changed = 0;
  if (r0 < k && (long long)ids[r0] < n && r < k) {  // a block of pad ids reads no more
    const int id = ids[r];
    if (id >= 0 && (long long)id < n) {
      const int w = winners[r], old = labels[id];
      changed = MIN ? w < old : w != old;
      if (changed) labels[id] = w;
    }
  }
  if (r < k) rowflag[r] = changed;
  const int any = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    const unsigned long long mine = 1ull + (any ? 1ull << 32 : 0ull);
    const unsigned long long before = atomicAdd(&k19_state, mine);
    if ((unsigned int)before == gridDim.x - 1) {  // the last block: every other add is in before
      *ch = ((before + mine) >> 32) != 0;
      atomicExch(&k19_state, 0ull);
    }
  }
}

// labels [n] int32 (written in place), ids and winners [k] int32, rowflag [k]
// bool, ch one int32 (1 if a row changed, else 0). is_min: the min mode.
GT_EXPORT int gt_cdlp_tier_apply(int* labels, long long n, const int* ids, const int* winners,
                                 long long k, bool* rowflag, int* ch, int is_min, void* stream) {
  if (n < 0 || k < 0 || !ch) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = k ? gt_blocks(k, K19_THREADS) : 1;  // k = 0: one block writes ch
  if (is_min)
    k19_apply_kernel<true><<<blocks, K19_THREADS, 0, s>>>(labels, n, ids, winners, k, rowflag,
                                                         ch);
  else
    k19_apply_kernel<false><<<blocks, K19_THREADS, 0, s>>>(labels, n, ids, winners, k, rowflag,
                                                          ch);
  return (int)cudaGetLastError();
}

// acc: [0] changed count, [1] their degree sum, [2] (low word) blocks done.
template <bool JUMP>
__global__ void __launch_bounds__(K20_THREADS)
k20_status_kernel(int* __restrict__ labels, const int* __restrict__ next, long long n,
                  const int* __restrict__ deg, bool* __restrict__ mask,
                  unsigned long long* __restrict__ acc, int* __restrict__ ctl, long long k_max,
                  long long e_max) {
  __shared__ unsigned long long s_c[K20_THREADS / 32], s_e[K20_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long c = 0, e = 0;
  for (long long v = (long long)blockIdx.x * K20_THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * K20_THREADS) {
    int b = __ldcs(next + v);
    if (JUMP) b = min(b, __ldg(next + b));  // the second pointer jump
    const int a = labels[v];
    const bool m = a != b;
    mask[v] = m;
    if (m) {
      labels[v] = b;
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
    for (int u = 0; u < K20_THREADS / 32; ++u) tc += s_c[u], te += s_e[u];
    if (tc) atomicAdd(acc, tc);
    if (te) atomicAdd(acc + 1, te);
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned int*>(acc + 2), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long tc = atomicAdd(acc, 0ull), te = atomicAdd(acc + 1, 0ull);
    const bool fits = tc <= (unsigned long long)k_max && te <= (unsigned long long)e_max;
    ctl[CTL_ACNT] = fits ? -1 : GT_INT32_INF;
    ctl[CTL_CH] = tc > 0;
    ctl[CTL_MCNT] = (int)(tc < GT_INT32_INF ? tc : GT_INT32_INF);
    ctl[CTL_MES] = (int)(te < GT_INT32_INF ? te : GT_INT32_INF);
  }
}

// labels [n] int32 (set to next), next [n] int32, deg [>= n] int32, mask [n]
// bool, acc: 3 uint64 of scratch (zeroed here), ctl the loop's control words.
// jump: next holds ids in [0, n), and the new labels are min(next[v],
// next[next[v]]).
GT_EXPORT int gt_cdlp_route_status(int* labels, const int* next, long long n, const int* deg,
                                   bool* mask, unsigned long long* acc, int* ctl, long long k_max,
                                   long long e_max, int jump, int grid, void* stream) {
  if (n < 0 || !acc || !ctl || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z = cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned long long), s);
  if (z != cudaSuccess) return (int)z;
  const long long want = (n + K20_THREADS - 1) / K20_THREADS;
  const int g = (int)(want < grid ? (want ? want : 1) : grid);
  if (jump)
    k20_status_kernel<true><<<g, K20_THREADS, 0, s>>>(labels, next, n, deg, mask, acc, ctl, k_max,
                                                      e_max);
  else
    k20_status_kernel<false><<<g, K20_THREADS, 0, s>>>(labels, next, n, deg, mask, acc, ctl,
                                                       k_max, e_max);
  return (int)cudaGetLastError();
}

// tiers [2 * t]: (rows, edges) of each tier, ascending.
__device__ int k20_chosen(int acnt, int ae, const int* tiers, int t) {
  for (int i = 0; i < t; ++i)
    if (acnt >= 0 && acnt <= tiers[2 * i] && ae <= tiers[2 * i + 1]) return i;
  return t;
}

__global__ void k20_route_kernel(int* __restrict__ ctl, const int* __restrict__ tiers, int t,
                                 int stage, const int* __restrict__ itermax,
                                 const unsigned long long* __restrict__ handles) {
  if (threadIdx.x != 0) return;
  int* cond = ctl + CTL_COND;
  int* tier_steps = cond + COND_TIER + t;
  if (stage == STAGE_INIT) {
    ctl[CTL_ITERMAX] = *itermax;
    ctl[CTL_AE] = 0;
    ctl[CTL_IT] = 1;
    ctl[CTL_NF] = 1;
    ctl[CTL_DERIVES] = 0;
    ctl[CTL_OUTERS] = 0;
    for (int i = 0; i < t; ++i) tier_steps[i] = 0;
  } else if (stage == STAGE_FULL) {
    ctl[CTL_IT] += 1;
    ctl[CTL_NF] += 1;
  } else if (stage == STAGE_DERIVE) {
    ctl[CTL_DERIVES] += 1;
  } else if (stage == STAGE_BOUNDARY) {
    ctl[CTL_OUTERS] += 1;
    if (k20_chosen(ctl[CTL_ACNT], ctl[CTL_AE], tiers, t) == t) ctl[CTL_ACNT] = GT_INT32_INF;
  } else {
    ctl[CTL_IT] += 1;
    tier_steps[stage - STAGE_TIER] += 1;
  }
  const int acnt = ctl[CTL_ACNT];
  const bool live = ctl[CTL_CH] != 0 && ctl[CTL_IT] < ctl[CTL_ITERMAX];
  const int chosen = k20_chosen(acnt, ctl[CTL_AE], tiers, t);
  cond[COND_OUTER] = live;
  cond[COND_FULL] = live && acnt == GT_INT32_INF;
  cond[COND_DERIVE] = live && acnt == -1;
  for (int i = 0; i < t; ++i) cond[COND_TIER + i] = live && chosen == i;
  if (handles)
    for (int j = 0; j < COND_TIER + t; ++j)
      cudaGraphSetConditional((cudaGraphConditionalHandle)handles[j], (unsigned int)cond[j]);
}

// ctl the control words, tiers [2 * t] int32 on the device, stage as above,
// itermax one int32 the card can read (pinned host memory; read at
// STAGE_INIT only), handles null outside the graph, else 3 + t conditional
// handles in the order of the conditions.
GT_EXPORT int gt_cdlp_route(int* ctl, const int* tiers, int t, int stage, const int* itermax,
                            const unsigned long long* handles, void* stream) {
  if (!ctl || !tiers || t < 1 || stage < 0 || stage >= STAGE_TIER + t ||
      (stage == STAGE_INIT && !itermax))
    return (int)cudaErrorInvalidValue;
  k20_route_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(ctl, tiers, t, stage, itermax, handles);
  return (int)cudaGetLastError();
}
