// K17 bfs_residual_claim: BFS's bottom-up residual test. For each of the k
// rows i of a frontier expansion (the residual rows, ids rids[i]), whose
// slots are [min(seg_starts[i], e_cap), min(seg_starts[i + 1], e_cap)):
//   out[i] = rids[i]  if a slot s of the row has levels[neigh[s]] == level
//            pad      otherwise
// (an id outside [0, n_levels) is no hit). On one device pad is n; in the
// distributed BFS the levels are the replicated global ones, the rids a
// rank's local rows and pad the rank's row count r.
//
// Replaces graphtpu/algorithms/bfs.py:230-248 (an int32 frontier mask
// padded by one, a gather of it at the expansion's slots, a cumsum
// differenced at the row starts, a where) and the per-rank test of
// graphtpu/parallel/adaptive_bfs.py, which the port ran as K7 in mode
// max_i32 over the clamped row starts (one more segment closing the pad
// slots, gathered and dropped) between about nine torch launches: the
// mask's compare, cast and cat, the indptr's clamp and cat, the > 0 and the
// where.
//
// Bound on an H100: the launch. At BFS auto's first bottom-up step on the
// bench graph (RMAT s20/ef32) the rows are 32,768 slots holding 2,272 rows
// with 12,201 edges in 2^18 slots: 0.3 MB however it is done.
//
// Design: one launch of one wave, no mask and no pad slot read. Groups of
// K17_LANES lanes take rows (a row holds 5.4 slots on average there); a
// group gathers the levels at its row's neighbours K17_LANES at a time,
// tests them against level and stops at its first hit (a ballot over the
// warp). A row past the expansion's real slots has an empty range and
// costs its two starts. The group's first lane writes the row's id or pad.
// Every lane of a warp takes every pass's ballot, a lane whose row is done
// or out of range included (a ballot that some lanes skipped hung the card).
//
// Device-level mode (AT): the level is read from a device word (level_at),
// as K13's, so that one launch captured into BFS auto's CUDA graph serves
// every level.
#include "common.cuh"

#define K17_THREADS 256
#define K17_LANES 8  // lanes a row
#define K17_ROWS (K17_THREADS / K17_LANES)

template <bool AT>
__global__ void __launch_bounds__(K17_THREADS)
k17_claim_kernel(const int* __restrict__ levels, long long n_levels, int level,
                 const int* __restrict__ level_at, const int* __restrict__ neigh,
                 const int* __restrict__ seg_starts, const int* __restrict__ rids, int k,
                 int e_cap, int pad, int* __restrict__ out) {
  if (AT) level = __ldg(level_at);  // every lane, before any branch
  const int lane = threadIdx.x & 31;
  const int sub = lane & (K17_LANES - 1);
  const int shift = lane - sub;  // the group's first lane in the warp
  const unsigned group = ((1u << K17_LANES) - 1) << shift;
  for (int row0 = blockIdx.x * K17_ROWS; row0 < k; row0 += gridDim.x * K17_ROWS) {
    const int i = row0 + threadIdx.x / K17_LANES;
    int lo = 0, hi = 0;
    if (i < k) {
      lo = min(seg_starts[i], e_cap);
      hi = min(seg_starts[i + 1], e_cap);
    }
    bool found = false;
    for (int base = lo;; base += K17_LANES) {
      const int s = base + sub;
      bool hit = false;
      if (!found && s < hi) {
        const int v = neigh[s];
        hit = v >= 0 && (long long)v < n_levels && __ldg(levels + v) == level;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);  // every lane, each pass
      found = found || (ballot & group) != 0;
      if (!__any_sync(0xffffffffu, !found && base + K17_LANES < hi)) break;
    }
    if (i < k && sub == 0) out[i] = found ? rids[i] : pad;
  }
}

// levels [n_levels], neigh [e_cap or more], seg_starts [k + 1], rids and out
// [k], all int32; the level is `level`, or where level_at is not null the
// int32 it points to on the device; grid: the blocks of one wave (the
// wrapper's choice).
GT_EXPORT int gt_bfs_residual_claim(const int* levels, long long n_levels, int level,
                                    const int* level_at, const int* neigh,
                                    const int* seg_starts, const int* rids, int k, int e_cap,
                                    int pad, int* out, int grid, void* stream) {
  if (k < 0 || e_cap < 0 || n_levels < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaGetLastError();
  const unsigned int blocks = gt_blocks(k, K17_ROWS);
  const unsigned int g = blocks < (unsigned int)grid ? blocks : (unsigned int)grid;
  cudaStream_t s = (cudaStream_t)stream;
  if (level_at)
    k17_claim_kernel<true><<<g, K17_THREADS, 0, s>>>(levels, n_levels, level, level_at, neigh,
                                                     seg_starts, rids, k, e_cap, pad, out);
  else
    k17_claim_kernel<false><<<g, K17_THREADS, 0, s>>>(levels, n_levels, level, nullptr, neigh,
                                                      seg_starts, rids, k, e_cap, pad, out);
  return (int)cudaGetLastError();
}
