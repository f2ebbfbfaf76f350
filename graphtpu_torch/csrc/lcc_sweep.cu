// K15 lcc_sweep_member: LCC's membership sweep over one degree bucket of the
// sweep's c-rows (algorithms/lcc.py:sweep_plan). S is the symmetrized
// structure as a CSR (indptr [n + 1], col sorted within each row); a plan
// entry (c[e], o[e]) stands for `weight` A-edges whose endpoint of lower
// degree is c and whose other endpoint is o. For each entry and each
// S-neighbour x of c:
//   numerator[x] += weight   where x is in o's S-row
// (int64 numerators; the triangle (c, o, x) credits x once per stored
// direction of the edge c-o).
//
// Replaces graphtpu/algorithms/lcc.py:55-104 (`_row_member` and
// `_lcc_bucket_sweep`: chunks of A-edges padded to the bucket's width, a
// gather of each chunk's [chunk, pad] neighbours, a branchless binary search
// of each in o's row by search_iters gathers of [chunk, pad] tensors, and a
// scatter-add of the hits). Here a bucket is one launch.
//
// Bound on an H100: operations. Each neighbour x of c costs one search of
// o's row, log2(d(o)) dependent reads that mostly sit in L1 or L2 (hub rows
// are shared by many entries). Bytes read once (the CSR, the entries, the
// numerators) are far less than the searches' reads.
//
// Design. The plan keeps one entry per unordered pair of an undirected graph
// (weight 2): half the searches of one per A-edge. Entries come in runs of
// equal c (the c-rows), and the host cuts each run into work items
// (lcc.py:sweep_items): (e0, e1, xoff) = the entries [e0, e1) of one run and
// the tile of at most 32 of c's neighbours from position xoff. A unit of
// `unit` threads (a warp on the path; the tool passes up to a block, whose
// warps split the item's entries) takes an item:
//   - each lane holds one x of the tile in a register, read once for all of
//     the item's o's;
//   - a tile of xr neighbours gives g = the power of two at or above xr
//     lanes to a search, so a warp searches 32 / g o's at once;
//   - each lane counts its hits in a register; the lanes of one x add their
//     counts by shuffles, and each x gets one 64-bit atomicAdd of weight x
//     count per item, not one per hit.
// A search is a lower-bound binary search of x in o's row that ends when the
// range is empty (the JAX function's fixed search_iters steps give the same
// answer: membership does not depend on the search's order). Its reads are a
// chain of dependent loads, so a lane runs `ilp` searches (of as many o's) in
// step, their loads issued together: the path runs 4 from pad 1,024 on and 1
// below it (lcc.py:k15_ilp), the faster of the two per bucket on the bench
// graph (tools/lcc_sweep_times.py times both). Two designs that shortened
// the searches by samples of the o-rows (a warp's 32 in registers; every
// 32nd entry in shared memory, a block an item) were slower in every bucket
// (PERF.md, section 6).
// Numerators are integers added in any order, so every launch equals the
// plain version bit for bit.
//
// Probes. A build with K15_PROBES defined (tools/lcc_sweep_times.py's own,
// never the path's) also exports gt_lcc_sweep_member_probe, whose probe bits
// drop the atomics (K15_NO_ATOMICS) or cut each search to K15_DEPTH_STEPS
// steps (K15_DEPTH): wrong numerators, a time that shows where the time goes.
#include <limits.h>

#include "common.cuh"

#define LCC_THREADS 256
#define K15_NO_ATOMICS 1
#define K15_DEPTH 2
#define K15_DEPTH_STEPS 4
#define K15_FULL 0xffffffffu

// Lower-bound searches of x in col[lo[u], hi[u]) for u < U, in step; the
// hits (x found) of those whose range was not empty.
template <int PROBE, int U>
__device__ __forceinline__ int k15_members(const int* __restrict__ col, int (&lo)[U],
                                           int (&hi)[U], int x) {
  int end[U];
#pragma unroll
  for (int u = 0; u < U; ++u) end[u] = hi[u];
  for (int steps = 0;; ++steps) {
    if ((PROBE & K15_DEPTH) && steps == K15_DEPTH_STEPS) break;
    bool more = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (lo[u] < hi[u]) {
        more = true;
        const int mid = (int)(((unsigned int)lo[u] + (unsigned int)hi[u]) >> 1);
        if (__ldg(col + mid) < x) lo[u] = mid + 1; else hi[u] = mid;
      }
    }
    if (!more) break;
  }
  int hits = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) hits += lo[u] < end[u] && __ldg(col + lo[u]) == x;
  return hits;
}

template <int PROBE, int U>
__global__ void __launch_bounds__(LCC_THREADS)
lcc_sweep_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                 const int* __restrict__ c, const int* __restrict__ o,
                 const int* __restrict__ items, long long n_items, int weight, int unit_shift,
                 unsigned long long* numerator) {
  const long long item = ((long long)blockIdx.x * LCC_THREADS + threadIdx.x) >> unit_shift;
  if (item >= n_items) return;  // the whole unit shares one item
  const int lane = threadIdx.x & 31;
  const int warps = 1 << (unit_shift - 5);
  const int warp = (threadIdx.x & ((1 << unit_shift) - 1)) >> 5;
  const int e0 = __ldg(items + 3 * item), e1 = __ldg(items + 3 * item + 1);
  const int xoff = __ldg(items + 3 * item + 2);
  const int cc = __ldg(c + e0);
  const int cb = __ldg(indptr + cc);
  const int xr = min(32, __ldg(indptr + cc + 1) - cb - xoff);
  const int gs = xr <= 1 ? 0 : 32 - __clz(xr - 1);  // g = 2^gs lanes a search
  const int xl = lane & ((1 << gs) - 1);
  const bool vx = xl < xr;
  const int x = vx ? __ldg(col + cb + xoff + xl) : INT_MAX;
  const int per = 32 >> gs;  // o's a warp searches at once
  int cnt = 0;
  for (int k = e0 + warp * per * U + (lane >> gs); k < e1; k += warps * per * U) {
    int lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * per;
      const int oo = vx && kk < e1 ? __ldg(o + kk) : -1;
      lo[u] = oo < 0 ? 0 : __ldg(indptr + oo);
      hi[u] = oo < 0 ? 0 : __ldg(indptr + oo + 1);
    }
    cnt += k15_members<PROBE, U>(col, lo, hi, x);
  }
  for (int off = 1 << gs; off < 32; off <<= 1) cnt += __shfl_xor_sync(K15_FULL, cnt, off);
  if (PROBE & K15_NO_ATOMICS) {
    if (cnt < 0) numerator[0] = 0;  // never: keeps the searches live
  } else if (lane < xr && cnt) {
    atomicAdd(numerator + x, (unsigned long long)weight * (unsigned long long)cnt);
  }
}

typedef void (*k15_fn)(const int*, const int*, const int*, const int*, const int*, long long,
                       int, int, unsigned long long*);

// fns: the kernel at ilp 1 and 4.
static int k15_launch(const k15_fn (&fns)[2], const int* indptr, const int* col, const int* c,
                      const int* o, const int* items, long long n_items, int weight, int unit,
                      int ilp, long long* numerator, void* stream) {
  if (n_items < 0 || unit < 32 || unit > LCC_THREADS || (unit & (unit - 1)) || weight < 1 ||
      weight > 2 || (ilp != 1 && ilp != 4))
    return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaGetLastError();
  if (n_items > (0x7fffffffLL * LCC_THREADS) / unit) return (int)cudaErrorInvalidValue;
  fns[ilp == 4]<<<gt_blocks(n_items * unit, LCC_THREADS), LCC_THREADS, 0,
                  (cudaStream_t)stream>>>(indptr, col, c, o, items, n_items, weight,
                                          __builtin_ctz(unit), (unsigned long long*)numerator);
  return (int)cudaGetLastError();
}

// indptr [n + 1] and col of S; c, o [p] int32 (ids in [0, n)); items
// [n_items, 3] int32 (e0, e1, xoff); weight 1 or 2; unit: the threads an item,
// a power of two from 32 to LCC_THREADS; ilp: the searches a lane runs in
// step, 1 or 4; numerator [n] int64, added to in place.
GT_EXPORT int gt_lcc_sweep_member(const int* indptr, const int* col, const int* c, const int* o,
                                  const int* items, long long n_items, int weight, int unit,
                                  int ilp, long long* numerator, void* stream) {
  static const k15_fn fns[2] = {lcc_sweep_kernel<0, 1>, lcc_sweep_kernel<0, 4>};
  return k15_launch(fns, indptr, col, c, o, items, n_items, weight, unit, ilp, numerator,
                    stream);
}

#ifdef K15_PROBES
// As gt_lcc_sweep_member, under the probe bits `probe` (0 to 3).
GT_EXPORT int gt_lcc_sweep_member_probe(const int* indptr, const int* col, const int* c,
                                        const int* o, const int* items, long long n_items,
                                        int weight, int unit, int ilp, int probe,
                                        long long* numerator, void* stream) {
  static const k15_fn fns[4][2] = {
      {lcc_sweep_kernel<0, 1>, lcc_sweep_kernel<0, 4>},
      {lcc_sweep_kernel<1, 1>, lcc_sweep_kernel<1, 4>},
      {lcc_sweep_kernel<2, 1>, lcc_sweep_kernel<2, 4>},
      {lcc_sweep_kernel<3, 1>, lcc_sweep_kernel<3, 4>}};
  if (probe < 0 || probe > 3) return (int)cudaErrorInvalidValue;
  return k15_launch(fns[probe], indptr, col, c, o, items, n_items, weight, unit, ilp, numerator,
                    stream);
}
#endif
