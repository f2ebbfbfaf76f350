// K15 lcc_sweep_member: LCC's membership sweep over one degree bucket of
// A-edges. For each A-edge i, with c = c[i] its endpoint of lower degree in
// the symmetrized structure S (a CSR: indptr [n + 1], col sorted within each
// row) and o = o[i] the other endpoint, and each S-neighbour x of c:
//   numerator[x] += 1   where x is in o's S-row
// (int64 numerators; the triangle (c, o, x) credits x once per stored
// direction of the edge c-o).
//
// Replaces graphtpu/algorithms/lcc.py:55-104 (`_row_member` and
// `_lcc_bucket_sweep`: chunks of A-edges padded to the bucket's width, a
// gather of each chunk's [chunk, pad] neighbours, a branchless binary search
// of each in o's row by search_iters gathers of [chunk, pad] tensors, and a
// scatter-add of the hits), which the port ran as K1 gathers, torch ops and
// index_add_ in a host loop over chunks. Here a bucket is one launch.
//
// Bound on an H100: operations. Each neighbour x of c costs one binary search
// of log2(d(o)) dependent reads of o's row, which mostly sit in L2 (hub rows
// are shared by many A-edges), and each hit one 64-bit atomic on a random
// numerator. Bytes read once (the CSR, the A-edge lists, the numerators) are
// far less than the searches' reads.
//
// Design: a unit of `unit` threads (32, 64, 128 or 256: a warp up to a
// whole block) takes an A-edge, and its threads take c's neighbours in turn
// (coalesced reads of c's row). The path takes a warp for every bucket
// (`algorithms/lcc.py:K15_UNIT`): on the bench graph a warp is within 3 % of
// the best unit per bucket over the whole sweep, and a split at pad 128 (a
// block above) was 5 % slower (`tools/lcc_sweep_times.py`, which alone
// passes other units). Each thread searches its neighbour in o's row
// with a lower-bound search that ends when the range is empty (the JAX
// function's fixed search_iters steps give the same answer: membership does
// not depend on the search's order). Hits go through atomicAdd on 64-bit
// integers, exact in any order, so the numerators equal the plain version's
// bit for bit.
#include "common.cuh"

#define LCC_THREADS 256

__device__ __forceinline__ void lcc_member_range(const int* __restrict__ indptr,
                                                 const int* __restrict__ col,
                                                 int c, int o, int first, int stride,
                                                 unsigned long long* numerator) {
  const int cb = __ldg(indptr + c), ce = __ldg(indptr + c + 1);
  const int ob = __ldg(indptr + o), oe = __ldg(indptr + o + 1);
  for (int j = cb + first; j < ce; j += stride) {
    const int x = __ldg(col + j);
    int lo = ob, hi = oe;
    while (lo < hi) {
      const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
      if (__ldg(col + mid) < x) lo = mid + 1; else hi = mid;
    }
    if (lo < oe && __ldg(col + lo) == x) atomicAdd(numerator + x, 1ull);
  }
}

// a unit of 2^unit_shift threads per A-edge; units never straddle a block
__global__ void __launch_bounds__(LCC_THREADS)
lcc_sweep_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                 const int* __restrict__ c, const int* __restrict__ o, long long a,
                 int unit_shift, unsigned long long* numerator) {
  const long long i = ((long long)blockIdx.x * LCC_THREADS + threadIdx.x) >> unit_shift;
  if (i >= a) return;  // the whole unit shares one A-edge
  const int unit = 1 << unit_shift;
  lcc_member_range(indptr, col, __ldg(c + i), __ldg(o + i), threadIdx.x & (unit - 1), unit,
                   numerator);
}

// indptr [n + 1] and col of S; c, o [a] int32 (ids in [0, n)); numerator [n]
// int64, added to in place; unit: the threads per A-edge, a power of two
// from 32 to LCC_THREADS.
GT_EXPORT int gt_lcc_sweep_member(const int* indptr, const int* col, const int* c,
                                  const int* o, long long a, int unit,
                                  long long* numerator, void* stream) {
  if (a < 0 || unit < 32 || unit > LCC_THREADS || (unit & (unit - 1)))
    return (int)cudaErrorInvalidValue;
  if (a == 0) return (int)cudaGetLastError();
  if (a > (0x7fffffffLL * LCC_THREADS) / unit) return (int)cudaErrorInvalidValue;
  lcc_sweep_kernel<<<gt_blocks(a * unit, LCC_THREADS), LCC_THREADS, 0, (cudaStream_t)stream>>>(
      indptr, col, c, o, a, __builtin_ctz(unit), (unsigned long long*)numerator);
  return (int)cudaGetLastError();
}
