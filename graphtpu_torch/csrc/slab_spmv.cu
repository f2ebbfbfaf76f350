// K3 slab_spmv_sum: y[r] = sum over w of x[slab[w, r]] for a transposed
// [W, R] int32 slab (-1 = pad; ids outside [0, n) count as pad), in float32
// or float64.
//
// Replaces the per-bucket body of graphtpu/ops/spmv.py:82-134 slab_spmv
// (:107-112, an XLA gather and row sum) for plus without edge values, the
// whole of PageRank's slab step (plus.second).
//
// Bound on an H100 (3.35 TB/s): bytes, not operations. The slab is read
// once, 4 B per stored slot, x once and y written once: on the PageRank plan
// of RMAT scale 20, edge factor 32 (53,769,647 slots in 10 buckets, 1,048,576
// vertices, 737,858 rows) that is 222 MB or 0.066 ms a step in float32. What
// a step can reach is set by the gather: one random read of x per slot costs
// a 32 B sector of L2. A bare gather of the same ids (K1 gather_rows, C=1,
// which also writes 4 B per slot) takes 0.277 ms over the ten buckets; this
// kernel takes 0.16 ms, the earlier one 0.57 ms, and torch.mv of the same
// rows as a sparse CSR matrix 0.34 ms (PERF.md has the table per bucket).
//
// What the earlier design (one thread per row, one launch per bucket) lost,
// and what this one does about it:
//  1. A wide bucket has few rows, so few threads, each with a chain W long
//     (0.30 of its 0.57 ms went to the 4,907 rows of W = 2668): rows are now
//     split over up to 32 threads, each summing a fixed stride of w, and the
//     partial sums are added in a fixed order.
//  2. Two dependent loads per slot, one slot at a time: eight slab loads and
//     their eight gathers of x are started before the first add.
//  3. A launch per bucket, one after another: one launch serves every bucket
//     of a plan (a table of bucket descriptors, common.cuh; each block finds
//     its bucket), the widest buckets' blocks first, so wide and narrow
//     buckets fill the card together.
//
// Design. A block of 1024 threads takes a tile of T neighbouring rows and
// splits each row over TY = 1024 / T threads, TY a power of two up to 32 with
// at least 128 slots a thread (TY = 1 below W = 256, 32 from W = 4096), so a
// tile is never narrower than 32 rows: thread (tx, ty) reads slab[w, r0 + tx]
// for w = ty, ty + TY, .., and at each w a warp reads 128 contiguous bytes
// whatever R is (tiles of 4 to 16 rows measured up to twice as slow). No
// alignment is asked of the layout, so the slab loads stay 4 B a thread.
//
// Order of the sum (fixed, so two runs give the same bits; no atomics):
// thread (tx, ty) adds its terms in slab order, w = ty, ty + TY, ty + 2 TY,
// .., into one accumulator; the TY partial sums of a row are then added
// pairwise in shared memory, partial j with partial j + TY/2, then with
// j + TY/4, and so on down to j + 1. With TY = 1 that is the plain slab
// order.
//
// K6 slab_spmv_min (below) is the same body over the min monoid.
#include "common.cuh"

#define GT_SPMV_THREADS 1024
#define GT_SPMV_UNROLL 8
#define GT_SPMV_SLOTS 128    // a row is split while each thread keeps this many slots
#define GT_SPMV_MAX_SPLIT 32  // a tile is at least 32 rows: 128 contiguous bytes per w

template <typename V>
struct SumOf {
  typedef V value;
  static __device__ __forceinline__ V identity() { return 0; }
  static __device__ __forceinline__ V load(const V* __restrict__ x, int s) {
    return __ldg(x + s);
  }
  static __device__ __forceinline__ V combine(V a, V b) { return a + b; }
};

// min over int32; GATHER false reads the stored ids themselves (x unused)
template <bool GATHER>
struct MinOfI32 {
  typedef int value;
  static __device__ __forceinline__ int identity() { return GT_INT32_INF; }
  static __device__ __forceinline__ int load(const int* __restrict__ x, int s) {
    return GATHER ? __ldg(x + s) : s;
  }
  static __device__ __forceinline__ int combine(int a, int b) { return min(a, b); }
};

template <typename Op>
__global__ void __launch_bounds__(GT_SPMV_THREADS)
slab_spmv_kernel(const __grid_constant__ GtTable t,
                 const typename Op::value* __restrict__ x,
                 typename Op::value* __restrict__ y, long long n) {
  typedef typename Op::value V;
  __shared__ V part[GT_SPMV_THREADS];
  const int k = gt_find_bucket(t);
  const long long R = t.b[k].R;
  const int W = t.b[k].W, T = t.tile[k];
  const int tid = threadIdx.x, shift = __ffs(T) - 1;
  const int tx = tid & (T - 1), ty = tid >> shift, TY = GT_SPMV_THREADS >> shift;
  const long long r = (blockIdx.x - t.first_block[k]) * (long long)T + tx;
  V acc = Op::identity();
  if (r < R) {
    const int* __restrict__ col = t.b[k].slab + r;
    for (int w0 = ty; w0 < W; w0 += TY * GT_SPMV_UNROLL) {
      int s[GT_SPMV_UNROLL];
#pragma unroll
      for (int u = 0; u < GT_SPMV_UNROLL; ++u) {
        const int w = w0 + u * TY;
        s[u] = w < W ? col[w * R] : -1;
      }
      V v[GT_SPMV_UNROLL];
#pragma unroll
      for (int u = 0; u < GT_SPMV_UNROLL; ++u)
        v[u] = (s[u] >= 0 && (long long)s[u] < n) ? Op::load(x, s[u])
                                                  : Op::identity();
#pragma unroll
      for (int u = 0; u < GT_SPMV_UNROLL; ++u) acc = Op::combine(acc, v[u]);
    }
  }
  if (TY > 1) {  // block-uniform
    part[tid] = acc;
    __syncthreads();
    for (int stride = GT_SPMV_THREADS >> 1; stride >= T; stride >>= 1) {
      if (tid < stride) part[tid] = Op::combine(part[tid], part[tid + stride]);
      __syncthreads();
    }
    acc = part[tid];
  }
  if (ty == 0 && r < R) y[t.b[k].out_off + r] = acc;
}

// The tiling of every bucket; false if the buckets are not a valid table.
static bool spmv_table(GtTable& t, const GtBucket* buckets, int nb) {
  if (nb < 1 || nb > GT_MAX_BUCKETS) return false;
  for (int k = 0; k < nb; ++k) {
    int split = 1;
    while (split < GT_SPMV_MAX_SPLIT && 2 * split * GT_SPMV_SLOTS <= buckets[k].W)
      split <<= 1;
    t.tile[k] = GT_SPMV_THREADS / split;
    t.aux[k] = 0;
  }
  return gt_table_blocks(t, buckets, nb);
}

template <typename Op>
static int spmv_launch(const GtBucket* buckets, int nb,
                       const typename Op::value* x, typename Op::value* y,
                       long long n, void* stream) {
  GtTable t;
  if (!spmv_table(t, buckets, nb)) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = t.first_block[nb];
  if (blocks)
    slab_spmv_kernel<Op><<<blocks, GT_SPMV_THREADS, 0, (cudaStream_t)stream>>>(
        t, x, y, n);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_slab_spmv_sum(const GtBucket* buckets, int nb, const void* x,
                               void* y, long long n, int is_f64, void* stream) {
  if (is_f64)
    return spmv_launch<SumOf<double> >(buckets, nb, (const double*)x, (double*)y,
                                       n, stream);
  return spmv_launch<SumOf<float> >(buckets, nb, (const float*)x, (float*)y, n,
                                    stream);
}

// K6 slab_spmv_min: y[r] = min over w of x[slab[w, r]] (gather mode, int32 x)
// or of slab[w, r] itself (identity mode, x null), for the same transposed
// [W, R] int32 slabs (-1 = pad; ids outside [0, n) count as pad). A row
// without entries gives INT32_INF.
//
// Replaces the per-bucket body of graphtpu/ops/spmv.py:82-134 slab_spmv for
// min.second (an XLA gather, a where and a row min), which carries WCC's
// full steps, and the bucket bodies of WCC's gather-free iteration 0
// (graphtpu/algorithms/wcc.py:257-260, a masked row min of the stored ids).
//
// Bound on the card: as K3, the coalesced slab read plus one random 4 B read
// of x per slot from a 4 MB table that stays in L2. Min is exact in any
// order, so the result is bit-identical to the plain version's.
//
// Design: K3's kernel over the min monoid, one launch for all buckets.
GT_EXPORT int gt_slab_spmv_min(const GtBucket* buckets, int nb, const int* x,
                               int* y, long long n, void* stream) {
  if (x) return spmv_launch<MinOfI32<true> >(buckets, nb, x, y, n, stream);
  return spmv_launch<MinOfI32<false> >(buckets, nb, x, y, n, stream);
}
