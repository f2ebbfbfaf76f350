// K11 masked_spgemm: the values of a structurally masked semiring product
// C<M> = A (+).(x) B at the mask entries. For mask entry e = (i, j):
//
//   out[e] = (+)_{p in A.row(i), j in B.row(A.col[p])} term(p, q)
//
// where q is the first position of column j in B's row A.col[p], and the add
// identity when no p matches. term is mul(A.val[p], B.val[q]) where both
// sides have values, the one side's value where only one has, and 1 where
// neither has (a null value pointer is a structural side).
//
// Replaces graphtpu/core/spgemm.py:145-176 _spgemm_bucket (with _row_search,
// :53-73), an XLA-composed body: the mask entries bucketed by deg_A(i) into
// widths 8 * 4^k, each bucket a padded [R, w] slab on which a branchless
// binary search runs a fixed ceil(log2(nnz_B + 1)) rounds over every slot.
// At the bench graph's size (C<U> = U.U over 30.3M oriented edges, about
// 8.5e9 terms) that slab does not fit in device memory.
//
// What bounds it on the card: the search steps (one dependent load and a
// compare each) of every term; the bytes (the mask, the two CSRs once, the
// result) are far less. Design: one warp per mask entry. Its lanes walk A's
// row with no padding (coalesced reads of A.col), each searching B's row
// for j (a lower bound, so equal columns give the first one, as the JAX
// search does) with a loop that ends when its range is empty; the warp then
// reduces its lanes' partial results by shuffles. Rows of A are not split
// across warps and lanes of a short row idle: a simple kernel, right first.
//
// Add monoids: plus, min, max, and lor as max from 0 (a logical OR of
// values in {0, 1}). Multiplies: first, second, plus, times, pair (1).
// Values: float32, float64 or int32 (int32 sums and products wrap). A mask
// row outside A's rows, or an A column outside B's rows, matches nothing: no
// index read from the inputs is used unchecked.
#include "common.cuh"

#include <math.h>

#define K11_THREADS 256
#define K11_MAX_BLOCKS (1u << 22)

enum { K11_PLUS = 0, K11_MIN = 1, K11_MAX = 2, K11_LOR = 3 };
enum { K11_FIRST = 0, K11_SECOND = 1, K11_ADDMUL = 2, K11_TIMES = 3, K11_PAIR = 4 };

template <typename T> struct K11Num;

template <> struct K11Num<float> {
  static __device__ __forceinline__ float lowest() { return -INFINITY; }
  static __device__ __forceinline__ float highest() { return INFINITY; }
  static __device__ __forceinline__ float sum(float x, float y) { return x + y; }
  static __device__ __forceinline__ float prod(float x, float y) { return x * y; }
};

template <> struct K11Num<double> {
  static __device__ __forceinline__ double lowest() { return -(double)INFINITY; }
  static __device__ __forceinline__ double highest() { return (double)INFINITY; }
  static __device__ __forceinline__ double sum(double x, double y) { return x + y; }
  static __device__ __forceinline__ double prod(double x, double y) { return x * y; }
};

template <> struct K11Num<int> {
  static __device__ __forceinline__ int lowest() { return -GT_INT32_INF - 1; }
  static __device__ __forceinline__ int highest() { return GT_INT32_INF; }
  // two's complement wrap, as the plain version's int32 arithmetic
  static __device__ __forceinline__ int sum(int x, int y) {
    return (int)((unsigned)x + (unsigned)y);
  }
  static __device__ __forceinline__ int prod(int x, int y) {
    return (int)((unsigned)x * (unsigned)y);
  }
};

template <typename T>
__device__ __forceinline__ T k11_identity(int add) {
  if (add == K11_MIN) return K11Num<T>::highest();
  if (add == K11_MAX) return K11Num<T>::lowest();
  return T(0);  // plus, lor
}

template <typename T>
__device__ __forceinline__ T k11_add(int add, T x, T y) {
  if (add == K11_PLUS) return K11Num<T>::sum(x, y);
  if (add == K11_MIN) return y < x ? y : x;
  return y > x ? y : x;  // max, lor
}

template <typename T>
__device__ __forceinline__ T k11_mul(int mul, T a, T b) {
  switch (mul) {
    case K11_FIRST: return a;
    case K11_ADDMUL: return K11Num<T>::sum(a, b);
    case K11_TIMES: return K11Num<T>::prod(a, b);
    case K11_PAIR: return T(1);
    default: return b;  // second
  }
}

template <typename T>
__global__ void __launch_bounds__(K11_THREADS)
masked_spgemm_kernel(const int* __restrict__ a_indptr, const int* __restrict__ a_col,
                     const T* __restrict__ a_val, const int* __restrict__ b_indptr,
                     const int* __restrict__ b_col, const T* __restrict__ b_val,
                     const int* __restrict__ rows, const int* __restrict__ cols,
                     T* __restrict__ out, long long m, int a_rows, int b_rows, int add,
                     int mul) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const T ident = k11_identity<T>(add);
  // e is the same for the 32 lanes: the loop and the shuffles are warp-wide
  for (long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5; e < m;
       e += warps) {
    const int i = __ldg(rows + e);
    const int j = __ldg(cols + e);
    const bool row_ok = i >= 0 && i < a_rows;
    const int a_end = row_ok ? __ldg(a_indptr + i + 1) : 0;
    T acc = ident;
    for (int p = row_ok ? __ldg(a_indptr + i) + lane : a_end; p < a_end; p += 32) {
      const int k = __ldg(a_col + p);
      if (k < 0 || k >= b_rows) continue;
      int lo = __ldg(b_indptr + k);
      const int b_end = __ldg(b_indptr + k + 1);
      int hi = b_end;
      while (lo < hi) {  // first position whose column is >= j
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(b_col + mid) < j) lo = mid + 1; else hi = mid;
      }
      if (lo < b_end && __ldg(b_col + lo) == j) {
        T term;
        if (a_val != nullptr && b_val != nullptr) term = k11_mul<T>(mul, a_val[p], b_val[lo]);
        else if (b_val != nullptr) term = b_val[lo];
        else if (a_val != nullptr) term = a_val[p];
        else term = T(1);
        acc = k11_add<T>(add, acc, term);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = k11_add<T>(add, acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[e] = acc;
  }
}

template <typename T>
static int k11_launch(const int* a_indptr, const int* a_col, const void* a_val,
                      const int* b_indptr, const int* b_col, const void* b_val,
                      const int* rows, const int* cols, void* out, long long m, int a_rows,
                      int b_rows, int add, int mul, cudaStream_t stream) {
  const long long per_block = K11_THREADS / 32;
  long long blocks = (m + per_block - 1) / per_block;
  if (blocks > K11_MAX_BLOCKS) blocks = K11_MAX_BLOCKS;  // the warps stride over the rest
  masked_spgemm_kernel<T><<<(unsigned int)blocks, K11_THREADS, 0, stream>>>(
      a_indptr, a_col, (const T*)a_val, b_indptr, b_col, (const T*)b_val, rows, cols,
      (T*)out, m, a_rows, b_rows, add, mul);
  return (int)cudaGetLastError();
}

// a_rows, b_rows: the rows of A and B (indptr lengths - 1); vtype: 0 float32,
// 1 float64, 2 int32; add and mul: the enums above. A null a_val or b_val is a
// structural side.
GT_EXPORT int gt_masked_spgemm(const int* a_indptr, const int* a_col, const void* a_val,
                               const int* b_indptr, const int* b_col, const void* b_val,
                               const int* rows, const int* cols, void* out, long long m,
                               int a_rows, int b_rows, int vtype, int add, int mul,
                               void* stream) {
  if (m == 0) return (int)cudaGetLastError();
  if (m < 0 || a_rows < 0 || b_rows < 0 || add < K11_PLUS || add > K11_LOR ||
      mul < K11_FIRST || mul > K11_PAIR)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vtype) {
    case 0:
      return k11_launch<float>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, rows, cols,
                               out, m, a_rows, b_rows, add, mul, s);
    case 1:
      return k11_launch<double>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, rows, cols,
                                out, m, a_rows, b_rows, add, mul, s);
    case 2:
      return k11_launch<int>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, rows, cols,
                             out, m, a_rows, b_rows, add, mul, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
