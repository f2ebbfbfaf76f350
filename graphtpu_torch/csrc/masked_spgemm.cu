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
// Replaces graphtpu/core/spgemm.py:146-176 _spgemm_bucket (with _row_search,
// :53-73), an XLA-composed body: the mask entries bucketed by deg_A(i) into
// widths 8 * 4^k, each bucket a padded [R, w] slab on which a branchless
// binary search runs a fixed ceil(log2(nnz_B + 1)) rounds over every slot.
// At the bench graph's size (C<U> = U.U over 30.3M oriented edges, about
// 8.5e9 terms) that slab does not fit in device memory.
//
// What bounds it on the card. Searching B's row for j once per (mask entry,
// A entry), as this kernel's first design did, costs 76.7G dependent loads
// at the bench size, and all deg_M(i) mask entries of row i search the same
// B rows again. Walking each mask row once (Gustavson, row-wise) reads each
// B entry of the rows that A.row(i) names once per mask row, in coalesced
// loads, and looks its column up in a copy of the mask row held in shared
// memory: about 13-15G B entries at the bench size, each one load and a
// shared-memory lookup. The reads bound it.
//
// Design. The host plans on the card (core/spgemm.py:plan_masked_spgemm):
// the mask grouped by row, each row's work sum_{k in A.row(i)} deg_B(k), and
// three task lists, one launch each:
//   k11_warp_kernel   a warp per mask row of at most K11_WARP_ENTRIES entries
//                     and little work, with a table of K11_WARP_SLOTS slots;
//   k11_block_kernel  a block per longer mask row, with a table of
//                     K11_BLOCK_SLOTS slots; the row's work (the B entries
//                     its A entries name, from the plan's prefix cw over A's
//                     entries) is cut into one equal run per warp, which may
//                     start and end inside a B row;
//   the same kernel over column windows: a mask row of more than
//                     K11_WINDOW entries is cut, in column order, into
//                     windows of at most K11_WINDOW entries [c_lo, c_hi];
//                     each window is a block that finds its start in every
//                     B row by one search and stops at c_hi.
// The table: the row's (or window's) mask columns in an open-addressing hash
// table in shared memory (multiplicative hash, linear probing, load at most
// 1/8 for rows of up to 256 entries: a lookup that misses reads 1.15 slots on
// average, one that hits 1.07; at most 1/4 above that: 1.4 and 1.2), an
// accumulator beside each key. Duplicate mask columns share a slot, and
// each of their entries gets its value. A warp walks its share of A.row(i):
// a B row of 32 or more entries is streamed by the whole warp, K11_UNROLL
// loads of 32 entries in flight before their lookups; shorter ones are laid
// end to end and the warp takes 32 of those entries a step, each lane
// finding its A entry by a search of the warp's prefix sums of their
// lengths (shuffles). Each B entry whose column differs
// from the one before it in its row (a duplicate column counts at its first
// position) is looked up; a hit adds the term to the accumulator with a
// shared-memory atomic (plus: atomicAdd; int32 min, max: atomicMin/Max;
// float and double min and max: compare-and-swap). At the end each mask
// entry looks its column up once more and writes the accumulator to its own
// index.
//
// Float plus is the one monoid whose result depends on the order of its
// additions. Where every term is the same (plus.pair over values, or both
// sides structural: each term is 1) the atomics' order cannot change a sum.
// Elsewhere float plus takes the ordered variant (DET), the same sums in the
// same order on every call: a warp's hits on one accumulator add in lane
// order (__match_any_sync, then one round per rank in the group), its steps
// add in program order, and in a block each warp adds into accumulators of
// its own (indexed by the entry's place in the row, s_pos), summed in warp
// order at the end.
//
// Add monoids: plus, min, max, and lor as max from 0 (a logical OR of
// values in {0, 1}). Multiplies: first, second, plus, times, pair (1).
// Values: float32, float64 or int32 (int32 sums and products wrap). A mask
// row outside A's rows, or an A
// column outside B's rows, matches nothing: no index read from the inputs is
// used unchecked.
#include "common.cuh"

#include <math.h>

#include <type_traits>

#define K11_THREADS 256
#define K11_MIN_BLOCKS 8  // blocks an SM holds: 64 warps, at most 32 registers a thread
#define K11_WARPS (K11_THREADS / 32)
#define K11_WARP_SLOTS 256    // a warp's table: rows of at most 32 entries at load <= 1/8
#define K11_WARP_ENTRIES 32
#define K11_BLOCK_SLOTS 2048  // a block's table: load <= 1/8 up to 256 entries, 1/4 at 512
#define K11_WINDOW 512
#define K11_MIN_BITS 5        // the smallest table: 32 slots
#define K11_EMPTY ((int)0x80000000)
#define K11_FULL 0xffffffffu
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

template <typename T, int ADD>
__device__ __forceinline__ T k11_identity() {
  if (ADD == K11_MIN) return K11Num<T>::highest();
  if (ADD == K11_MAX) return K11Num<T>::lowest();
  return T(0);  // plus, lor
}

template <typename T, int ADD>
__device__ __forceinline__ T k11_add(T x, T y) {
  if (ADD == K11_PLUS) return K11Num<T>::sum(x, y);
  if (ADD == K11_MIN) return y < x ? y : x;
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

// acc (+)= v in shared memory, atomically.
template <typename T, int ADD> struct K11Atomic;

template <int ADD> struct K11Atomic<int, ADD> {
  static __device__ __forceinline__ void apply(int* a, int v) {
    if (ADD == K11_PLUS) atomicAdd(a, v);  // wraps, as the plain version
    else if (ADD == K11_MIN) atomicMin(a, v);
    else atomicMax(a, v);
  }
};

template <int ADD> struct K11Atomic<float, ADD> {
  static __device__ __forceinline__ void apply(float* a, float v) {
    if (ADD == K11_PLUS) {
      atomicAdd(a, v);
      return;
    }
    int* ai = reinterpret_cast<int*>(a);
    int old = *ai;
    while (true) {
      const float nv = k11_add<float, ADD>(__int_as_float(old), v);
      const int bits = __float_as_int(nv);
      if (bits == old) return;
      const int prev = atomicCAS(ai, old, bits);
      if (prev == old) return;
      old = prev;
    }
  }
};

template <int ADD> struct K11Atomic<double, ADD> {
  static __device__ __forceinline__ void apply(double* a, double v) {
    if (ADD == K11_PLUS) {
      atomicAdd(a, v);
      return;
    }
    unsigned long long* ai = reinterpret_cast<unsigned long long*>(a);
    unsigned long long old = *ai;
    while (true) {
      const double nv = k11_add<double, ADD>(__longlong_as_double((long long)old), v);
      const unsigned long long bits = (unsigned long long)__double_as_longlong(nv);
      if (bits == old) return;
      const unsigned long long prev = atomicCAS(ai, old, bits);
      if (prev == old) return;
      old = prev;
    }
  }
};

// log2 of the table a row of n mask entries takes: the least power of two
// >= 8n, at least 2^K11_MIN_BITS, at most `slots`.
__device__ __forceinline__ int k11_bits(int n, int slots) {
  int bits = K11_MIN_BITS;
  while ((1 << bits) < 8 * n && (1 << bits) < slots) ++bits;
  return bits;
}

__device__ __forceinline__ unsigned int k11_hash(int c, int bits) {
  return ((unsigned int)c * 0x9E3779B1u) >> (32 - bits);
}

// Inserts column c: its slot where this call took a new one, else -1. A column
// equal to K11_EMPTY keeps no slot of its own (-1): its lookups, here and in
// k11_find, stop at the first empty slot of its probe path, the same one for
// all of them once the inserts are done.
__device__ __forceinline__ int k11_insert(int* keys, int bits, int c) {
  const unsigned int mask = (1u << bits) - 1;
  unsigned int h = k11_hash(c, bits);
  while (true) {
    const int prev = atomicCAS(keys + h, K11_EMPTY, c);
    if (prev == K11_EMPTY) return c == K11_EMPTY ? -1 : (int)h;
    if (prev == c) return -1;
    h = (h + 1) & mask;
  }
}

// The slot of column c, or -1 when c is not a mask column of the table.
__device__ __forceinline__ int k11_find(const int* keys, int bits, int c) {
  const unsigned int mask = (1u << bits) - 1;
  unsigned int h = k11_hash(c, bits);
  while (true) {
    const int key = keys[h];
    if (key == c) return (int)h;
    if (key == K11_EMPTY) return -1;
    h = (h + 1) & mask;
  }
}

template <typename T>
struct K11Args {
  const int* a_indptr;
  const int* a_col;
  const T* a_val;
  const int* b_indptr;
  const int* b_col;
  const T* b_val;
  const long long* cw;  // [nnz_A + 1]: B entries named by A's entries before each
  int a_rows;
  int b_rows;
  int mul;
};

// The term of A entry value a and B entry q.
template <typename T>
__device__ __forceinline__ T k11_term(const K11Args<T>& g, T a, int q) {
  if (g.a_val != nullptr && g.b_val != nullptr) return k11_mul<T>(g.mul, a, g.b_val[q]);
  if (g.b_val != nullptr) return g.b_val[q];
  if (g.a_val != nullptr) return a;
  return T(1);
}

// First position in col[lo, hi) whose column is >= x (upper: > x).
template <bool UPPER>
__device__ __forceinline__ int k11_search(const int* col, int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int c = __ldg(col + mid);
    if (UPPER ? c <= x : c < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// acc[i] (+)= v for each lane whose i >= 0, the lanes of one i in lane
// order: one round per rank among them, a __syncwarp after each. All 32
// lanes call it.
template <typename T, int ADD>
__device__ __forceinline__ void k11_add_ordered(T* acc, int i, T v) {
  const int lane = threadIdx.x & 31;
  const unsigned int same = __match_any_sync(K11_FULL, i);
  const int rank = __popc(same & ((1u << lane) - 1));
  for (int r = 0; __any_sync(K11_FULL, i >= 0 && rank >= r); ++r) {
    if (i >= 0 && rank == r) acc[i] = k11_add<T, ADD>(acc[i], v);
    __syncwarp();
  }
}

// B entry q of column c, in the row that starts at rs; `left` is the column at
// position q - 1 when `left_same` says so (another lane read it). Looks c up
// and adds the term on a hit, unless the entry before it in the row has the
// same column. Without DET a hit adds to acc[slot] by an atomic. With DET all
// 32 lanes call it, and a hit adds in lane order to acc[pos[slot]] (to
// acc[slot] where pos is null; the column K11_EMPTY, which has no slot, to
// acc[n]).
template <typename T, int ADD, bool DET>
__device__ __forceinline__ void k11_visit(const K11Args<T>& g, const int* keys,
                                          const short* pos, int n, T* acc, int bits, bool live,
                                          int q, int rs, int c, int left, bool left_same, T a) {
  if constexpr (!DET) {
    if (!live) return;
    if (q > rs) {
      const int prev = left_same ? left : __ldg(g.b_col + q - 1);
      if (prev == c) return;  // a duplicate column counts at its first position
    }
    const int slot = k11_find(keys, bits, c);
    if (slot >= 0) K11Atomic<T, ADD>::apply(acc + slot, k11_term<T>(g, a, q));
    return;
  }
  bool look = live;
  if (look && q > rs) look = (left_same ? left : __ldg(g.b_col + q - 1)) != c;
  const int slot = look ? k11_find(keys, bits, c) : -1;
  int i = slot;
  if (slot >= 0 && pos != nullptr) i = c == K11_EMPTY ? n : pos[slot];
  k11_add_ordered<T, ADD>(acc, i, i >= 0 ? k11_term<T>(g, a, q) : T(0));
}

#define K11_UNROLL 4  // a warp's loads in flight while it streams a long B row

// One warp's share of mask row i's walk: A positions [p_begin, p_end), each
// B row cut to the work positions [f0, f1) where cw (the prefix over A's
// entries of the B entries they name) is given, and to the columns
// [c_lo, c_hi] where `windowed`. All 32 lanes call it together. pos and n
// index DET's accumulators (k11_visit).
template <typename T, int ADD, bool DET>
__device__ void k11_walk(const K11Args<T>& g, const int* keys, const short* pos, int n, T* acc,
                         int bits, int p_begin, int p_end, long long f0, long long f1,
                         bool windowed, int c_lo, int c_hi) {
  const int lane = threadIdx.x & 31;
  for (int base = p_begin; base < p_end; base += 32) {
    const int p = base + lane;
    int rs = 0, bs = 0, be = 0;
    T a = T(0);
    if (p < p_end) {
      const int k = __ldg(g.a_col + p);
      if (k >= 0 && k < g.b_rows) {
        rs = __ldg(g.b_indptr + k);
        const int re = __ldg(g.b_indptr + k + 1);
        bs = rs;
        be = re;
        if (g.cw != nullptr) {  // this warp's work positions of the row only
          const long long e0 = __ldg(g.cw + p);
          if (f0 > e0) bs = rs + (int)min(f0 - e0, (long long)(re - rs));
          if (f1 - e0 < re - rs) be = rs + (int)max(f1 - e0, 0ll);
        }
        if (windowed && bs < be) {
          bs = k11_search<false>(g.b_col, bs, be, c_lo);
          be = k11_search<true>(g.b_col, bs, be, c_hi);
        }
        if (be < bs) be = bs;
      }
      if (g.a_val != nullptr) a = g.a_val[p];
    }
    const int len = be - bs;
    // B rows of 32 or more entries: the whole warp streams each, K11_UNROLL
    // loads of 32 entries issued before their lookups
    unsigned int longs = __ballot_sync(K11_FULL, len >= 32);
    while (longs) {
      const int src = __ffs(longs) - 1;
      longs &= longs - 1;
      const int r0 = __shfl_sync(K11_FULL, rs, src);
      const int s = __shfl_sync(K11_FULL, bs, src);
      const int e = __shfl_sync(K11_FULL, be, src);
      const T av = __shfl_sync(K11_FULL, a, src);
      // the column before lane 0's entry: lane 31's of the step before, or
      // the one before the slice
      int carry = s > r0 ? __ldg(g.b_col + s - 1) : 0;
      for (int q0 = s; q0 < e; q0 += 32 * K11_UNROLL) {
        int c[K11_UNROLL];
#pragma unroll
        for (int u = 0; u < K11_UNROLL; ++u) {
          const int q = q0 + 32 * u + lane;
          c[u] = q < e ? __ldg(g.b_col + q) : 0;
        }
#pragma unroll
        for (int u = 0; u < K11_UNROLL; ++u) {
          const int q = q0 + 32 * u + lane;
          int left = __shfl_up_sync(K11_FULL, c[u], 1);
          if (lane == 0) left = carry;
          carry = __shfl_sync(K11_FULL, c[u], 31);
          k11_visit<T, ADD, DET>(g, keys, pos, n, acc, bits, q < e, q, r0, c[u], left, true,
                                  av);
        }
      }
    }
    // shorter B rows, end to end: lane t of a step takes flattened entry t,
    // K11_UNROLL steps of 32 entries loaded before their lookups
    const int slen = len < 32 ? len : 0;
    int incl = slen;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(K11_FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(K11_FULL, incl, 31);
    const int excl = incl - slen;
    int carry = 0;
    for (int t0 = 0; t0 < total; t0 += 32 * K11_UNROLL) {
      int q[K11_UNROLL], o_rs[K11_UNROLL], c[K11_UNROLL];
      bool first[K11_UNROLL];
      T av[K11_UNROLL];
#pragma unroll
      for (int u = 0; u < K11_UNROLL; ++u) {
        const int t = t0 + 32 * u + lane;
        // the owner: the first lane whose inclusive sum exceeds t
        int lo = 0, hi = 31;
#pragma unroll
        for (int it = 0; it < 5; ++it) {
          const int mid = (lo + hi) >> 1;
          const int v = __shfl_sync(K11_FULL, incl, mid);
          if (lo < hi) {
            if (v > t) hi = mid; else lo = mid + 1;
          }
        }
        o_rs[u] = __shfl_sync(K11_FULL, rs, lo);
        const int o_bs = __shfl_sync(K11_FULL, bs, lo);
        const int o_excl = __shfl_sync(K11_FULL, excl, lo);
        av[u] = __shfl_sync(K11_FULL, a, lo);
        q[u] = o_bs + t - o_excl;
        first[u] = t == o_excl;  // the first entry of its slice in this step
        c[u] = t < total ? __ldg(g.b_col + q[u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < K11_UNROLL; ++u) {
        // the entry before this one in its slice was read by lane - 1, or
        // for lane 0 by lane 31 of the step before, unless this entry
        // starts its slice here
        int left = __shfl_up_sync(K11_FULL, c[u], 1);
        if (lane == 0) left = carry;
        carry = __shfl_sync(K11_FULL, c[u], 31);
        k11_visit<T, ADD, DET>(g, keys, pos, n, acc, bits, t0 + 32 * u + lane < total, q[u],
                               o_rs[u], c[u], left, !first[u], av[u]);
      }
    }
  }
}

// A warp per task (row, start, end): mask entries [start, end) of cols/idx,
// all of row `row`; the warp walks the whole row. One warp a table, so DET
// needs only the lane order of k11_add_ordered.
template <typename T, int ADD, bool DET>
__global__ void __launch_bounds__(K11_THREADS, K11_MIN_BLOCKS)
k11_warp_kernel(K11Args<T> g, const int* __restrict__ tasks, int ntask,
                const int* __restrict__ cols, const int* __restrict__ idx, T* __restrict__ out) {
  __shared__ int s_keys[K11_WARPS][K11_WARP_SLOTS];
  __shared__ T s_acc[K11_WARPS][K11_WARP_SLOTS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* keys = s_keys[w];
  T* acc = s_acc[w];
  const T ident = k11_identity<T, ADD>();
  K11Args<T> whole = g;
  whole.cw = nullptr;  // no cut of the B rows
  const long long warps = (long long)gridDim.x * K11_WARPS;
  for (long long task = (long long)blockIdx.x * K11_WARPS + w; task < ntask; task += warps) {
    const int row = __ldg(tasks + 3 * task), s = __ldg(tasks + 3 * task + 1),
              e = __ldg(tasks + 3 * task + 2);
    if (e - s > K11_WARP_ENTRIES) continue;  // not a plan's task: its table could fill up
    const int bits = k11_bits(e - s, K11_WARP_SLOTS);
    for (int h = lane; h < (1 << bits); h += 32) {
      keys[h] = K11_EMPTY;
      acc[h] = ident;
    }
    __syncwarp();
    for (int x = s + lane; x < e; x += 32) k11_insert(keys, bits, __ldg(cols + x));
    __syncwarp();
    if (row >= 0 && row < g.a_rows)
      k11_walk<T, ADD, DET>(whole, keys, nullptr, 0, acc, bits, __ldg(g.a_indptr + row),
                            __ldg(g.a_indptr + row + 1), 0, 0, false, 0, 0);
    __syncwarp();
    for (int x = s + lane; x < e; x += 32) {
      const int slot = k11_find(keys, bits, __ldg(cols + x));
      out[idx != nullptr ? __ldg(idx + x) : x] = acc[slot];
    }
    __syncwarp();
  }
}

// A block's accumulators: one a table slot, or with DET K11_WINDOW + 1 for
// each warp (an entry's place in the row, and one for the column K11_EMPTY).
#define K11_DET_ROW (K11_WINDOW + 1)
template <typename T, bool DET>
struct K11BlockAcc {
  static constexpr int size = DET ? K11_WARPS * K11_DET_ROW : K11_BLOCK_SLOTS;
};

// A block per task (row, start, end, c_lo, c_hi); c_lo and c_hi bound the
// task's columns when `windowed`. The row's work (the B entries its A
// entries name, in the order of A.row(i)) is cut into K11_WARPS equal runs,
// one a warp: a warp's run may start and end inside a B row.
template <typename T, int ADD, bool DET>
__global__ void __launch_bounds__(K11_THREADS, K11_MIN_BLOCKS)
k11_block_kernel(K11Args<T> g, const int* __restrict__ tasks, int ntask,
                 const int* __restrict__ cols, const int* __restrict__ idx, T* __restrict__ out,
                 int windowed) {
  __shared__ T s_acc[K11BlockAcc<T, DET>::size];
  __shared__ int s_keys[K11_BLOCK_SLOTS];
  __shared__ short s_pos[DET ? K11_BLOCK_SLOTS : 1];  // DET: a slot's place in the row
  __shared__ int s_first[K11_WARPS];  // the A entry where each warp's run starts
  const int w = threadIdx.x >> 5;
  const T ident = k11_identity<T, ADD>();
  for (long long task = blockIdx.x; task < ntask; task += gridDim.x) {
    const int* t = tasks + 5 * task;
    const int row = __ldg(t), s = __ldg(t + 1), e = __ldg(t + 2), c_lo = __ldg(t + 3),
              c_hi = __ldg(t + 4);
    if (e - s > K11_WINDOW) continue;  // not a plan's task: its table could fill up
    const int n = e - s;
    const int bits = k11_bits(n, K11_BLOCK_SLOTS);
    for (int h = threadIdx.x; h < (1 << bits); h += K11_THREADS) {
      s_keys[h] = K11_EMPTY;
      if constexpr (!DET) s_acc[h] = ident;
    }
    if constexpr (DET)
      for (int h = threadIdx.x; h < K11_WARPS * (n + 1); h += K11_THREADS)
        s_acc[(h / (n + 1)) * K11_DET_ROW + h % (n + 1)] = ident;
    __syncthreads();
    const bool row_ok = row >= 0 && row < g.a_rows;
    const int a0 = row_ok ? __ldg(g.a_indptr + row) : 0;
    const int a1 = row_ok ? __ldg(g.a_indptr + row + 1) : 0;
    const long long w0 = row_ok ? __ldg(g.cw + a0) : 0;
    const long long work = row_ok ? __ldg(g.cw + a1) - w0 : 0;
    if (threadIdx.x < K11_WARPS) s_first[threadIdx.x] = a0;
    __syncthreads();
    for (int x = s + threadIdx.x; x < e; x += K11_THREADS) {
      const int slot = k11_insert(s_keys, bits, __ldg(cols + x));
      if constexpr (DET)
        if (slot >= 0) s_pos[slot] = (short)(x - s);
    }
    // warp v's run starts at work position w0 + work v / K11_WARPS: the A
    // entry p whose positions [cw[p], cw[p + 1]) hold it says so, in one
    // pass over the row's entries
    for (int q = a0 + threadIdx.x; q < a1; q += K11_THREADS) {
      const long long c0 = __ldg(g.cw + q), c1 = __ldg(g.cw + q + 1);
#pragma unroll
      for (int v = 1; v < K11_WARPS; ++v) {
        const long long f = w0 + work * v / K11_WARPS;
        if (c0 <= f && f < c1) s_first[v] = q;
      }
    }
    __syncthreads();
    if (work > 0) {
      const long long f0 = w0 + work * w / K11_WARPS, f1 = w0 + work * (w + 1) / K11_WARPS;
      // the A entries whose work positions meet [f0, f1): from the one that
      // holds f0 to the one where the next warp starts (cut to [f0, f1))
      const int p_hi = w + 1 < K11_WARPS ? min(s_first[w + 1] + 1, a1) : a1;
      if (f0 < f1)
        k11_walk<T, ADD, DET>(g, s_keys, DET ? s_pos : nullptr, n,
                              DET ? s_acc + w * K11_DET_ROW : s_acc, bits, s_first[w], p_hi, f0,
                              f1, windowed != 0, c_lo, c_hi);
    }
    __syncthreads();
    for (int x = s + threadIdx.x; x < e; x += K11_THREADS) {
      const int c = __ldg(cols + x);
      const int slot = k11_find(s_keys, bits, c);
      T v;
      if constexpr (DET) {  // the warps' sums, in warp order
        const int i = c == K11_EMPTY ? n : s_pos[slot];
        v = s_acc[i];
        for (int u = 1; u < K11_WARPS; ++u) v = k11_add<T, ADD>(v, s_acc[u * K11_DET_ROW + i]);
      } else {
        v = s_acc[slot];
      }
      out[idx != nullptr ? __ldg(idx + x) : x] = v;
    }
    __syncthreads();
  }
}

template <typename T, int ADD, bool DET>
static int k11_launch(const K11Args<T>& g, int kind, const int* tasks, int ntask,
                      const int* cols, const int* idx, void* out, cudaStream_t s) {
  if (kind == 0) {
    long long blocks = ((long long)ntask + K11_WARPS - 1) / K11_WARPS;
    if (blocks > K11_MAX_BLOCKS) blocks = K11_MAX_BLOCKS;  // the warps stride over the rest
    k11_warp_kernel<T, ADD, DET><<<(unsigned int)blocks, K11_THREADS, 0, s>>>(
        g, tasks, ntask, cols, idx, (T*)out);
  } else {
    long long blocks = ntask;
    if (blocks > K11_MAX_BLOCKS) blocks = K11_MAX_BLOCKS;
    k11_block_kernel<T, ADD, DET><<<(unsigned int)blocks, K11_THREADS, 0, s>>>(
        g, tasks, ntask, cols, idx, (T*)out, kind == 2);
  }
  return (int)cudaGetLastError();
}

// `det`: float plus whose terms are not all equal takes the ordered variant.
template <typename T>
static int k11_dispatch(const K11Args<T>& g, int add, bool det, int kind, const int* tasks,
                        int ntask, const int* cols, const int* idx, void* out, cudaStream_t s) {
  switch (add) {
    case K11_PLUS:
      if constexpr (std::is_floating_point<T>::value) {
        if (det)
          return k11_launch<T, K11_PLUS, true>(g, kind, tasks, ntask, cols, idx, out, s);
      }
      return k11_launch<T, K11_PLUS, false>(g, kind, tasks, ntask, cols, idx, out, s);
    case K11_MIN: return k11_launch<T, K11_MIN, false>(g, kind, tasks, ntask, cols, idx, out, s);
    case K11_MAX: return k11_launch<T, K11_MAX, false>(g, kind, tasks, ntask, cols, idx, out, s);
    default: return k11_launch<T, K11_LOR, false>(g, kind, tasks, ntask, cols, idx, out, s);
  }
}

template <typename T>
static int k11_typed(const int* a_indptr, const int* a_col, const void* a_val,
                     const int* b_indptr, const int* b_col, const void* b_val,
                     const long long* cw, int a_rows, int b_rows, int add, int mul, int kind,
                     const int* tasks, int ntask, const int* cols, const int* idx, void* out,
                     cudaStream_t s) {
  const K11Args<T> g{a_indptr, a_col, (const T*)a_val, b_indptr, b_col, (const T*)b_val,
                     cw, a_rows, b_rows, mul};
  // every term 1: both sides structural, or plus.pair over values
  const bool ones = (a_val == nullptr && b_val == nullptr) ||
                    (a_val != nullptr && b_val != nullptr && mul == K11_PAIR);
  return k11_dispatch<T>(g, add, !ones, kind, tasks, ntask, cols, idx, out, s);
}

// One launch of K11 over a task list of the plan (core/spgemm.py).
// a_rows, b_rows: the rows of A and B (indptr lengths - 1); vtype: 0 float32,
// 1 float64, 2 int32; add and mul: the enums above. A null a_val or b_val is a
// structural side. cw [nnz_A + 1] int64: for each A entry, the B entries that
// the A entries before it name (out-of-range columns name none); kinds 1 and
// 2 cut a row's work by it. kind: 0 warp tasks (row, start, end), int32 [ntask, 3];
// 1 block tasks and 2 window tasks (row, start, end, c_lo, c_hi), int32
// [ntask, 5]. A task's mask entries are cols[start, end), written to
// out[idx[x]] (out[x] where idx is null). Each task holds one row's entries,
// at most K11_WARP_ENTRIES of them for kind 0 and K11_WINDOW for kinds 1 and
// 2 (longer rows are windows); a task that holds more is skipped, its
// entries left as the caller filled them.
GT_EXPORT int gt_masked_spgemm(const int* a_indptr, const int* a_col, const void* a_val,
                               const int* b_indptr, const int* b_col, const void* b_val,
                               const long long* cw, int a_rows, int b_rows, int vtype, int add,
                               int mul, int kind,
                               const int* tasks, int ntask, const int* cols, const int* idx,
                               void* out, void* stream) {
  if (ntask == 0) return (int)cudaGetLastError();
  if (ntask < 0 || a_rows < 0 || b_rows < 0 || add < K11_PLUS || add > K11_LOR ||
      mul < K11_FIRST || mul > K11_PAIR || kind < 0 || kind > 2 || (kind > 0 && cw == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vtype) {
    case 0:
      return k11_typed<float>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, cw, a_rows,
                              b_rows, add, mul, kind, tasks, ntask, cols, idx, out, s);
    case 1:
      return k11_typed<double>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, cw, a_rows,
                               b_rows, add, mul, kind, tasks, ntask, cols, idx, out, s);
    case 2:
      return k11_typed<int>(a_indptr, a_col, a_val, b_indptr, b_col, b_val, cw, a_rows,
                            b_rows, add, mul, kind, tasks, ntask, cols, idx, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
