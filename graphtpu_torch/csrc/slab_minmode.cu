// K2 slab_minmode: for each column r of a transposed [W, R] int32 slab
// (-1 = pad), the smallest label among the most frequent of lab[0..W), with
//   mode 0 (gather):   lab[w] = labels[slab[w, r]]   a full CDLP step
//   mode 1 (identity): lab[w] = slab[w, r]           iteration 0, labels = ids
//   mode 2 (min):      the minimum of slab[w, r]     iteration 0, no duplicates
// and INT32_INF for a column without entries. Slab ids outside [0, bound)
// count as pad.
//
// Replaces graphtpu/ops/minmode.py:49-70 (_slab_minmode and
// _rowwise_minmode: an XLA sort along the slab axis, cummax run lengths and
// two masked reductions) and the bucket bodies of _iter0_mode (:171-189) and
// _iter0_minmode (:154-168). The tie-break is LAGraph_cdlp.c:40-45's.
//
// Bound on the card: the slab read, 4 B per slot and coalesced (at each w
// neighbouring threads read neighbouring r), and in gather mode one random
// 4 B label read per slot from a 4 MB table that stays in L2. The sort is
// on-chip work in registers or shared memory.
//
// Design: W <= 32 runs one thread per row. Its labels live in registers
// (every index known at compile time, padded with INT32_INF to a power of
// two) and are sorted by a fully unrolled bitonic network; one unrolled
// pass then keeps the first of the longest runs, which is the smallest
// label. W in (32, 4096] runs one block per row: a bitonic sort in shared
// memory padded to a power of two (16 KB at 4096), each run's length from a
// binary search for its start, and a block max-reduction of the packed key
// (count << 32 | INT32_MAX - label).
#include "common.cuh"

#define GT_MODE_GATHER 0
#define GT_MODE_IDENTITY 1
#define GT_MODE_MIN 2
#define GT_SMALL_W 32
#define GT_MAX_W 4096

__device__ __forceinline__ int load_label(const int* __restrict__ slab,
                                          const int* __restrict__ labels,
                                          long long pos, long long bound,
                                          int mode) {
  int s = slab[pos];
  if (s < 0 || (long long)s >= bound) return GT_INT32_INF;
  return mode == GT_MODE_GATHER ? __ldg(labels + s) : s;
}

template <int P>
__device__ __forceinline__ void bitonic_sort_regs(int (&v)[P]) {
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int a = v[i], b = v[l];
          if ((a > b) == ((i & k) == 0)) {
            v[i] = b;
            v[l] = a;
          }
        }
      }
    }
  }
}

template <int P>
__global__ void minmode_small_kernel(const int* __restrict__ slab,
                                     const int* __restrict__ labels,
                                     int* __restrict__ out, int w, long long R,
                                     long long bound, int mode) {
  long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  int v[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    v[i] = i < w ? load_label(slab, labels, i * R + r, bound, mode)
                 : GT_INT32_INF;
  int best = GT_INT32_INF;
  if (mode == GT_MODE_MIN) {
#pragma unroll
    for (int i = 0; i < P; ++i) best = min(best, v[i]);
  } else {
    bitonic_sort_regs<P>(v);
    int best_count = 0, run = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      // neighbour indices are masked into range; the guards decide
      run = (i > 0 && v[i] == v[(i + P - 1) & (P - 1)]) ? run + 1 : 1;
      const bool last = i + 1 == P || v[i] != v[(i + 1) & (P - 1)];
      if (last && v[i] != GT_INT32_INF && run > best_count) {
        best_count = run;
        best = v[i];
      }
    }
  }
  out[r] = best;
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// One block per row; blockDim.x is a multiple of 32, P a power of two.
__global__ void minmode_block_kernel(const int* __restrict__ slab,
                                     const int* __restrict__ labels,
                                     int* __restrict__ out, int w, long long R,
                                     long long bound, int mode, int P) {
  extern __shared__ int s[];
  __shared__ unsigned long long warp_best[32];
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  // packed key: larger is better; 0 means no entry
  unsigned long long key = 0;
  if (mode == GT_MODE_MIN) {
    for (int i = tid; i < w; i += T) {
      const int v = load_label(slab, labels, i * R + r, bound, mode);
      key = max(key, (unsigned long long)(GT_INT32_INF - v));
    }
  } else {
    for (int i = tid; i < P; i += T)
      s[i] = i < w ? load_label(slab, labels, i * R + r, bound, mode)
                   : GT_INT32_INF;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += T) {
          const int l = i ^ j;
          if (l > i) {
            const int a = s[i], b = s[l];
            if ((a > b) == ((i & k) == 0)) {
              s[i] = b;
              s[l] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < P; i += T) {
      const int v = s[i];
      if (v == GT_INT32_INF || (i + 1 < P && s[i + 1] == v)) continue;
      int lo = 0, hi = i;  // first position holding v
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s[mid] < v) lo = mid + 1; else hi = mid;
      }
      const unsigned long long count = (unsigned long long)(i - lo + 1);
      key = max(key, (count << 32) | (unsigned int)(GT_INT32_INF - v));
    }
  }
  key = warp_max_u64(key);
  if ((tid & 31) == 0) warp_best[tid >> 5] = key;
  __syncthreads();
  if (tid < 32) {
    key = tid < (T >> 5) ? warp_best[tid] : 0;
    key = warp_max_u64(key);
    if (tid == 0) out[r] = GT_INT32_INF - (int)(key & 0xffffffffull);
  }
}

template <int P>
static void launch_small(const int* slab, const int* labels, int* out, int w,
                         long long R, long long bound, int mode,
                         cudaStream_t s) {
  const int threads = 128;
  minmode_small_kernel<P><<<gt_blocks(R, threads), threads, 0, s>>>(
      slab, labels, out, w, R, bound, mode);
}

GT_EXPORT int gt_slab_minmode(const int* slab, const int* labels, int* out,
                              int w, long long R, long long bound, int mode,
                              void* stream) {
  if (R == 0) return (int)cudaGetLastError();
  if (w < 1 || w > GT_MAX_W) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int P = 1;
  while (P < w) P <<= 1;
  switch (P) {
    case 1: launch_small<1>(slab, labels, out, w, R, bound, mode, s); break;
    case 2: launch_small<2>(slab, labels, out, w, R, bound, mode, s); break;
    case 4: launch_small<4>(slab, labels, out, w, R, bound, mode, s); break;
    case 8: launch_small<8>(slab, labels, out, w, R, bound, mode, s); break;
    case 16: launch_small<16>(slab, labels, out, w, R, bound, mode, s); break;
    case 32: launch_small<32>(slab, labels, out, w, R, bound, mode, s); break;
    default: {
      const int threads = P / 2 < 256 ? P / 2 : 256;
      minmode_block_kernel<<<(unsigned int)R, threads, P * sizeof(int), s>>>(
          slab, labels, out, w, R, bound, mode, P);
    }
  }
  return (int)cudaGetLastError();
}
