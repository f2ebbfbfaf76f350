// K5 frontier_expand: the adjacency slices of a compacted frontier, laid out
// in e_cap edge slots.
//
// Replaces the body of graphtpu/ops/frontier.py:103 expand, which maps slots
// to frontier rows by a scatter-max of each row's index at its start and a
// cummax over all e_cap slots, then gathers the owner id, the global position
// and the neighbour in three more e_cap-sized passes. torch.cummax runs one
// long vector in a single CUDA block, so that formulation serialises.
//
// Inputs: ids[K] (frontier vertex ids, padded with n), starts[K + 1] (the
// exclusive cumsum of deg_pad[ids]; starts[K] is the edge count), indptr_pad
// [n + 1], neigh [m]. Outputs per slot s in [0, e_cap):
//   rows_local[s] = the frontier row owning s: the r with starts[r] <= s <
//                   starts[r + 1]; for a pad slot (s >= edge count) the last
//                   nonempty row, or 0 if every row is empty;
//   row_ids[s]    = ids[rows_local[s]] (optional: may be null);
//   gpos[s]       = indptr_pad[ids[r]] + s - starts[r], 0 on pad slots;
//   neigh_out[s]  = neigh[gpos[s]], 0 on pad slots;
//   valid[s]      = s < edge count.
// Slots past e_cap are truncated, as in the JAX function. Every output equals
// the JAX function's, pad slots included.
//
// Bound on the card: bytes. The neigh read (4 B per valid slot, contiguous
// within a row) and the four or five output streams (13 or 17 B a slot). A
// search of starts per slot costs log2(K) dependent reads of global memory
// (18 at K = 2^18) for every 13 bytes written, which is what bounds a thread
// per slot at BFS's tiers of 2^20 and 2^22 slots.
//
// Design: one search per block, the rest in shared memory. A block takes
// K5_THREADS * K5_SLOTS consecutive slots. Two warps find the owners r0 and
// r1 of its first and last slot by a 32-way search of starts (each round one
// read per lane and a ballot: 4 rounds at K = 2^18). The owner of a slot s is
// the LARGEST r with starts[r] <= min(s, edge count - 1): empty rows share
// their start with the next row and are skipped, and every pad slot maps to
// the owner of the last edge, so one rule serves real and pad slots. The
// block then loads starts[r0 .. r1 + 1], ids and indptr_pad[ids] - starts
// of those rows into shared memory; each thread finds the owner of its first
// slot there and walks forward for its next ones. Its K5_SLOTS slots are
// consecutive, so they read consecutive neighbours and leave as one 16 B
// store per int32 output and one 4 B store of valid. A block whose slots span
// more rows than the buffer holds (runs of empty rows are not bounded by the
// slots) searches and walks starts[r0 .. r1 + 1] in global memory instead, in
// the same kernel.
#include "common.cuh"

#define K5_THREADS 256
#define K5_SLOTS 4     // consecutive slots per thread: one 16 B store an output
#define K5_ROWS 1024   // frontier rows a block keeps in shared memory

// The largest r in [0, k) with starts[r] <= q, found by the whole warp;
// needs starts[0] <= q.
__device__ __forceinline__ int k5_warp_owner(const int* __restrict__ starts,
                                             int k, int q, int lane) {
  int lo = 0, hi = k;  // starts[lo] <= q, and the owner lies in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const long long at = lo + (long long)lane * step;
    const bool le = at < hi && starts[at] <= q;
    const unsigned m = __ballot_sync(0xffffffffu, le);  // lane 0 always set
    const int top = 31 - __clz((int)m);
    lo += top * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  return lo;
}

template <bool VEC>
__global__ void __launch_bounds__(K5_THREADS)
frontier_expand_kernel(const int* __restrict__ ids,
                       const int* __restrict__ starts, int k,
                       const int* __restrict__ indptr_pad,
                       const int* __restrict__ neigh,
                       int* __restrict__ rows_local, int* __restrict__ row_ids,
                       int* __restrict__ gpos, int* __restrict__ neigh_out,
                       unsigned char* __restrict__ valid, int e_cap) {
  __shared__ int s_start[K5_ROWS + 1];
  __shared__ int s_delta[K5_ROWS];  // indptr_pad[ids[r]] - starts[r]
  __shared__ int s_id[K5_ROWS];
  __shared__ int s_owner[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = starts[k];
  const long long first = blockIdx.x * (long long)(K5_THREADS * K5_SLOTS);
  const long long next = first + K5_THREADS * K5_SLOTS;
  const int last = (int)(next < e_cap ? next : e_cap) - 1;
  int r0 = 0, r1 = 0;
  if (total > 0) {  // block-uniform
    if (warp < 2) {
      const int s = warp == 0 ? (int)first : last;
      const int r = k5_warp_owner(starts, k, s < total ? s : total - 1, lane);
      if (lane == 0) s_owner[warp] = r;
    }
    __syncthreads();
    r0 = s_owner[0];
    r1 = s_owner[1];
  }
  const int rows = r1 - r0 + 1;
  const bool shared = rows <= K5_ROWS;  // block-uniform
  if (shared) {
    for (int i = tid; i < rows; i += K5_THREADS) {
      const int st = starts[r0 + i], id = ids[r0 + i];
      s_start[i] = st;
      s_id[i] = id;
      s_delta[i] = indptr_pad[id] - st;
    }
    if (tid == 0) s_start[rows] = starts[r0 + rows];
    __syncthreads();
  }
  const long long s0l = first + (long long)tid * K5_SLOTS;
  if (s0l >= e_cap) return;
  const int s0 = (int)s0l;
  const int* st = shared ? s_start : starts + r0;  // st[i] = starts[r0 + i]

  // the owner of the first slot: the last i in [0, rows) with st[i] <= q
  int i = 0;
  if (total > 0) {
    const int q = s0 < total ? s0 : total - 1;
    int lo = 1, hi = rows;  // st[0] <= q: the first i in [1, rows] with st[i] > q
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st[mid] <= q) lo = mid + 1; else hi = mid;
    }
    i = lo - 1;
  }
  int r[K5_SLOTS], id[K5_SLOTS], g[K5_SLOTS], nb[K5_SLOTS];
  unsigned char ok[K5_SLOTS];
#pragma unroll
  for (int j = 0; j < K5_SLOTS; ++j) {
    const long long s = s0l + j;  // past e_cap in the last thread's tail: not stored
    ok[j] = s < total;
    if (total > 0) {
      const int q = ok[j] ? (int)s : total - 1;
      while (i + 1 < rows && st[i + 1] <= q) ++i;
    }
    r[j] = r0 + i;
    int delta;
    if (shared) {
      id[j] = s_id[i];
      delta = s_delta[i];
    } else {
      id[j] = ids[r0 + i];
      delta = indptr_pad[id[j]] - st[i];
    }
    g[j] = ok[j] ? delta + (int)s : 0;
  }
#pragma unroll
  for (int j = 0; j < K5_SLOTS; ++j) nb[j] = ok[j] ? neigh[g[j]] : 0;

  if (VEC && s0 <= e_cap - K5_SLOTS) {
    *reinterpret_cast<int4*>(rows_local + s0) = make_int4(r[0], r[1], r[2], r[3]);
    if (row_ids)
      *reinterpret_cast<int4*>(row_ids + s0) = make_int4(id[0], id[1], id[2], id[3]);
    *reinterpret_cast<int4*>(gpos + s0) = make_int4(g[0], g[1], g[2], g[3]);
    *reinterpret_cast<int4*>(neigh_out + s0) = make_int4(nb[0], nb[1], nb[2], nb[3]);
    *reinterpret_cast<uchar4*>(valid + s0) = make_uchar4(ok[0], ok[1], ok[2], ok[3]);
  } else {
#pragma unroll
    for (int j = 0; j < K5_SLOTS; ++j) {
      const long long s = s0l + j;
      if (s < e_cap) {
        rows_local[s] = r[j];
        if (row_ids) row_ids[s] = id[j];
        gpos[s] = g[j];
        neigh_out[s] = nb[j];
        valid[s] = ok[j];
      }
    }
  }
}

GT_EXPORT int gt_frontier_expand(const int* ids, const int* starts, int k,
                                 const int* indptr_pad, const int* neigh,
                                 int* rows_local, int* row_ids, int* gpos,
                                 int* neigh_out, bool* valid, int e_cap,
                                 void* stream) {
  static_assert(K5_SLOTS == 4, "the vector stores take four slots");
  if (e_cap == 0) return (int)cudaGetLastError();
  if (k < 1 || e_cap < 0) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = gt_blocks(e_cap, K5_THREADS * K5_SLOTS);
  cudaStream_t s = (cudaStream_t)stream;
  // 16 B stores need outputs aligned to 16 B (torch.empty gives 256 B)
  const uintptr_t bits = (uintptr_t)rows_local | (uintptr_t)row_ids |
                         (uintptr_t)gpos | (uintptr_t)neigh_out |
                         ((uintptr_t)valid << 2);
  if ((bits & 15) == 0)
    frontier_expand_kernel<true><<<blocks, K5_THREADS, 0, s>>>(
        ids, starts, k, indptr_pad, neigh, rows_local, row_ids, gpos, neigh_out,
        (unsigned char*)valid, e_cap);
  else
    frontier_expand_kernel<false><<<blocks, K5_THREADS, 0, s>>>(
        ids, starts, k, indptr_pad, neigh, rows_local, row_ids, gpos, neigh_out,
        (unsigned char*)valid, e_cap);
  return (int)cudaGetLastError();
}
