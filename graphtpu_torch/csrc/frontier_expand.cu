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
// Bound on the card: the neigh gather (a random 4 B read per slot) and the
// five output streams. The binary search reads starts, K + 1 int32 (256 KB
// at K = 2^16), which stays in L2.
//
// Design: one thread per slot. Each thread binary-searches starts for the
// largest r with starts[r] <= s (or <= edge count - 1 on a pad slot). Empty
// rows share their start with the next row, and the search for the LARGEST
// such r skips them, so no row can own a slot it has no edge for.
#include "common.cuh"

__global__ void frontier_expand_kernel(const int* __restrict__ ids,
                                       const int* __restrict__ starts, int k,
                                       const int* __restrict__ indptr_pad,
                                       const int* __restrict__ neigh,
                                       int* __restrict__ rows_local,
                                       int* __restrict__ row_ids,
                                       int* __restrict__ gpos,
                                       int* __restrict__ neigh_out,
                                       bool* __restrict__ valid, int e_cap) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= e_cap) return;
  const int total = starts[k];
  const bool ok = s < total;
  int r = 0;
  if (total > 0) {
    const int q = ok ? s : total - 1;
    int lo = 0, hi = k;  // first r in [0, k) with starts[r] > q
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (starts[mid] <= q) lo = mid + 1; else hi = mid;
    }
    r = lo - 1;  // starts[0] == 0 <= q, so r >= 0
  }
  const int id = ids[r];
  rows_local[s] = r;
  if (row_ids) row_ids[s] = id;
  int g = 0, nb = 0;
  if (ok) {
    g = indptr_pad[id] + (s - starts[r]);
    nb = neigh[g];
  }
  gpos[s] = g;
  neigh_out[s] = nb;
  valid[s] = ok;
}

GT_EXPORT int gt_frontier_expand(const int* ids, const int* starts, int k,
                                 const int* indptr_pad, const int* neigh,
                                 int* rows_local, int* row_ids, int* gpos,
                                 int* neigh_out, bool* valid, int e_cap,
                                 void* stream) {
  if (e_cap == 0) return (int)cudaGetLastError();
  const int threads = 256;
  frontier_expand_kernel<<<gt_blocks(e_cap, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      ids, starts, k, indptr_pad, neigh, rows_local, row_ids, gpos, neigh_out,
      valid, e_cap);
  return (int)cudaGetLastError();
}
