// K13 bfs_trunc_probe: the truncated bottom-up probe of direction-optimizing
// BFS. For each of r rows v, with t = the probe depth:
//   hit       = any_j levels[trunc[j * r + v]] == level   (an id outside
//               [0, n_levels), the table's sentinel, is no hit)
//   unvisited = levels[row_offset + v] == INT32_INF
//   claim[v]  = unvisited & hit
//   resid[v]  = unvisited & pdeg[v] > t & !hit
// On one device the rows are all n vertices (row_offset 0); in the
// distributed BFS a rank's r rows start at row_offset of the replicated
// levels, and its table holds global ids.
//
// Replaces graphtpu/algorithms/bfs.py:213-232 (bu_step's probe: an int32
// frontier mask padded by one, a gather of t * n of its entries, a max over
// t and the two masks, five or six XLA ops) and the per-rank probe of
// graphtpu/parallel/adaptive_bfs.py. The frontier mask is not materialised:
// the level test is made on the gathered level itself.
//
// Bound on an H100 (3.35 TB/s): bytes. The table is read once (4 t B a row),
// pdeg and the row's own level once (8 B), the levels (4 B a vertex) once,
// and two bool masks written (2 B a row): at n = 2^20, t = 2, 18.9 MB or
// 0.0056 ms. The t random level reads a row cost a 32 B sector each where
// they miss L2; the 4 MB of levels fit in L2.
//
// Design: one thread per row, rows along the lanes, so the table's t rows
// and pdeg are read coalesced; the t level gathers of a row do not wait on
// each other.
//
// Device-level mode (AT): the level is read from a device word (level_at),
// not taken as a launch argument, so that one launch captured into BFS
// auto's CUDA graph (algorithms/bfs.py) serves every level: the graph's
// control words hold the level, which the step before wrote.
#include "common.cuh"

#define K13_THREADS 256

template <bool AT>
__global__ void __launch_bounds__(K13_THREADS)
k13_probe_kernel(const int* __restrict__ levels, long long n_levels, int level,
                 const int* __restrict__ level_at, const int* __restrict__ trunc, int t,
                 long long r, long long row_offset, const int* __restrict__ pdeg,
                 bool* __restrict__ claim, bool* __restrict__ resid) {
  const long long v = (long long)blockIdx.x * K13_THREADS + threadIdx.x;
  if (v >= r) return;
  if (AT) level = __ldg(level_at);
  bool hit = false;
  for (int j = 0; j < t; ++j) {  // no early exit: the t loads are independent
    const int u = trunc[j * r + v];
    hit |= u >= 0 && (long long)u < n_levels && __ldg(levels + u) == level;
  }
  const bool unvisited = levels[row_offset + v] == GT_INT32_INF;
  claim[v] = unvisited && hit;
  resid[v] = unvisited && !hit && pdeg[v] > t;
}

// levels [n_levels], trunc [t * r], pdeg [r], claim and resid [r] (bool);
// rows row_offset .. row_offset + r of levels are the rows' own levels. The
// level is `level`, or where level_at is not null the int32 it points to on
// the device (device-level mode).
GT_EXPORT int gt_bfs_trunc_probe(const int* levels, long long n_levels,
                                 int level, const int* level_at, const int* trunc,
                                 int t, long long r, long long row_offset,
                                 const int* pdeg, bool* claim, bool* resid,
                                 void* stream) {
  if (t < 1 || r < 0 || row_offset < 0 || row_offset + r > n_levels)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaGetLastError();
  const unsigned int g = gt_blocks(r, K13_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (level_at)
    k13_probe_kernel<true><<<g, K13_THREADS, 0, s>>>(levels, n_levels, level, level_at, trunc,
                                                     t, r, row_offset, pdeg, claim, resid);
  else
    k13_probe_kernel<false><<<g, K13_THREADS, 0, s>>>(levels, n_levels, level, nullptr, trunc,
                                                      t, r, row_offset, pdeg, claim, resid);
  return (int)cudaGetLastError();
}
