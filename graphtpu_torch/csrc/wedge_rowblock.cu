// K10 wedge_rowblock: the triangle credits of one bucket of the LCC wedge
// plan. slab and mslab are [W, R] int32 (transposed: entry i of row r at
// [i * R + r]); a row holds the ranked ids of a vertex's oriented
// out-neighbours, left-packed, -1 = pad, and mslab their edge multiplicities,
// which must lie in [0, 255] (kept in a byte in shared memory; unchecked, and
// undefined above that: the wedge plan's are 0, 1 or 2).
// For every row r and every pair i < j of its real entries the key
// (slab[i, r], slab[j, r]) is probed in the edge hash; a hit adds the payload
// to u_cred[r], mslab[j, r] to edge_cred[i, r] and mslab[i, r] to
// edge_cred[j, r]. u_cred [R] and edge_cred [W, R] are int32 and must be zero
// when the kernel starts.
//
// Replaces graphtpu/ops/triangles.py:555-617 _wedge_bucket_rowblock, which
// scans row blocks of rc columns and, within one, chunks of pc pairs of a
// pair list padded to the bucket's width, so that every XLA step is a full
// [pc, rc] tile: tiling for TPU lanes. None of that is kept. A row's real
// pairs are walked, and nothing else.
//
// What it costs on the card: each real pair is one 512 B fetch of a random
// row of a table far larger than the L2, so this design moves about a row
// per pair from device memory. That traffic is the design's and no lower
// bound: the table itself, read once, is a few thousandths of it.
//
// Design: a probe is a whole warp (csrc/edgehash.cuh: one coalesced 512 B
// request). A block takes the out-lists of its rows into shared memory (ids,
// multiplicities as bytes, a credit per entry) and its warps walk the pairs,
// K10_UNROLL row fetches in flight per warp. Credits are integer atomics in
// shared memory: sums of integers are the same in any order, so the result
// is the plain version's bit for bit.
//
// Pairs are numbered p = j (j - 1) / 2 + i for i < j, so the real pairs of a
// row with d entries are exactly p < d (d - 1) / 2: padding is the tail of
// the range, cut by a bound, and a warp steps from pair to pair by counting.
// Narrow buckets pack several rows into a block (up to K10_MAX_ENTRIES
// entries, about K10_PAIRS pairs); a wide row is split over blocks of
// K10_PAIRS pairs each, which then add their credits to device memory with
// atomics. A block of a split row whose first pair is past the row's real
// pairs returns after one load.
#include "edgehash.cuh"

#define K10_THREADS 256
#define K10_WARPS (K10_THREADS / 32)
#define K10_UNROLL 4
#define K10_PAIRS 8192        // pairs a block takes
#define K10_MAX_ENTRIES 4096  // slab entries a block holds (also the widest row)
#define K10_MAX_ROWS 1024     // rows a block holds

// (i, j) of pair p in the order p = j (j - 1) / 2 + i, i < j.
__device__ __forceinline__ void k10_decode(int p, int& i, int& j) {
  j = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
  if (j < 1) j = 1;
  while (j * (j - 1) / 2 > p) --j;
  while ((j + 1) * j / 2 <= p) ++j;
  i = p - j * (j - 1) / 2;
}

__global__ void __launch_bounds__(K10_THREADS)
wedge_rowblock_kernel(const int* __restrict__ slab, const int* __restrict__ mslab,
                      int W, long long R, GtEdgeHash eh, int id_bits,
                      int* __restrict__ u_cred, int* __restrict__ edge_cred,
                      int rows_per_block, int chunks_per_row, int pairs_padded) {
  extern __shared__ int k10_smem[];
  const int entries = rows_per_block * W;
  int* ids = k10_smem;               // [rows_per_block, W]
  int* cred = ids + entries;         // [rows_per_block, W]
  int* ucred = cred + entries;       // [rows_per_block]
  int* deg = ucred + rows_per_block; // [rows_per_block]: real entries of the row
  unsigned char* mult = reinterpret_cast<unsigned char*>(deg + rows_per_block);

  const long long group = blockIdx.x / chunks_per_row;
  const int chunk = blockIdx.x % chunks_per_row;
  const long long r0 = group * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, R - r0);
  // this block's pairs of each of its rows: [p_lo, p_hi)
  const int p_lo = chunk * K10_PAIRS;
  const int p_hi = min(pairs_padded, p_lo + K10_PAIRS);
  const int span = p_hi - p_lo;
  int i_lo, j_lo, i_hi, j_hi;
  k10_decode(p_lo, i_lo, j_lo);
  k10_decode(p_hi - 1, i_hi, j_hi);
  // a split row: no real pair in this chunk unless entry j_lo is real
  if (chunks_per_row > 1 && __ldg(slab + (long long)j_lo * R + r0) < 0) return;

  const bool split = chunks_per_row > 1;
  const int loaded = nrows * (j_hi + 1);  // entries 0 .. j_hi of each row
  for (int t = threadIdx.x; t < nrows; t += K10_THREADS) {
    ucred[t] = 0;
    deg[t] = 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < loaded; e += K10_THREADS) {
    const int i = e / nrows, lr = e - i * nrows;
    const long long at = (long long)i * R + r0 + lr;
    const int v = __ldg(slab + at);
    ids[lr * W + i] = v;
    mult[lr * W + i] = (unsigned char)__ldg(mslab + at);
    cred[lr * W + i] = 0;
    if (v >= 0) atomicMax(&deg[lr], i + 1);
  }
  __syncthreads();

  // each warp walks a run of neighbouring items (row, pair) of the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = nrows * span;
  int per_warp = (items + K10_WARPS - 1) / K10_WARPS;
  per_warp = (per_warp + K10_UNROLL - 1) / K10_UNROLL * K10_UNROLL;
  int t = warp * per_warp;
  const int t_end = min(items, t + per_warp);
  if (t < t_end) {
    int lr = t / span, p = p_lo + (t - lr * span), i, j;
    k10_decode(p, i, j);
    int real = deg[lr] * (deg[lr] - 1) / 2;  // the row's real pairs
    while (t < t_end) {
      int klo[K10_UNROLL], khi[K10_UNROLL], at_i[K10_UNROLL], at_j[K10_UNROLL],
          row[K10_UNROLL];
      bool live[K10_UNROLL];
      int4 v[K10_UNROLL];
#pragma unroll
      for (int k = 0; k < K10_UNROLL; ++k) {
        live[k] = t < t_end && p < real;
        if (live[k]) {
          row[k] = lr;
          at_i[k] = lr * W + i;
          at_j[k] = lr * W + j;
          const unsigned int x = (unsigned int)ids[at_i[k]];
          const unsigned int y = (unsigned int)ids[at_j[k]];
          klo[k] = (int)((x << id_bits) | y);
          khi[k] = (int)(x >> (32 - id_bits));
          v[k] = gt_eh_load(eh, klo[k], khi[k], lane);
        }
        // the next item: the next pair of this row, else the next row
        ++t;
        ++p;
        if (++i == j) {
          ++j;
          i = 0;
        }
        if (p == p_hi && t < t_end) {
          ++lr;
          p = p_lo;
          i = i_lo;
          j = j_lo;
          real = deg[lr] * (deg[lr] - 1) / 2;
        }
      }
#pragma unroll
      for (int k = 0; k < K10_UNROLL; ++k) {
        if (!live[k]) continue;  // the same in every lane
        bool found;
        const int pay = gt_eh_finish(v[k], klo[k], khi[k], found);
        if (found && lane == 0) {
          atomicAdd(&ucred[row[k]], pay);
          atomicAdd(&cred[at_i[k]], (int)mult[at_j[k]]);
          atomicAdd(&cred[at_j[k]], (int)mult[at_i[k]]);
        }
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < loaded; e += K10_THREADS) {
    const int i = e / nrows, lr = e - i * nrows;
    const int c = cred[lr * W + i];
    int* out = edge_cred + (long long)i * R + r0 + lr;
    if (!split)
      *out = c;
    else if (c)
      atomicAdd(out, c);
  }
  for (int t2 = threadIdx.x; t2 < nrows; t2 += K10_THREADS) {
    if (!split)
      u_cred[r0 + t2] = ucred[t2];
    else if (ucred[t2])
      atomicAdd(u_cred + r0 + t2, ucred[t2]);
  }
}

GT_EXPORT int gt_wedge_rowblock(const int* slab, const int* mslab, int W,
                                long long R, const int* table, long long rows,
                                int id_bits, int* u_cred, int* edge_cred,
                                void* stream) {
  if (R == 0 || W < 2) return (int)cudaGetLastError();
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows) || W > K10_MAX_ENTRIES || id_bits < 1 ||
      id_bits > 31)
    return (int)cudaErrorInvalidValue;
  const int pairs = W * (W - 1) / 2;
  const int chunks_per_row = (pairs + K10_PAIRS - 1) / K10_PAIRS;
  int rows_per_block = 1;
  if (chunks_per_row == 1) {
    rows_per_block = min(K10_MAX_ROWS, min(K10_MAX_ENTRIES / W, K10_PAIRS / pairs));
    if (rows_per_block > R) rows_per_block = (int)R;
    if (rows_per_block < 1) rows_per_block = 1;
  }
  const long long groups = (R + rows_per_block - 1) / rows_per_block;
  const long long blocks = groups * chunks_per_row;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  // ids and credits (int32) and multiplicities (bytes) per entry, a sum and a
  // count per row: at most 45,056 bytes
  const size_t smem = (size_t)rows_per_block * W * 9 + (size_t)rows_per_block * 8;
  wedge_rowblock_kernel<<<(unsigned int)blocks, K10_THREADS, smem,
                          (cudaStream_t)stream>>>(
      slab, mslab, W, R, eh, id_bits, u_cred, edge_cred, rows_per_block,
      chunks_per_row, pairs);
  return (int)cudaGetLastError();
}
