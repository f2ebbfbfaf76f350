// K10 wedge_rowblock: the triangle credits of one bucket of the LCC wedge
// plan. slab and mslab are [W, R] int32 (transposed: entry i of row r at
// [i * R + r]); a row holds the distinct ranked ids of a vertex u's oriented
// out-neighbours, left-packed, -1 = pad, and mslab their edge multiplicities,
// which must lie in [0, 255] (kept in a byte in shared memory; unchecked, and
// undefined above that: the wedge plan's are 0, 1 or 2). The closing CSR
// (close_indptr [n_close + 1], close_ids, close_mult: int32, int32, uint8)
// lists for every tail x < n_close the heads y of its oriented edges x -> y,
// ascending and distinct, with their multiplicities; the plan's leaves out
// the keys its edge hash spilled, which the host patch counts.
// For every row r and every pair i < j of its real entries, with
// x = slab[i, r] and y = slab[j, r]: if y is in out(x), u_cred[r] += mult(x, y),
// edge_cred[i, r] += mslab[j, r] and edge_cred[j, r] += mslab[i, r]. u_cred [R]
// and edge_cred [W, R] are int32 and must be zero when the kernel starts.
//
// Replaces graphtpu/ops/triangles.py:555-617 _wedge_bucket_rowblock, which
// probes the edge hash for every pair of a pair list padded to the bucket's
// width, in [pc, rc] tiles shaped for TPU lanes. None of that is kept.
//
// What bounds it on this card: the wedge (u; x, y) closes iff y is in out(x),
// a sorted list of 4 B ids. An earlier design fetched a 512 B hash row per
// wedge (2.17 TB at RMAT s20/ef32); this one streams, for every entry (r, i)
// that has a later entry, out(x) up to the row's largest id (13.8G list
// entries, 55 GB, at s20/ef32), and probes each entry read once in shared
// memory. The lists are 121 MB distinct and the same hub lists recur, so the
// stream comes mostly from the L2, at 1.1-1.6 TB/s: neither device memory
// nor the L2 is the limit, and more pieces in flight or the next item's
// bounds loaded ahead gained nothing on an NVIDIA H100 80GB HBM3 at 700 W.
// The shared-memory probes are: random words hit one bank several times
// over, and a warp waits for its lane with the longest chain of slots.
//
// Design: a block holds the entries of its rows in shared memory (ids,
// multiplicities as bytes, a credit per entry, each row's real count and
// largest id), a linear-probing hash of them keyed by (row, id), at most a
// quarter full, and a filter of K10_FILTER bits per entry, a bit per hash
// prefix. Its warps take items (row, i) one at a time from a shared counter,
// so that an item's cost (from nothing to a list of thousands) does not hold
// a warp's neighbours. A warp reads out(x) with its multiplicities in
// coalesced pieces of 32 entries, K10_UNROLL in flight, and stops after the
// piece that passes the row's largest id. A lane tests its id's bit in the
// filter: most ids read (87 % at s20/ef32) close no wedge, and one word load
// rejects nearly all of those, where a probe of the table walks a chain of
// slots with the warp waiting for its longest one. An id
// that passes is looked up in the table, and a hit at a later entry j adds
// mslab[i] to j's credit (a shared-memory integer atomic) and the payload
// and mslab[j] to the warp's sums, which go to u_cred and to i's credit once
// per item. Integer sums are the same in any order, so the result
// is the plain version's bit for bit. An out(x) of any length streams the
// same way: nothing of it is copied. Narrow buckets pack up to K10_ITEMS
// entries of several rows into a block; a row wider than that is held whole
// by each of several blocks, each taking a range of its items and adding its
// credits to device memory with atomics; a block whose first item has no
// later entry returns after one load.
#include "common.cuh"

#define K10_THREADS 256
#define K10_ITEMS 512        // slab entries (items) a block takes, at most
#define K10_UNROLL 2         // 32-entry pieces of out(x) a warp has in flight
#define K10_SLOTS 4          // hash slots per held entry, at least
#define K10_FILTER 64        // filter bits per held entry, at least
#define K10_MAX_WIDTH 4096   // the widest row

// The hash of id v of block row lr: its top bits give the first slot in the
// table and the bit in the filter.
__device__ __forceinline__ unsigned int k10_hash(int v, int lr) {
  return ((unsigned int)v * 0x9E3779B1u) ^ ((unsigned int)lr * 0x85EBCA77u);
}

__global__ void __launch_bounds__(K10_THREADS)
wedge_rowblock_kernel(const int* __restrict__ slab, const int* __restrict__ mslab, int W,
                      long long R, const int* __restrict__ close_indptr,
                      const int* __restrict__ close_ids,
                      const unsigned char* __restrict__ close_mult, long long n_close,
                      int* __restrict__ u_cred, int* __restrict__ edge_cred,
                      int rows_per_block, int chunks, int items_per_chunk, int shift,
                      int fshift) {
  extern __shared__ int k10_smem[];
  __shared__ int next_item;
  const int held_max = rows_per_block * W;
  const unsigned int mask = (1u << (32 - shift)) - 1u;
  int* ids = k10_smem;                      // [rows_per_block * W]
  int* cred = ids + held_max;               // [rows_per_block * W]
  int* table = cred + held_max;             // [mask + 1]: an entry lr * W + j, -1 = empty
  // [2^(32 - fshift) / 32]: a bit per hash prefix, set if an entry has it
  unsigned int* filter = reinterpret_cast<unsigned int*>(table + mask + 1);
  const unsigned int fwords = 1u << (27 - fshift);
  int* ucred = reinterpret_cast<int*>(filter + fwords);  // [rows_per_block]
  int* deg = ucred + rows_per_block;        // [rows_per_block]: real entries of the row
  int* top = deg + rows_per_block;          // [rows_per_block]: the row's largest id
  unsigned char* mult = reinterpret_cast<unsigned char*>(top + rows_per_block);

  const long long group = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long r0 = group * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, R - r0);
  const int held = nrows * W;
  const int t_lo = chunk * items_per_chunk;
  const int t_hi = min(held, t_lo + items_per_chunk);
  const bool split = chunks > 1;  // then one row a block, its items over the chunks
  if (split && (t_lo + 1 >= W || __ldg(slab + (long long)(t_lo + 1) * R + r0) < 0)) return;

  for (unsigned int s = threadIdx.x; s <= mask; s += K10_THREADS) table[s] = -1;
  for (unsigned int s = threadIdx.x; s < fwords; s += K10_THREADS) filter[s] = 0u;
  for (int t = threadIdx.x; t < nrows; t += K10_THREADS) {
    ucred[t] = 0;
    deg[t] = 0;
    top[t] = -1;
  }
  if (threadIdx.x == 0) next_item = t_lo;
  __syncthreads();
  for (int e = threadIdx.x; e < held; e += K10_THREADS) {
    const int i = e / nrows, lr = e - i * nrows;  // neighbouring threads, neighbouring rows
    const long long at = (long long)i * R + r0 + lr;
    const int v = __ldg(slab + at);
    const int k = lr * W + i;
    ids[k] = v;
    mult[k] = (unsigned char)__ldg(mslab + at);
    cred[k] = 0;
    if (v >= 0) {
      atomicMax(&deg[lr], i + 1);
      atomicMax(&top[lr], v);
      const unsigned int h = k10_hash(v, lr), f = h >> fshift;
      atomicOr(&filter[f >> 5], 1u << (f & 31));
      unsigned int s = h >> shift;
      while (atomicCAS(&table[s], -1, k) != -1) s = (s + 1) & mask;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned int full = 0xffffffffu;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(&next_item, 1);
    t = __shfl_sync(full, t, 0);
    if (t >= t_hi) break;
    const int lr = t / W, i = t - lr * W;
    if (i + 1 >= deg[lr]) continue;  // pad, or the row's last entry: no later one
    const int x = ids[t];
    if ((unsigned long long)x >= (unsigned long long)n_close) continue;  // no out-list
    const int end = __ldg(close_indptr + x + 1);
    const int cut = top[lr], base = lr * W, mi = mult[t];
    int su = 0, si = 0;
    for (int p = __ldg(close_indptr + x); p < end; p += 32 * K10_UNROLL) {
      int z[K10_UNROLL], mz[K10_UNROLL];
#pragma unroll
      for (int k = 0; k < K10_UNROLL; ++k) {
        const int q = p + 32 * k + lane;
        z[k] = q < end ? __ldg(close_ids + q) : -1;
        mz[k] = q < end ? __ldg(close_mult + q) : 0;
      }
#pragma unroll
      for (int k = 0; k < K10_UNROLL; ++k) {
        if (z[k] < 0 || z[k] > cut) continue;
        const unsigned int h = k10_hash(z[k], lr), f = h >> fshift;
        if (!((filter[f >> 5] >> (f & 31)) & 1u)) continue;  // no entry has its prefix
        unsigned int s = h >> shift;
        int e;
        while ((e = table[s]) >= 0 &&
               (ids[e] != z[k] || (unsigned int)(e - base) >= (unsigned int)W))
          s = (s + 1) & mask;
        if (e >= 0 && e - base > i) {  // y = z[k] is entry j = e - base of the row, j > i
          su += mz[k];
          si += mult[e];
          atomicAdd(&cred[e], mi);
        }
      }
      // the list ascends: past the row's largest id, no later piece can hit
      if (__shfl_sync(full, z[K10_UNROLL - 1], 31) > cut) break;
    }
    su = __reduce_add_sync(full, su);
    si = __reduce_add_sync(full, si);
    if (lane == 0) {
      if (su) atomicAdd(&ucred[lr], su);
      if (si) atomicAdd(&cred[t], si);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < held; e += K10_THREADS) {
    const int i = e / nrows, lr = e - i * nrows;
    const int c = cred[lr * W + i];
    int* out = edge_cred + (long long)i * R + r0 + lr;
    if (!split)
      *out = c;
    else if (c)
      atomicAdd(out, c);
  }
  for (int t = threadIdx.x; t < nrows; t += K10_THREADS) {
    if (!split)
      u_cred[r0 + t] = ucred[t];
    else if (ucred[t])
      atomicAdd(u_cred + r0 + t, ucred[t]);
  }
}

GT_EXPORT int gt_wedge_rowblock(const int* slab, const int* mslab, int W, long long R,
                                const int* close_indptr, const int* close_ids,
                                const unsigned char* close_mult, long long n_close,
                                int* u_cred, int* edge_cred, void* stream) {
  if (R == 0 || W < 2) return (int)cudaGetLastError();
  if (W > K10_MAX_WIDTH || n_close < 0) return (int)cudaErrorInvalidValue;
  int rows_per_block = W >= K10_ITEMS ? 1 : K10_ITEMS / W;
  if (rows_per_block > R) rows_per_block = (int)R;
  const int held = rows_per_block * W;
  // more than one chunk only for a row wider than K10_ITEMS
  const int chunks = (held + K10_ITEMS - 1) / K10_ITEMS;
  const int items_per_chunk = (held + chunks - 1) / chunks;
  int bits = 3, fbits = 5;
  while ((1 << bits) < K10_SLOTS * held) ++bits;
  while ((1 << fbits) < K10_FILTER * held) ++fbits;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block * chunks;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  // ids and credits (int32), the hash table, the filter, three ints a row,
  // multiplicities (bytes): at most 135,180 bytes, at W = 4096
  const size_t smem = (size_t)held * 9 + ((size_t)4 << bits) + ((size_t)1 << (fbits - 3)) +
                      (size_t)rows_per_block * 12;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wedge_rowblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  wedge_rowblock_kernel<<<(unsigned int)blocks, K10_THREADS, smem, (cudaStream_t)stream>>>(
      slab, mslab, W, R, close_indptr, close_ids, close_mult, n_close, u_cred, edge_cred,
      rows_per_block, chunks, items_per_chunk, 32 - bits, 32 - fbits);
  return (int)cudaGetLastError();
}
