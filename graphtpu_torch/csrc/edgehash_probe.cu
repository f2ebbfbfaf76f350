// K9 edgehash_probe: membership of P keys in the edge hash. From the int32
// key halves klo, khi [P] it computes each key's row, fetches the 512-byte
// row of table [rows, 128], compares its 64 (lo, odd) slots and writes
// found [P] (bool) and payload [P] (int32; 0 for a key that is not there).
//
// Replaces graphtpu/ops/edgehash.py:159-179 _probe_lanes: a row gather
// table[h] (the access pattern of dma_row_gather, pallas_gather.py:95), then
// strided slices, a compare, an any and a masked sum over [P, 128] in XLA.
// Here fetch, compare and payload select are one kernel, and the fetched rows
// never reach device memory.
//
// What it costs on the card: per probe 8 B of key, 5 B of result and one
// 512 B fetch of a random row. A graph-scale table (about 1 GB at RMAT
// s20/ef32) is 21x the 50 MB L2, so probes taken in the caller's order fetch
// most rows from device memory, once per probe, though on average 2.3 probes
// share a row at 2^22 probes of the bench graph's table. The least that must
// move is each distinct row once. On an H100, probes that are only binned by
// L2-sized partitions of the table find their rows in the L2, but gain
// little: the L2 hands a random 512 B row to an SM hardly faster than device
// memory does, and single 4- or 8-byte entries scattered to bins are
// partial-sector writes (PERF.md §6). So a row has to reach an SM once for
// a run of probes, and every pass writes whole sectors.
//
// Design: the probes are binned by table partition, a range of 2^pshift rows
// whose probes fit one block's shared memory (the host picks pshift from the
// call's probes per row: about K9_CHUNK / 2 probes a partition), and each
// partition's probes are grouped by row inside a block. Four launches:
//   k9_count_kernel    per tile of K9_TILE probes, a histogram of their
//                      partitions (row >> pshift) in shared memory, written
//                      to counts [tiles, parts] (the host's torch cumsum of
//                      it in partition order gives each tile's first place
//                      in each bin);
//   k9_scatter_kernel  each tile's probes ordered by partition in shared
//                      memory, then written by neighbouring threads to
//                      neighbouring places of the bins ((klo, khi) pairs),
//                      and each probe's bin place to pos [P] in the
//                      caller's order;
//   k9_probe_kernel    a block per partition, its bin in chunks of at most
//                      K9_CHUNK probes: the chunk's keys ordered by row into
//                      shared memory (a counting pass over the row's low
//                      bits), then each warp walks its share in that order,
//                      fetching a row (a warp per probe, each lane 16 B of
//                      the row, csrc/edgehash.cuh) only where it differs
//                      from the row before, K9_RUN fetches in flight, and
//                      writes a packed result (payload << 1 | found) to each
//                      probe's bin place (the block's own range);
//   k9_unbin_kernel    found and payload in the caller's order, read from
//                      the packed results at pos.
// A call too small to gain (``ops/edgehash.py:k9_bins``) launches the probe
// alone over the caller's order (k9_single_kernel), a warp per probe.
#include "edgehash.cuh"

#define K9_THREADS 256
#define K9_PER_WARP 4
#define K9_MAX_PARTS 2048  // partitions a bin pass takes (shared counters)
#define K9_BIN_THREADS 1024  // threads of a block of the bin passes
#define K9_ITEMS 8           // probes per thread of a step of the scatter
// a step of the scatter: at K9_MAX_PARTS partitions, 4 (klo, khi) pairs, one
// 32 B sector, a bin on average
#define K9_STEP (K9_BIN_THREADS * K9_ITEMS)
#define K9_TILE (K9_STEP * 2)  // probes of a block of the bin passes
// the scatter's shared memory: counters and places of each partition, and a
// step's keys and partitions in partition order
#define K9_SCATTER_SMEM \
  (2 * K9_MAX_PARTS * 4 + K9_STEP * 8 + K9_STEP * 2 + (K9_BIN_THREADS / 32) * 4)
#define K9_CHUNK 4096      // probes of one partition a probe block groups by row
#define K9_SORT_BITS 10    // row bits a probe block groups by: 2^10 counters
#define K9_RUN 8           // row fetches a warp of the probe block keeps in flight

// An exclusive scan of s[0, n) in place, by all THREADS threads of the
// block; n <= K9_MAX_PARTS. Ends with a barrier.
template <int THREADS>
__device__ void k9_block_scan(int* s, int n, int* s_warp) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per, hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < w; ++k) before += s_warp[k];
  int run = before + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = s[i];
    s[i] = run;
    run += v;
  }
  __syncthreads();
}

// counts [tiles, parts]: each tile's probes in each partition.
__global__ void __launch_bounds__(K9_BIN_THREADS)
k9_count_kernel(GtEdgeHash eh, const int* __restrict__ klo, const int* __restrict__ khi,
                long long p, int pshift, int parts, int* __restrict__ counts) {
  __shared__ int s_cnt[K9_MAX_PARTS];
  for (int i = threadIdx.x; i < parts; i += K9_BIN_THREADS) s_cnt[i] = 0;
  __syncthreads();
  const long long base = blockIdx.x * (long long)K9_TILE;
  const long long end = min(base + K9_TILE, p);
  for (long long x = base + threadIdx.x; x < end; x += K9_BIN_THREADS)  // coalesced reads
    atomicAdd(&s_cnt[gt_eh_row(eh, __ldg(klo + x), __ldg(khi + x)) >> pshift], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < parts; i += K9_BIN_THREADS)
    counts[(long long)blockIdx.x * parts + i] = s_cnt[i];
}

// offsets [tiles, parts]: each tile's first place in each bin (the host's
// scan of the counts in partition order). A block takes its tile in steps of
// K9_STEP probes, each ordered by partition in shared memory and written out
// by neighbouring threads to neighbouring places of a bin.
__global__ void __launch_bounds__(K9_BIN_THREADS)
k9_scatter_kernel(GtEdgeHash eh, const int* __restrict__ klo, const int* __restrict__ khi,
                  long long p, int pshift, int parts, const int* __restrict__ offsets,
                  int2* __restrict__ bins, int* __restrict__ pos) {
  extern __shared__ int4 k9_smem[];  // K9_SCATTER_SMEM bytes
  int2* s_key = reinterpret_cast<int2*>(k9_smem);
  int* s_cnt = reinterpret_cast<int*>(s_key + K9_STEP);
  int* s_off = s_cnt + K9_MAX_PARTS;
  int* s_warp = s_off + K9_MAX_PARTS;
  short* s_part = reinterpret_cast<short*>(s_warp + K9_BIN_THREADS / 32);
  for (int i = threadIdx.x; i < parts; i += K9_BIN_THREADS)
    s_off[i] = __ldg(offsets + (long long)blockIdx.x * parts + i);
  const long long tile = blockIdx.x * (long long)K9_TILE;
  for (long long base = tile; base < min(tile + K9_TILE, p); base += K9_STEP) {
    for (int i = threadIdx.x; i < parts; i += K9_BIN_THREADS) s_cnt[i] = 0;
    __syncthreads();
    const int n = (int)min((long long)K9_STEP, p - base);
    int lo[K9_ITEMS], hi[K9_ITEMS], part[K9_ITEMS], rank[K9_ITEMS];
#pragma unroll
    for (int j = 0; j < K9_ITEMS; ++j) {
      const int t = j * K9_BIN_THREADS + threadIdx.x;
      part[j] = -1;
      if (t < n) {
        lo[j] = __ldg(klo + base + t);
        hi[j] = __ldg(khi + base + t);
        part[j] = (int)(gt_eh_row(eh, lo[j], hi[j]) >> pshift);
        rank[j] = atomicAdd(&s_cnt[part[j]], 1);
      }
    }
    __syncthreads();
    // each partition's first place in the step
    k9_block_scan<K9_BIN_THREADS>(s_cnt, parts, s_warp);
#pragma unroll
    for (int j = 0; j < K9_ITEMS; ++j) {
      if (part[j] < 0) continue;
      const int local = s_cnt[part[j]] + rank[j];
      s_key[local] = make_int2(lo[j], hi[j]);
      s_part[local] = (short)part[j];
      pos[base + j * K9_BIN_THREADS + threadIdx.x] = s_off[part[j]] + rank[j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += K9_BIN_THREADS) {
      const int pt = s_part[i];
      bins[s_off[pt] + (i - s_cnt[pt])] = s_key[i];
    }
    __syncthreads();
    // past this step's probes of each partition
    for (int i = threadIdx.x; i < parts; i += K9_BIN_THREADS)
      s_off[i] += (i + 1 < parts ? s_cnt[i + 1] : n) - s_cnt[i];
    __syncthreads();  // before the next step clears s_cnt
  }
}

// starts [parts]: each partition's first place in the bins (the last ends
// at P). A block per partition takes its bin in chunks of at most K9_CHUNK
// probes. res [P]: payload << 1 | found at each probe's bin place.
__global__ void __launch_bounds__(K9_THREADS)
k9_probe_kernel(GtEdgeHash eh, const int2* __restrict__ bins, const int* __restrict__ starts,
                int parts, long long p, int pshift, int* __restrict__ res) {
  __shared__ int2 s_key[K9_CHUNK];
  __shared__ short s_t[K9_CHUNK];
  __shared__ int s_cnt[1 << K9_SORT_BITS];
  __shared__ int s_warp[K9_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int drop = pshift > K9_SORT_BITS ? pshift - K9_SORT_BITS : 0;
  const int keys = 1 << (pshift - drop);
  const unsigned int kmask = (1u << pshift) - 1;
  const int part = blockIdx.x;
  const int bin_end = part + 1 < parts ? __ldg(starts + part + 1) : (int)p;
  for (int start = __ldg(starts + part); start < bin_end; start += K9_CHUNK) {
    const int n = min(K9_CHUNK, bin_end - start);
    const int2* chunk = bins + start;
    for (int i = threadIdx.x; i < keys; i += K9_THREADS) s_cnt[i] = 0;
    __syncthreads();
    // the chunk ordered by row (the row's bits inside the partition) into
    // shared memory: a count, a scan, then each key placed by a second pass
    for (int t = threadIdx.x; t < n; t += K9_THREADS) {
      const int2 k = __ldg(chunk + t);
      atomicAdd(&s_cnt[(gt_eh_row(eh, k.x, k.y) & kmask) >> drop], 1);
    }
    __syncthreads();
    k9_block_scan<K9_THREADS>(s_cnt, keys, s_warp);
    for (int t = threadIdx.x; t < n; t += K9_THREADS) {
      const int2 k = __ldg(chunk + t);
      const int at = atomicAdd(&s_cnt[(gt_eh_row(eh, k.x, k.y) & kmask) >> drop], 1);
      s_key[at] = k;
      s_t[at] = (short)t;
    }
    __syncthreads();
    // warp w walks the places [w n / 8, (w + 1) n / 8) of the row order
    const int a = n * w / (K9_THREADS / 32), b = n * (w + 1) / (K9_THREADS / 32);
    unsigned int prev_row = 0xffffffffu;
    int4 prev = make_int4(0, 0, 0, 0);
    for (int i0 = a; i0 < b; i0 += K9_RUN) {
      int2 k[K9_RUN];
      unsigned int row[K9_RUN];
      int4 v[K9_RUN];
#pragma unroll
      for (int r = 0; r < K9_RUN; ++r) {
        // a place past the end repeats the last one and writes nothing
        k[r] = s_key[min(i0 + r, b - 1)];
        row[r] = gt_eh_row(eh, k[r].x, k[r].y);
      }
      // every fetch of the batch issued before any is used; a row that
      // repeats the one before takes that one's fetch
#pragma unroll
      for (int r = 0; r < K9_RUN; ++r)
        if (row[r] != (r == 0 ? prev_row : row[r - 1]))
          v[r] = __ldg(reinterpret_cast<const int4*>(eh.table + (size_t)row[r] * GT_EH_ROW) +
                       lane);
#pragma unroll
      for (int r = 0; r < K9_RUN; ++r)
        if (row[r] == (r == 0 ? prev_row : row[r - 1])) v[r] = r == 0 ? prev : v[r - 1];
#pragma unroll
      for (int r = 0; r < K9_RUN; ++r) {
        bool hit;
        const int pay = gt_eh_finish(v[r], k[r].x, k[r].y, hit);
        if (lane == 0 && i0 + r < b) res[start + s_t[i0 + r]] = (pay << 1) | (hit ? 1 : 0);
      }
      prev_row = row[K9_RUN - 1];
      prev = v[K9_RUN - 1];
    }
    __syncthreads();
  }
}

// found and payload in the caller's order from the packed results at pos.
__global__ void __launch_bounds__(K9_THREADS)
k9_unbin_kernel(const int* __restrict__ pos, const int* __restrict__ res,
                bool* __restrict__ found, int* __restrict__ payload, long long p) {
  const long long x = blockIdx.x * (long long)K9_THREADS + threadIdx.x;
  if (x >= p) return;
  const int r = __ldg(res + __ldg(pos + x));
  found[x] = (r & 1) != 0;
  payload[x] = r >> 1;
}

// The probe alone over the caller's order: a warp per probe, K9_PER_WARP
// neighbouring probes a warp with their row loads started together.
__global__ void __launch_bounds__(K9_THREADS)
k9_single_kernel(GtEdgeHash eh, const int* __restrict__ klo, const int* __restrict__ khi,
                 bool* __restrict__ found, int* __restrict__ payload, long long p) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * K9_PER_WARP;
  if (first >= p) return;  // the whole warp
  int lo[K9_PER_WARP], hi[K9_PER_WARP];
  int4 v[K9_PER_WARP];
#pragma unroll
  for (int k = 0; k < K9_PER_WARP; ++k) {
    // a probe past the end reads the row of key (0, 0) and writes nothing
    const bool live = first + k < p;
    lo[k] = live ? __ldg(klo + first + k) : 0;
    hi[k] = live ? __ldg(khi + first + k) : 0;
    v[k] = gt_eh_load(eh, lo[k], hi[k], lane);
  }
#pragma unroll
  for (int k = 0; k < K9_PER_WARP; ++k) {
    bool hit;
    const int pay = gt_eh_finish(v[k], lo[k], hi[k], hit);
    if (lane == 0 && first + k < p) {
      found[first + k] = hit;
      payload[first + k] = pay;
    }
  }
}

static bool k9_parts_ok(long long rows, int pshift, int parts, long long p, int tiles) {
  return pshift >= 0 && pshift < 32 && parts >= 1 && parts <= K9_MAX_PARTS &&
         (long long)parts == ((rows + (1ll << pshift) - 1) >> pshift) && p > 0 &&
         p <= 0x7fffffffll && (long long)tiles == (p + K9_TILE - 1) / K9_TILE;
}

// The single pass: found and payload [P] of the keys in the caller's order.
GT_EXPORT int gt_edgehash_probe(const int* table, long long rows, const int* klo,
                                const int* khi, bool* found, int* payload, long long p,
                                void* stream) {
  if (p == 0) return (int)cudaGetLastError();
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows) || p < 0 || p > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (K9_THREADS / 32) * K9_PER_WARP;
  k9_single_kernel<<<(unsigned int)((p + per_block - 1) / per_block), K9_THREADS, 0,
                     (cudaStream_t)stream>>>(eh, klo, khi, found, payload, p);
  return (int)cudaGetLastError();
}

// counts [tiles, parts] int32, tiles = ceil(P / K9_TILE): each tile's probes
// in each partition (row >> pshift).
GT_EXPORT int gt_edgehash_bin_count(const int* table, long long rows, const int* klo,
                                    const int* khi, long long p, int pshift, int parts,
                                    int tiles, int* counts, void* stream) {
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows) || !k9_parts_ok(rows, pshift, parts, p, tiles))
    return (int)cudaErrorInvalidValue;
  k9_count_kernel<<<(unsigned int)tiles, K9_BIN_THREADS, 0, (cudaStream_t)stream>>>(
      eh, klo, khi, p, pshift, parts, counts);
  return (int)cudaGetLastError();
}

// offsets [tiles, parts]: each tile's first place in each bin, the exclusive
// scan of the counts taken in partition order. Writes the keys (klo, khi) in
// bin order to bins [P, 2] and each probe's bin place to pos [P].
GT_EXPORT int gt_edgehash_bin_scatter(const int* table, long long rows, const int* klo,
                                      const int* khi, long long p, int pshift, int parts,
                                      int tiles, const int* offsets, int* bins, int* pos,
                                      void* stream) {
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows) || !k9_parts_ok(rows, pshift, parts, p, tiles))
    return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel's shared memory is opted into (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      k9_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K9_SCATTER_SMEM);
  if (err != cudaSuccess) return (int)err;
  k9_scatter_kernel<<<(unsigned int)tiles, K9_BIN_THREADS, K9_SCATTER_SMEM,
                      (cudaStream_t)stream>>>(eh, klo, khi, p, pshift, parts, offsets,
                                              reinterpret_cast<int2*>(bins), pos);
  return (int)cudaGetLastError();
}

// starts [parts] int32: each partition's first place in the bins. Writes the
// packed results res [P] in bin order.
GT_EXPORT int gt_edgehash_bin_probe(const int* table, long long rows, const int* bins,
                                    const int* starts, int parts, long long p, int pshift,
                                    int* res, void* stream) {
  if (p == 0) return (int)cudaGetLastError();
  GtEdgeHash eh;
  if (!gt_eh_init(eh, table, rows) || parts < 1 || parts > K9_MAX_PARTS || pshift < 0 ||
      pshift >= 32 || p < 0 || p > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  k9_probe_kernel<<<(unsigned int)parts, K9_THREADS, 0, (cudaStream_t)stream>>>(
      eh, reinterpret_cast<const int2*>(bins), starts, parts, p, pshift, res);
  return (int)cudaGetLastError();
}

// found and payload [P] in the caller's order from res at pos.
GT_EXPORT int gt_edgehash_unbin(const int* pos, const int* res, bool* found, int* payload,
                                long long p, void* stream) {
  if (p == 0) return (int)cudaGetLastError();
  if (p < 0 || p > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  k9_unbin_kernel<<<(unsigned int)((p + K9_THREADS - 1) / K9_THREADS), K9_THREADS, 0,
                    (cudaStream_t)stream>>>(pos, res, found, payload, p);
  return (int)cudaGetLastError();
}
