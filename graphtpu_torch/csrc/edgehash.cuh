// The edge-hash probe as device functions, used by K9 (edgehash_probe.cu).
//
// The table (graphtpu_torch/ops/edgehash.py) is int32 [rows, 128], rows a
// power of two: a row holds 64 (even, odd) lane pairs, 512 bytes. The even
// lane is the key's low 32 bits, the odd lane (key_hi << 2) | payload; empty
// slots are (-1, -1) and a real odd lane is never negative. A probe is a
// whole warp: each lane loads 16 bytes (two slots) of the row, so the row
// moves in one coalesced 512 B request, and a ballot and a warp sum give
// "found" and the payload.
#pragma once

#include "common.cuh"

#define GT_EH_PAYLOAD_BITS 2
#define GT_EH_PAYLOAD_MASK 3
#define GT_EH_ROW 128  // int32 lanes per row

// How a row is found from a key's halves: shift = 32 - log2(rows) and
// mask = rows - 1, from the host.
struct GtEdgeHash {
  const int* table;
  int shift;
  unsigned int mask;
};

// false if rows is not a power of two in [2, 2^31].
static inline bool gt_eh_init(GtEdgeHash& eh, const int* table, long long rows) {
  if (rows < 2 || rows > (1ll << 31) || (rows & (rows - 1))) return false;
  int b = 0;
  while ((1ll << b) < rows) ++b;
  eh.table = table;
  eh.shift = 32 - b;
  eh.mask = (unsigned int)(rows - 1);
  return true;
}

// The row of a key: the 32-bit products wrap, so they are unsigned here (the
// top log2(rows) bits of the mix, as the host's uint32 arithmetic gives them).
__device__ __forceinline__ unsigned int gt_eh_row(const GtEdgeHash& eh, int klo,
                                                  int khi) {
  const unsigned int h =
      ((unsigned int)klo * 0x9E3779B1u) ^ ((unsigned int)khi * 0x85EBCA77u);
  return (h >> eh.shift) & eh.mask;
}

// This lane's 16 bytes (slots 2 * lane and 2 * lane + 1) of the key's row.
__device__ __forceinline__ int4 gt_eh_load(const GtEdgeHash& eh, int klo, int khi,
                                           int lane) {
  const int4* row = reinterpret_cast<const int4*>(
      eh.table + (size_t)gt_eh_row(eh, klo, khi) * GT_EH_ROW);
  return __ldg(row + lane);
}

// The payloads of this lane's slots that hold the key, summed; hit says
// whether one does.
__device__ __forceinline__ int gt_eh_match(int4 v, int klo, int khi, bool& hit) {
  int pay = 0;
  hit = false;
  if (v.y >= 0 && v.x == klo && (v.y >> GT_EH_PAYLOAD_BITS) == khi) {
    hit = true;
    pay += v.y & GT_EH_PAYLOAD_MASK;
  }
  if (v.w >= 0 && v.z == klo && (v.w >> GT_EH_PAYLOAD_BITS) == khi) {
    hit = true;
    pay += v.w & GT_EH_PAYLOAD_MASK;
  }
  return pay;
}

// The end of a probe, by all 32 lanes of a warp together: the payload (0 for
// a key that is not in the table) and found, the same in every lane.
__device__ __forceinline__ int gt_eh_finish(int4 v, int klo, int khi, bool& found) {
  bool hit;
  const int pay = gt_eh_match(v, klo, khi, hit);
  found = __ballot_sync(0xffffffffu, hit) != 0;
  return __reduce_add_sync(0xffffffffu, pay);
}
