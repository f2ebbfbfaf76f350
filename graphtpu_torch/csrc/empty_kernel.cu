// A kernel that returns at once, one block of one thread: the device time of
// a launch that does nothing, which is the floor under every launch-sized row
// of the kernel tables (K4 vreg_shuffle, K5 frontier_expand at the CDLP
// tier). Timed by chip_smoke.py and graphtpu_torch/tools/csr_row_times.py;
// no path of the system calls it.
#include "common.cuh"

__global__ void empty_kernel() {}

GT_EXPORT int gt_empty_kernel(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
