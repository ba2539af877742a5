// Grid sizing shared by the grid-stride kernels (gather_rows.cu,
// hash_encode.cu): a launch never asks for more blocks than the card holds
// at once, so each resident thread walks the work with a grid-stride loop.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace launch_grid {

constexpr int kThreads = 256;  // threads per block of every such kernel

// Blocks of `kThreads` the card holds at once for kernel K: SM count x the
// occupancy the runtime reports, cached per device.
template <auto K>
int64_t resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads, 0);
    cached[dev] = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

// Launch K with enough blocks for `threads_needed` threads, capped at the
// resident blocks.
template <auto K, typename... Args>
void launch(int64_t threads_needed, cudaStream_t stream, Args... args) {
  int64_t blocks = (threads_needed + kThreads - 1) / kThreads;
  const int64_t resident = resident_blocks<K>();
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  K<<<(unsigned)blocks, kThreads, 0, stream>>>(args...);
}

}  // namespace launch_grid
