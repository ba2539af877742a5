// Row scatter-add for Hopper (sm_90a): out[idx[i], :] += val[i, :].
//
// Replaces the Pallas TPU kernel deblur_e_nerf_tpu/ops/pallas_scatter.py
// (`_kernel`, launched by `_scatter_add_rows_pallas`), which walks the
// contribution rows serially with the whole destination table resident in
// VMEM. On Hopper the rows are independent work items: one thread per
// (row, column) element adds its value into the destination in device
// memory with an f32 atomicAdd. Consecutive threads read consecutive
// floats of `val`, so the loads coalesce; the W threads of one row read the
// same index (one L1 line).
//
// Bound: device-memory bytes. The function must read N*W*4 bytes of values
// and N*4 bytes of indices and write n_rows*W*4 bytes of output; the atomic
// read-modify-writes into the output resolve in the 50 MB L2 for every
// table of the training step (at most 524288 x 2 or 65536 x 16 floats,
// 4 MB), so the kernel should approach that byte bound when the rows do
// not collide. Heavy collisions (a dense level with 4096 rows) serialise
// atomics on one address; spreading them (warp-level pre-reduction of
// equal indices) is work for a later change.
//
// The caller zeroes `out` (torch.zeros) and passes PyTorch's current
// stream; the kernel allocates nothing and does not synchronise. Indices
// outside [0, n_rows) are skipped. Returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ val,
                                        float* __restrict__ out,
                                        int64_t n_elems, int32_t width,
                                        int64_t n_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    const int64_t i = e / width;
    const int32_t c = (int32_t)(e - i * width);
    const int64_t r = idx[i];
    if (r >= 0 && r < n_rows) {
      atomicAdd(out + r * width + c, val[e]);
    }
  }
}

}  // namespace

extern "C" int scatter_add_rows_f32(const void* idx, const void* val,
                                    void* out, int64_t n, int32_t width,
                                    int64_t n_rows, void* stream) {
  const int64_t n_elems = n * (int64_t)width;
  if (n_elems > 0) {
    const int threads = 256;
    int64_t blocks = (n_elems + threads - 1) / threads;
    // a grid-stride loop covers the rest; 132 SMs x 16 blocks keeps
    // every SM busy at the slice's sizes
    if (blocks > 132 * 16) blocks = 132 * 16;
    scatter_add_rows_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)val, (float*)out, n_elems,
        width, n_rows);
  }
  return (int)cudaGetLastError();
}
