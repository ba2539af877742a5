// Stable stream compaction for Hopper (sm_90a): the flagged lanes of one to
// three payload channels, in lane order, into (budget + 1,) buffers whose
// slots past the flagged count, and slot `budget`, hold each channel's
// fill; the number of flagged lanes (a device scalar); and, on request,
// the smallest payload of channel 0 among the flagged lanes that did not
// fit (the channel's fill when none was dropped).
//
// Replaces the JAX package's `_compact` (deblur_e_nerf_tpu/models/
// renderer.py:196), which XLA compiles from a cumsum of the flags and a
// scatter to the cumsum positions (dropped lanes write out of bounds), and
// the occlusion prepass's `put` (renderer.py:523), the same scatter of
// three payloads. The march runs it once a stage (superblocks, blocks,
// samples: up to 31,457,288 lanes on the flagship, 33.5M on r5fix's block
// stage), the prepass once for its three channels (t_mid and dt float32,
// ray_idx int64). ops/compact.py `compact_reference` is the plain version.
//
// Bound: device-memory bytes. The function must read every flag (1 byte a
// lane) and the payloads of the flagged lanes it keeps (4 or 8 bytes a
// channel), and write every slot of the output once (budget + 1 slots of
// 4 or 8 bytes a channel); about 9 bytes a lane read and 8 a slot written
// for the march's int64 codes. Its arithmetic is a few integer operations
// a lane.
//
// The design: count, scan, write, each in this file's own code (no library
// scan), all launched on the caller's stream with no host read:
//  1. compact_count: one block a tile of 4096 lanes (16 lanes a thread,
//     lane-major so that a warp's flag loads are 32 consecutive bytes);
//     each warp counts its flags with __ballot_sync + __popc, and the
//     block writes its tile's count.
//  2. compact_scan: one block of 1024 threads turns the tile counts (8,193
//     at 33.5M lanes) into exclusive tile offsets in place, writes the
//     total, and sets the cutoff to channel 0's fill.
//  3. compact_write: one block a tile again. The block's 128 warp ballots
//     (16 a warp) give every flagged lane its rank in the tile; a lane
//     whose offset + rank is below the budget copies its payloads there
//     (consecutive flagged lanes write consecutive slots). A dropped lane
//     takes part in a warp min of channel 0's payload, and each warp that
//     dropped a lane issues one int64 atomicMin: the min is the same
//     whatever the order, so two runs give the same bits. Then the grid
//     writes the fills into the slots from min(total, budget) to budget.
// The flags are read twice (count and write): 1 byte a lane more than the
// bound, in exchange for a write pass that needs no look-back between
// blocks.
//
// The entry point takes the wrapper's scratch (one int64 a tile), launches
// the three kernels on the given stream and returns the CUDA error of the
// launches (cudaErrorInvalidValue for an argument the kernels do not
// take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;                   // lanes a thread in a tile
constexpr int64_t kTile = kThreads * kIters;  // lanes a block
constexpr int kScanThreads = 1024;
constexpr int kMaxChannels = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoDrop = 0x7fffffffffffffffLL;

struct Channels {
  const void* src[kMaxChannels];
  void* dst[kMaxChannels];
  int size[kMaxChannels];        // bytes an element: 4 or 8
  uint64_t fill[kMaxChannels];   // the fill's bits (low 32 for 4 bytes)
  int n;
};

__device__ __forceinline__ void copy_element(const Channels& ch, int c,
                                             int64_t from, int64_t to) {
  if (ch.size[c] == 8) {
    static_cast<uint64_t*>(ch.dst[c])[to] =
        __ldg(static_cast<const unsigned long long*>(ch.src[c]) + from);
  } else {
    static_cast<uint32_t*>(ch.dst[c])[to] =
        __ldg(static_cast<const unsigned int*>(ch.src[c]) + from);
  }
}

__device__ __forceinline__ void write_fill(const Channels& ch, int c,
                                           int64_t to) {
  if (ch.size[c] == 8) {
    static_cast<uint64_t*>(ch.dst[c])[to] = ch.fill[c];
  } else {
    static_cast<uint32_t*>(ch.dst[c])[to] = (uint32_t)ch.fill[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    compact_count(const uint8_t* __restrict__ flags, int64_t n,
                  int64_t* __restrict__ tiles) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int count = 0;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int64_t l = base + (int64_t)i * kThreads;
    const bool f = l < n && __ldcs(flags + l) != 0;
    count += __popc(__ballot_sync(kFull, f));
  }
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    tiles[blockIdx.x] = total;
  }
}

__device__ __forceinline__ long long warp_inclusive_scan(long long v,
                                                         int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
    compact_scan(int64_t* __restrict__ tiles, int64_t n_tiles,
                 int64_t* __restrict__ total, int64_t* __restrict__ cutoff,
                 int64_t fill0) {
  __shared__ long long warp_totals[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int64_t first = (int64_t)threadIdx.x * per;
  const int64_t lo = first < n_tiles ? first : n_tiles;
  const int64_t hi = lo + per < n_tiles ? lo + per : n_tiles;
  long long local = 0;
  for (int64_t k = lo; k < hi; ++k) local += tiles[k];
  const long long incl = warp_inclusive_scan(local, lane);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long t = warp_inclusive_scan(warp_totals[lane], lane);
    warp_totals[lane] = t;  // inclusive totals of warps 0..lane
  }
  __syncthreads();
  int64_t running = incl - local + (warp > 0 ? warp_totals[warp - 1] : 0);
  for (int64_t k = lo; k < hi; ++k) {
    const int64_t c = tiles[k];
    tiles[k] = running;
    running += c;
  }
  if (threadIdx.x == 0) {
    *total = warp_totals[kScanThreads / 32 - 1];
    if (cutoff != nullptr) *cutoff = fill0;
  }
}

__global__ void __launch_bounds__(kThreads)
    compact_write(const uint8_t* __restrict__ flags, int64_t n,
                  const int64_t* __restrict__ tiles, const Channels ch,
                  int64_t budget, const int64_t* __restrict__ total,
                  int64_t* __restrict__ cutoff) {
  __shared__ int warp_base[kIters * kWarps];  // (iteration, warp) order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  unsigned masks[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int64_t l = base + (int64_t)i * kThreads;
    masks[i] = __ballot_sync(kFull, l < n && flags[l] != 0);
    if (lane == 0) warp_base[i * kWarps + warp] = __popc(masks[i]);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 128 counts in lane order: 4 a lane
    constexpr int kPer = kIters * kWarps / 32;
    int v[kPer];
    int local = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = warp_base[lane * kPer + k];
      local += v[k];
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - local;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      warp_base[lane * kPer + k] = run;
      run += v[k];
    }
  }
  __syncthreads();
  const int64_t tile_offset = tiles[blockIdx.x];
  const unsigned below = (1u << lane) - 1u;
  long long dropped_min = kNoDrop;
  bool dropped = false;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (!((masks[i] >> lane) & 1u)) continue;
    const int64_t l = base + (int64_t)i * kThreads;
    const int64_t pos = tile_offset + warp_base[i * kWarps + warp]
                        + __popc(masks[i] & below);
    if (pos < budget) {
      for (int c = 0; c < ch.n; ++c) copy_element(ch, c, l, pos);
    } else if (cutoff != nullptr) {
      const long long p =
          __ldg(static_cast<const long long*>(ch.src[0]) + l);
      dropped_min = p < dropped_min ? p : dropped_min;
      dropped = true;
    }
  }
  if (cutoff != nullptr && __any_sync(kFull, dropped)) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long y = __shfl_xor_sync(kFull, dropped_min, d);
      dropped_min = y < dropped_min ? y : dropped_min;
    }
    if (lane == 0) atomicMin((long long*)cutoff, dropped_min);
  }
  // the fills: slots min(total, budget) .. budget
  const int64_t t = *total;
  const int64_t start = t < budget ? t : budget;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t s = start + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       s <= budget; s += stride) {
    for (int c = 0; c < ch.n; ++c) write_fill(ch, c, s);
  }
}

}  // namespace

// flags: (n,) bytes (torch.bool), 0 or not; src/dst: n_channels payloads
// of (n,) and outputs of (budget + 1,) elements of `sizes` bytes; fills:
// each channel's fill bits; tiles: (ceil(n / 4096),) int64 scratch; total:
// one int64; cutoff: one int64 or null (then channel 0 must be int64).
extern "C" int compact_launch(const void* flags, int64_t n,
                              int32_t n_channels, const void* src0,
                              const void* src1, const void* src2,
                              void* dst0, void* dst1, void* dst2,
                              int32_t size0, int32_t size1, int32_t size2,
                              uint64_t fill0, uint64_t fill1, uint64_t fill2,
                              int64_t budget, void* tiles, void* total,
                              void* cutoff, void* stream) {
  if (n < 1 || n_channels < 1 || n_channels > kMaxChannels || budget < 0 ||
      tiles == nullptr || total == nullptr)
    return (int)cudaErrorInvalidValue;
  Channels ch;
  const void* src[kMaxChannels] = {src0, src1, src2};
  void* dst[kMaxChannels] = {dst0, dst1, dst2};
  const int size[kMaxChannels] = {size0, size1, size2};
  const uint64_t fill[kMaxChannels] = {fill0, fill1, fill2};
  for (int c = 0; c < kMaxChannels; ++c) {
    ch.src[c] = src[c];
    ch.dst[c] = dst[c];
    ch.size[c] = size[c];
    ch.fill[c] = fill[c];
    if (c < n_channels &&
        (src[c] == nullptr || dst[c] == nullptr ||
         (size[c] != 4 && size[c] != 8)))
      return (int)cudaErrorInvalidValue;
  }
  ch.n = n_channels;
  if (cutoff != nullptr && size0 != 8) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)flags;
  int64_t* t = (int64_t*)tiles;
  compact_count<<<(unsigned)n_tiles, kThreads, 0, s>>>(f, n, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scan<<<1, kScanThreads, 0, s>>>(t, n_tiles, (int64_t*)total,
                                          (int64_t*)cutoff, (int64_t)fill0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_write<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      f, n, t, ch, budget, (const int64_t*)total, (int64_t*)cutoff);
  return (int)cudaGetLastError();
}
