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
// samples: up to 31,457,288 lanes on the flagship, 125.8M on EDS's block
// stage), the prepass once for its three channels (t_mid and dt float32,
// ray_idx int64). ops/compact.py `compact_reference` is the plain version.
//
// Bound: device-memory bytes. The function must read every flag (1 byte a
// lane), the payloads of the flagged lanes it keeps (4 or 8 bytes a channel)
// and, for the cutoff, channel 0 of the flagged lanes it drops, and write
// every output slot once (budget + 1 slots of 4 or 8 bytes a channel); about
// 9 bytes a lane read and 8 a slot written for the march's int64 codes. Its
// arithmetic is a few integer operations a lane. What held the first design
// (count, a scan by one block, write) off that bound on the H100 (80GB HBM3,
// 700 W): three launches, a serial middle one (the 7.9M-lane superblock
// stage reached 15% of its bound), the flags read twice one byte a thread,
// and one 4- or 8-byte store a kept element.
//
// The design: a single pass over the flags, one launch after a memset of
// the status words, no library scan, no host read:
//  - A block takes a tile by a ticket from an atomic counter, so it only
//    ever waits on tiles already taken by running blocks, and loads its
//    64 consecutive flags a thread as four 16-byte vectors. A tile's chain
//    of dependent steps (ticket, flags, scan, look-back, rounds of
//    staging, stores), not its bytes, sets the pace: a tile is 16,384
//    lanes (256 threads), or 8,192 (128 threads) for a call of at most
//    6M lanes (the wrapper's choice), whose tiles fill less than one wave:
//    on the H100 the smaller tile was faster there (the r5fix prepass's
//    1.2M-lane put, 4M lanes), the larger from 7.9M lanes up (the
//    flagship's block stage), and 4,096-lane tiles lost almost everywhere.
//  - It ranks the tile's flagged lanes with popc and a block scan into a
//    bitmap and per-word prefix counts in shared memory, and publishes
//    its count in its status word (an aggregate); warp 0 then gets the
//    exclusive offset from a decoupled look-back over the earlier tiles'
//    status words (32 tiles a step, waiting only for those up to the
//    nearest inclusive prefix) and publishes its inclusive prefix. The
//    offsets are integer sums, so any look-back order gives the same
//    offsets: the output is the plain version's bit for bit.
//  - The flags are read once (the bound's first term).
//  - Kept payloads (the second): a warp copies 32 consecutive lanes' payloads
//    (a bitmap word gives each lane's flag, the word's prefix and a popc its
//    rank; a word without flags is skipped) into shared memory by rank with
//    asynchronous copies (cp.async), so all of a warp's loads are in flight
//    at once (a load feeding a shared store waited out its latency word by
//    word, which held the block stage back on the H100), in rounds of a
//    32 KiB stage (4096 int64, 8192 float32); the other warps stage
//    channel 0's first round while warp 0 looks back.
//    Each round is stored as 16-byte vectors over the tile's run of output
//    slots (the partial vectors at the run's two ends element by element).
//  - The cutoff (the third): in a tile that drops lanes, their channel 0
//    is read once, then a warp minimum and one integer atomicMax of an
//    order-reversing key a warp: a minimum, the same whatever the order.
//  - Every output slot once (the fourth): the blocks whose tickets come
//    after the last tile's (taken once every tile was, so nothing they
//    wait on waits on them) read the total from the last tile's inclusive
//    prefix and write the fills over slots min(total, budget) .. budget
//    as 16-byte vectors; the first of them writes the total and, once
//    every tile is done, the cutoff. A tile writes only slots below
//    min(total, budget), so no slot is written twice.
// So a call is one memset (the ticket, the done count, the cutoff key and
// a status word a tile, all zero) and one kernel launch, down from three
// launches.
//
// The entry point takes the wrapper's scratch (3 + one int64 a tile),
// launches on the given stream and returns the CUDA error of the launch
// (cudaErrorInvalidValue for an argument the kernel does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVectors = 4;                  // 16-byte flag loads a thread
constexpr int kLanes = 16 * kVectors;        // lanes a thread
constexpr int kThreadWords = kLanes / 32;    // a thread's bitmap words
constexpr int kStageBytes = 32768;           // the stage a round: 4096
                                             // int64 or 8192 float32
constexpr int kFillSlots = 128;              // fill slots a thread, at
constexpr int kMaxFillThreads = 264 * 256;   // most this many fill threads

// A tile of NT threads: NT * kLanes lanes, its bitmap words
template <int NT>
struct Tile {
  static constexpr int kWarps = NT / 32;
  static constexpr int kSize = NT * kLanes;
  static constexpr int kWords = kSize / 32;
};
constexpr int kMaxChannels = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;
constexpr unsigned long long kSign = 1ull << 63;
constexpr long long kNoDrop = 0x7fffffffffffffffLL;
// the scratch's control words, then one status word a tile
constexpr int kTicket = 0, kDone = 1, kCutKey = 2, kStatus = 3;

struct Channels {
  const void* src[kMaxChannels];
  void* dst[kMaxChannels];
  int size[kMaxChannels];        // bytes an element: 4 or 8
  uint64_t fill[kMaxChannels];   // the fill's bits (low 32 for 4 bytes)
  int n;
};

struct Args {
  const uint8_t* flags;
  int64_t n;
  int64_t n_tiles;
  int64_t budget;
  Channels ch;
  unsigned long long* ctl;   // zeroed: ticket, tiles done, cutoff key, status
  int64_t* total;
  int64_t* cutoff;           // null: no cutoff
  int n_fill;                // fill blocks after the tiles
  bool vector_flags;         // flags 16-byte aligned
};

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_volatile(unsigned long long* p,
                                               unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// bit b set where byte b of w is not zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) m |= ((w >> (8 * b)) & 0xffu) ? 1u << b : 0u;
  return m;
}

// A thread's flags of a tile: its kLanes lanes as 16-byte loads, or byte
// by byte at a ragged end or an unaligned start.
struct Flags {
  uint4 v[kVectors];
  bool vector;
  int64_t first;
};

template <int NT>
__device__ __forceinline__ void load_flags(const Args& a, int64_t tile,
                                           Flags& f) {
  f.first = tile * Tile<NT>::kSize + (int64_t)threadIdx.x * kLanes;
  f.vector = a.vector_flags && f.first + kLanes <= a.n;
  if (f.vector) {
#pragma unroll
    for (int q = 0; q < kVectors; ++q)
      f.v[q] = __ldcs(reinterpret_cast<const uint4*>(a.flags + f.first) + q);
  }
}

// the thread's bitmap words: bit i of word w for lane first + 32 w + i
__device__ __forceinline__ void flag_words(const Args& a, const Flags& f,
                                           unsigned (&words)[kThreadWords]) {
  if (f.vector) {
#pragma unroll
    for (int w = 0; w < kThreadWords; ++w) {
      words[w] = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 v = f.v[2 * w + q];
        words[w] |= (nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
                     nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12)
                    << (16 * q);
      }
    }
    return;
  }
#pragma unroll
  for (int w = 0; w < kThreadWords; ++w) {
    words[w] = 0;
    for (int i = 0; i < 32; ++i) {
      const int64_t l = f.first + 32 * w + i;
      if (l < a.n && a.flags[l] != 0) words[w] |= 1u << i;
    }
  }
}

// Warp 0: the number of flagged lanes in the tiles before `tile`, from
// their status words (an aggregate: the tile's own count; inclusive: the
// count up to and with the tile), 32 tiles a step, nearest first; a step
// waits only for the tiles up to the nearest inclusive one.
__device__ long long look_back(const unsigned long long* status,
                               int64_t tile, int lane) {
  long long excl = 0;
  for (int64_t end = tile;; end -= 32) {
    const int64_t t = end - 1 - lane;
    unsigned long long s;
    unsigned inclusive, needed;
    for (;;) {
      s = t >= 0 ? load_volatile(status + t) : kInclusive;
      inclusive = __ballot_sync(kFull, (s & kInclusive) != 0);
      needed = inclusive ? (inclusive & -inclusive) * 2 - 1 : kFull;
      if ((__ballot_sync(kFull, s != 0) & needed) == needed) break;
    }
    long long v = (needed >> lane) & 1u ? (long long)(s & kValue) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (inclusive) return excl;
  }
}

// an asynchronous copy of one E from global to shared memory (cp.async:
// no register waits on the load)
template <typename E>
__device__ __forceinline__ void copy_async(E* dst, const E* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d),
               "l"(src), "n"(sizeof(E))
               : "memory");
}

// wait for this thread's asynchronous copies
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Stage the payloads of the flagged lanes of rank k0 .. k1 - 1 (stage[r -
// k0]), lane-major so that a warp reads 32 consecutive lanes: a bitmap
// word gives each lane's flag, the word's prefix and a popc its rank; the
// words go to warps w0 .. w0 + nw - 1 in turn. Each lane's payload comes
// by an asynchronous copy, so a warp's loads are all in flight at once
// (a load feeding a shared store would wait out its latency word by
// word); wait_copies() and a barrier before the stage is read. With
// want_min, also the minimum of the dropped lanes' (rank >= keep)
// payloads.
template <int NT, typename E>
__device__ __forceinline__ void gather(const E* __restrict__ src,
                                       int64_t base, const unsigned* bitmap,
                                       const int* prefix, E* stage, int k0,
                                       int k1, int keep, bool want_min,
                                       long long& dropped_min, int w0 = 0,
                                       int nw = Tile<NT>::kWarps) {
  const int lane = threadIdx.x & 31;
  for (int w = (threadIdx.x >> 5) - w0; w < Tile<NT>::kWords; w += nw) {
    const unsigned word = bitmap[w];
    if (word == 0) continue;
    const int p = prefix[w];
    const int p_end = p + __popc(word);
    if ((p_end <= k0 || p >= k1) && !(want_min && p_end > keep)) continue;
    if ((word >> lane) & 1u) {
      const int r = p + __popc(word & ((1u << lane) - 1u));
      const int64_t l = base + (int64_t)w * 32 + lane;
      if (r >= k0 && r < k1) {
        copy_async(stage + (r - k0), src + l);
      } else if (want_min && r >= keep) {
        const long long v = (long long)__ldg(src + l);
        dropped_min = v < dropped_min ? v : dropped_min;
      }
    }
  }
  wait_copies();
}

// stage[0 .. count) into dst[out ..] as 16-byte vectors (the run's
// partial vectors element by element)
template <int NT, typename E>
__device__ __forceinline__ void store_run(E* __restrict__ dst, int64_t out,
                                          const E* stage, int count) {
  constexpr int V = 16 / sizeof(E);
  const int shift = (int)(((uintptr_t)(dst + out) & 15) / sizeof(E));
  E* base = dst + out - shift;  // 16-byte aligned
  const int n_vec = (shift + count + V - 1) / V;
  for (int v = threadIdx.x; v < n_vec; v += NT) {
    const int lo = v * V;
    if (lo >= shift && lo + V <= shift + count) {
      union {
        uint4 u;
        E e[V];
      } w;
#pragma unroll
      for (int i = 0; i < V; ++i) w.e[i] = stage[lo - shift + i];
      *reinterpret_cast<uint4*>(base + lo) = w.u;
    } else {
      const int hi = lo + V < shift + count ? lo + V : shift + count;
      for (int k = lo > shift ? lo : shift; k < hi; ++k)
        base[k] = stage[k - shift];
    }
  }
}

// fill slots from .. to - 1 of dst with value, as 16-byte vectors: block
// f of n_fill
template <int NT, typename E>
__device__ __forceinline__ void fill_run(E* __restrict__ dst, E value,
                                         int64_t from, int64_t to, int f,
                                         int n_fill) {
  constexpr int V = 16 / sizeof(E);
  if (from >= to) return;
  const int64_t shift = ((uintptr_t)(dst + from) & 15) / sizeof(E);
  E* base = dst + from - shift;  // 16-byte aligned
  const int64_t end = shift + (to - from);
  const int64_t n_vec = (end + V - 1) / V;
  union {
    uint4 u;
    E e[V];
  } w;
#pragma unroll
  for (int i = 0; i < V; ++i) w.e[i] = value;
  for (int64_t v = (int64_t)f * NT + threadIdx.x; v < n_vec;
       v += (int64_t)n_fill * NT) {
    const int64_t lo = v * V;
    if (lo >= shift && lo + V <= end) {
      *reinterpret_cast<uint4*>(base + lo) = w.u;
    } else {
      for (int64_t k = lo > shift ? lo : shift; k < lo + V && k < end; ++k)
        base[k] = value;
    }
  }
}

// one channel of a tile: its kept payloads through the stage in rounds of
// kStageBytes (round 0 already staged when `staged`), each stored as 16-byte
// vectors at out; the dropped lanes' minimum on request
template <int NT, typename E>
__device__ __forceinline__ void tile_channel(
    const void* src, void* dst, int64_t base, const unsigned* bitmap,
    const int* prefix, uint64_t* stage, int64_t out, int keep, bool staged,
    bool want_min, long long& dropped_min) {
  constexpr int kRound = kStageBytes / sizeof(E);
  E* s = reinterpret_cast<E*>(stage);
  for (int k0 = 0; k0 < keep || (want_min && k0 == 0); k0 += kRound) {
    const int k1 = keep < k0 + kRound ? keep : k0 + kRound;
    if (!(staged && k0 == 0) || want_min) {
      gather<NT>(static_cast<const E*>(src), base, bitmap, prefix, s,
                 staged && k0 == 0 ? k1 : k0, k1, keep, want_min && k0 == 0,
                 dropped_min);
      __syncthreads();
    }
    if (k1 > k0) store_run<NT>(static_cast<E*>(dst), out + k0, s, k1 - k0);
    __syncthreads();
  }
}

template <int NT>
__global__ void __launch_bounds__(NT) compact_kernel(const Args a) {
  constexpr int kWarps = Tile<NT>::kWarps;
  constexpr int kWords = Tile<NT>::kWords;
  __shared__ unsigned bitmap[kWords];  // the tile's flags, bit per lane
  __shared__ int prefix[kWords];       // flagged lanes before each word
  __shared__ __align__(16) uint64_t stage[kStageBytes / 8];
  __shared__ int warp_counts[kWarps];
  __shared__ long long s_ticket, s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* status = a.ctl + kStatus;
  if (threadIdx.x == 0)
    s_ticket = (long long)atomicAdd(a.ctl + kTicket, 1ull);
  __syncthreads();
  const long long ticket = s_ticket;

  if (ticket >= a.n_tiles) {
    // a fill block: the total once the last tile's prefix is out
    if (threadIdx.x == 0) {
      unsigned long long last;
      while (!((last = load_volatile(status + a.n_tiles - 1)) & kInclusive))
        __nanosleep(100);
      s_excl = (long long)(last & kValue);
    }
    __syncthreads();
    const int64_t total = s_excl;
    const int64_t kept = total < a.budget ? total : a.budget;
    const int f = (int)(ticket - a.n_tiles);
    if (f == 0 && threadIdx.x == 0) {
      *a.total = total;
      if (a.cutoff != nullptr) {
        // every tile's atomicMax is in once every tile is done: the plain
        // version's min over the dropped lanes' payloads and the fill of
        // every other lane
        while (load_volatile(a.ctl + kDone) < (unsigned long long)a.n_tiles)
          __nanosleep(100);
        __threadfence();
        const unsigned long long key = load_volatile(a.ctl + kCutKey);
        const long long dropped_min = (long long)(~key ^ kSign);
        const long long fill0 = (long long)a.ch.fill[0];
        const bool others = a.n > total - kept;
        *a.cutoff = others && fill0 < dropped_min ? fill0 : dropped_min;
      }
    }
    for (int c = 0; c < a.ch.n; ++c) {
      if (a.ch.size[c] == 8)
        fill_run<NT>(static_cast<uint64_t*>(a.ch.dst[c]), a.ch.fill[c],
                     kept, a.budget + 1, f, a.n_fill);
      else
        fill_run<NT>(static_cast<uint32_t*>(a.ch.dst[c]),
                     (uint32_t)a.ch.fill[c], kept, a.budget + 1, f,
                     a.n_fill);
    }
    return;
  }

  // a tile: rank its flagged lanes into the bitmap and word prefixes
  const int64_t tile = ticket;
  const int64_t base = tile * Tile<NT>::kSize;
  Flags flags;
  load_flags<NT>(a, tile, flags);
  unsigned words[kThreadWords];
  flag_words(a, flags, words);
  int count = 0;
#pragma unroll
  for (int w = 0; w < kThreadWords; ++w) count += __popc(words[w]);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_counts[warp] = incl;
  __syncthreads();
  int rank = incl - count, tile_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    if (w < warp) rank += c;
    tile_total += c;
  }
  if (threadIdx.x == 0)
    store_volatile(status + tile, (tile == 0 ? kInclusive : kAggregate) |
                                      (unsigned long long)tile_total);
#pragma unroll
  for (int w = 0; w < kThreadWords; ++w) {
    bitmap[kThreadWords * threadIdx.x + w] = words[w];
    prefix[kThreadWords * threadIdx.x + w] = rank;
    rank += __popc(words[w]);
  }
  __syncthreads();

  // warp 0 looks back while the others stage channel 0's first round
  // (the offset, so the kept count, is not known yet: ranks beyond it are
  // staged and not stored)
  const int round0 = kStageBytes / a.ch.size[0];
  const int first = tile_total < round0 ? tile_total : round0;
  long long dropped_min = kNoDrop;
  if (warp == 0) {
    const long long excl = tile == 0 ? 0 : look_back(status, tile, lane);
    if (lane == 0) {
      if (tile > 0)
        store_volatile(status + tile,
                       kInclusive | (unsigned long long)(excl + tile_total));
      s_excl = excl;
    }
  } else if (a.ch.size[0] == 8) {
    gather<NT>(static_cast<const uint64_t*>(a.ch.src[0]), base, bitmap,
               prefix, stage, 0, first, first, false, dropped_min, 1,
               kWarps - 1);
  } else {
    gather<NT>(static_cast<const uint32_t*>(a.ch.src[0]), base, bitmap,
               prefix, reinterpret_cast<uint32_t*>(stage), 0, first, first,
               false, dropped_min, 1, kWarps - 1);
  }
  __syncthreads();
  const int64_t excl = s_excl;
  const int64_t room = a.budget - excl;
  const int keep =
      room <= 0 ? 0 : (room < tile_total ? (int)room : tile_total);
  for (int c = 0; c < a.ch.n; ++c) {
    const bool want_min = c == 0 && a.cutoff != nullptr && keep < tile_total;
    if (a.ch.size[c] == 8)
      tile_channel<NT, uint64_t>(a.ch.src[c], a.ch.dst[c], base, bitmap,
                                 prefix, stage, excl, keep, c == 0, want_min,
                                 dropped_min);
    else
      tile_channel<NT, uint32_t>(a.ch.src[c], a.ch.dst[c], base, bitmap,
                                 prefix, stage, excl, keep, c == 0, want_min,
                                 dropped_min);
  }
  if (a.cutoff != nullptr && keep < tile_total) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long y = __shfl_xor_sync(kFull, dropped_min, d);
      dropped_min = y < dropped_min ? y : dropped_min;
    }
    if (lane == 0) {
      // an order-reversing key: the integer maximum is the minimum
      atomicMax(a.ctl + kCutKey, ~((unsigned long long)dropped_min ^ kSign));
      __threadfence();
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(a.ctl + kDone, 1ull);
}

template <int NT>
int launch(Args a, cudaStream_t s) {
  a.n_tiles = (a.n + Tile<NT>::kSize - 1) / Tile<NT>::kSize;
  const int64_t per_block = (int64_t)kFillSlots * NT;
  const int64_t fills = (a.budget + 1 + per_block - 1) / per_block;
  const int64_t max_fills = kMaxFillThreads / NT;
  a.n_fill = (int)(fills < max_fills ? fills : max_fills);
  const int64_t blocks = a.n_tiles + a.n_fill;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      a.ctl, 0, (size_t)(kStatus + a.n_tiles) * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<NT><<<(unsigned)blocks, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// flags: (n,) bytes (torch.bool), 0 or not; src/dst: n_channels payloads
// of (n,) and outputs of (budget + 1,) elements of `sizes` bytes; fills:
// each channel's fill bits; tile_lanes: the lanes a tile, 8192 or 16384;
// scratch: (3 + ceil(n / tile_lanes),) int64, zeroed here; total:
// one int64; cutoff: one int64 or null (then channel 0 must be int64).
extern "C" int compact_launch(const void* flags, int64_t n,
                              int32_t n_channels, const void* src0,
                              const void* src1, const void* src2,
                              void* dst0, void* dst1, void* dst2,
                              int32_t size0, int32_t size1, int32_t size2,
                              uint64_t fill0, uint64_t fill1, uint64_t fill2,
                              int64_t budget, int32_t tile_lanes,
                              void* scratch, void* total, void* cutoff,
                              void* stream) {
  if (n < 1 || n_channels < 1 || n_channels > kMaxChannels || budget < 0 ||
      scratch == nullptr || total == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  const void* src[kMaxChannels] = {src0, src1, src2};
  void* dst[kMaxChannels] = {dst0, dst1, dst2};
  const int size[kMaxChannels] = {size0, size1, size2};
  const uint64_t fill[kMaxChannels] = {fill0, fill1, fill2};
  for (int c = 0; c < kMaxChannels; ++c) {
    a.ch.src[c] = src[c];
    a.ch.dst[c] = dst[c];
    a.ch.size[c] = size[c];
    a.ch.fill[c] = fill[c];
    if (c < n_channels &&
        (src[c] == nullptr || dst[c] == nullptr ||
         (size[c] != 4 && size[c] != 8) ||
         ((uintptr_t)src[c] | (uintptr_t)dst[c]) % size[c] != 0))
      return (int)cudaErrorInvalidValue;
  }
  a.ch.n = n_channels;
  if (cutoff != nullptr && size0 != 8) return (int)cudaErrorInvalidValue;
  a.flags = (const uint8_t*)flags;
  a.n = n;
  a.budget = budget;
  a.ctl = (unsigned long long*)scratch;
  a.total = (int64_t*)total;
  a.cutoff = (int64_t*)cutoff;
  a.vector_flags = ((uintptr_t)flags & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_lanes) {
    case Tile<128>::kSize: return launch<128>(a, s);
    case Tile<256>::kSize: return launch<256>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
