// Fixed-capacity stream compaction: the first `capacity` indices of a
// flag array whose bit `bit` is set, in ascending order, padded with n;
// the count of set flags on the device; optionally each index's position
// in the list (-1 where it is not listed).
//
// Replaces the fixed-size nonzero of the render (rgbd_recon_tpu/recon/
// tsdf_pipeline.py:1292, :1425, :1465, `jnp.nonzero(size=, fill_value=)`;
// no Pallas kernel), in the port `ops/compact.py compact_plain`.
//
// One launch, no host sync: a single-pass scan with decoupled look-back.
//  - Tiles. A block of 256 threads owns a tile of 2,048 flags, 8 a thread
//    read as one 8-byte word, counted with a mask and a popcount; a
//    warp-shuffle scan and a scan of the 8 warp totals place each set flag
//    inside the tile. At the render's 184,320 flags that is 90 tiles.
//  - Tile order. A block takes its tile from an atomic ticket, in the
//    order blocks start, not from blockIdx: a tile only waits on tiles
//    whose blocks are already running, so the look-back cannot deadlock.
//  - Look-back. Each tile publishes its count (state AGGREGATE), then its
//    inclusive prefix (state PREFIX), in one 64-bit status word: the state
//    in the top 2 bits, the count below. A word carries all it says, so
//    the words are stored and read relaxed at GPU scope (ld/st.relaxed.gpu).
//    Warp 0 reads 32 predecessors a step (one a lane), waits while any is
//    unpublished, and adds the counts up to the nearest PREFIX (a ballot
//    finds it, shuffles add). A wider step (256 predecessors, 8 a lane)
//    measured as fast at the render's sizes and about twice as slow past a
//    million flags (thousands of tiles spinning on 8 reads a lane). No
//    block reads a flag that is not its own: O(n + tiles) bytes.
//  - Writes. The tile's listed ids are staged in shared memory and stored
//    to ids[prefix ...] as contiguous runs; the slot map is staged too and
//    stored as 16-byte words. The last tile in flag order knows the total
//    and writes the count.
//  - Padding. The grid has one more block for each 8,192 entries of the
//    capacity; such a block takes its ticket after every tile's (so every
//    tile is running or done), waits for the last tile's PREFIX, and
//    writes n over its chunk's part of [count, capacity): the padding
//    (up to the whole capacity) is spread over many SMs.
//  - Scratch. The ticket, a done-counter and the status words live in a
//    zeroed buffer of rgbd_compact_scratch_words() words that the caller
//    keeps for its stream (kernels/compact.py: one a device and stream).
//    The block that finishes last (the done-counter, after a fence in
//    every block) clears the statuses, the ticket and the counter, so
//    every launch finds them zeroed: launches back to back on a stream
//    and replays of a CUDA graph need no memset and no argument that
//    changes between launches. Two launches that share a buffer must not
//    run at once.
// The order is ascending, so a list past its capacity drops the same
// indices as the reference's nonzero.
//
// Bound on this card: bytes (the flags once, the list, the slot map; a few
// tenths of a microsecond at the render's sizes), so at the render's sizes
// latency sets the time: the ticket, the cold flags, the look-back's
// steps, the padding blocks' wait for the total.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 256;
constexpr int WARPS = CT / 32;
constexpr int TILE = CT * 8;
// n < 2^31 flags: at most 2^31 / 2,048 tiles
constexpr int MAX_TILES = (int)((1ll << 31) / TILE);
// list entries a padding block writes at most
constexpr int PAD = 8192;

constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long PREFIX = 2ull << 62;
constexpr unsigned long long COUNT_MASK = (1ull << 62) - 1;

// the look-back's scratch, zero between launches: the ticket and the
// done-counter in word 0, tile t's status in word 1 + t
struct Scratch {
  unsigned int* ticket;
  unsigned int* done;
  unsigned long long* status;
};

__device__ __forceinline__ Scratch scratch_of(unsigned long long* words) {
  return {(unsigned int*)words, (unsigned int*)words + 1, words + 1};
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// exclusive scan of v over the block; *total receives the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_buf,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_buf[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = warp_buf[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *total = all;
  return before + inc - v;
}

// the set flags before tile t (t > 0), by warp 0 of its block
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  int last = t - 1;  // the nearest predecessor not yet added
  while (true) {
    // lane l reads predecessor last - l
    const int k = last - lane;
    unsigned long long s;
    do {
      s = k >= 0 ? load_relaxed(status + k) : PREFIX;
    } while (!__all_sync(0xffffffffu, (s >> 62) != 0));
    // the nearest PREFIX (the lowest lane that has one) ends the walk; what
    // lies past it adds nothing
    const unsigned has = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    const int stop = has ? __ffs(has) - 1 : 31;
    long long c = lane <= stop ? (long long)(s & COUNT_MASK) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    before += c;
    if (has) return before;
    last -= 32;
  }
}

// tile t: its flags counted, its prefix found, its list entries and slots
// written; the last tile writes the count
__device__ __forceinline__ void tile_pass(
    const uint8_t* __restrict__ flags, int n, int tiles, int t, int bit,
    int capacity, long long* __restrict__ ids, int* __restrict__ slot,
    int* __restrict__ count, unsigned long long* status) {
  __shared__ int warp_buf[WARPS];
  __shared__ long long s_prefix;
  __shared__ unsigned short s_ids[TILE];
  __shared__ __align__(16) short s_slot[TILE];
  const int tid = threadIdx.x;
  const long long tile0 = (long long)t * TILE;
  const unsigned long long sel = 0x0101010101010101ull << bit;

  // flags 8 tid ... 8 tid + 7 of the tile, a byte a flag
  const long long base = tile0 + 8ll * tid;
  unsigned long long word = 0;
  if (base + 8 <= n) {
    word = __ldg((const unsigned long long*)flags + base / 8);
  } else {
    for (int j = 0; j < 8 && base + j < n; ++j)
      word |= (unsigned long long)flags[base + j] << (8 * j);
  }
  word &= sel;
  int total;
  const int off = block_exclusive_scan(__popcll(word), warp_buf, &total);

  // publish the tile's count at once, then find its prefix
  if (tid < 32) {
    if (t == 0) {
      if (tid == 0) {
        store_relaxed(status, PREFIX | (unsigned long long)total);
        s_prefix = 0;
      }
    } else {
      if (tid == 0)
        store_relaxed(status + t, AGGREGATE | (unsigned long long)total);
      const long long before = look_back(status, t);
      if (tid == 0) {
        store_relaxed(status + t,
                      PREFIX | (unsigned long long)(before + total));
        s_prefix = before;
      }
    }
  }
  // meanwhile every thread stages its listed flags (tile-local indices at
  // their tile-local positions) and its slots (tile-local positions, -1
  // unset), 8 slots a 16-byte store
  int pos = off;
  unsigned int sl[4] = {0u, 0u, 0u, 0u};  // 8 slots, 2 a word
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool set = (word >> (8 * j + bit)) & 1ull;
    if (set) s_ids[pos] = (unsigned short)(8 * tid + j);
    sl[j / 2] |= (set ? (unsigned int)pos : 0xffffu) << (16 * (j % 2));
    pos += set;
  }
  *(uint4*)(s_slot + 8 * tid) = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  __syncthreads();
  const long long prefix = s_prefix;

  // the list: contiguous runs from ids[prefix]
  for (int k = tid; k < total && prefix + k < capacity; k += CT)
    ids[prefix + k] = tile0 + s_ids[k];

  // the slot map: tile-local positions made global, 4 slots a store
  if (slot != nullptr) {
    const int len = (int)min((long long)TILE, (long long)n - tile0);
    auto global_slot = [&](int local) -> int {
      return (local >= 0 && prefix + local < capacity) ? (int)(prefix + local)
                                                       : -1;
    };
    if (len == TILE) {
      int4* dst = (int4*)(slot + tile0);
      for (int q = tid; q < TILE / 4; q += CT) {
        const short4 v = ((const short4*)s_slot)[q];
        dst[q] = make_int4(global_slot(v.x), global_slot(v.y),
                           global_slot(v.z), global_slot(v.w));
      }
    } else {
      for (int k = tid; k < len; k += CT)
        slot[tile0 + k] = global_slot(s_slot[k]);
    }
  }
  if (t == tiles - 1 && tid == 0) *count = (int)(prefix + total);
}

// padding block j: ids[p] = n for p in [count, capacity) within its chunk
// [PAD j, PAD (j + 1)), once the last tile has published the total
__device__ __forceinline__ void pad_pass(int n, int tiles, int j,
                                         int capacity,
                                         long long* __restrict__ ids,
                                         const unsigned long long* status) {
  __shared__ long long s_total;
  if (threadIdx.x == 0) {
    unsigned long long s;
    while (((s = load_relaxed(status + tiles - 1)) >> 62) != 2)
      __nanosleep(64);
    s_total = (long long)(s & COUNT_MASK);
  }
  __syncthreads();
  const long long hi = min((long long)(j + 1) * PAD, (long long)capacity);
  for (long long p = max(s_total, (long long)j * PAD) + threadIdx.x; p < hi;
       p += CT)
    ids[p] = n;
}

__global__ void __launch_bounds__(CT)
    compact_kernel(const uint8_t* __restrict__ flags, int n, int tiles,
                   int pads, int bit, int capacity,
                   long long* __restrict__ ids, int* __restrict__ slot,
                   int* __restrict__ count, unsigned long long* words) {
  __shared__ int s_ticket;
  __shared__ bool s_last_done;
  const Scratch sc = scratch_of(words);
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(sc.ticket, 1u);
  __syncthreads();
  const int t = s_ticket;
  if (t < tiles)
    tile_pass(flags, n, tiles, t, bit, capacity, ids, slot, count,
              sc.status);
  else
    pad_pass(n, tiles, t - tiles, capacity, ids, sc.status);

  // the block that finishes last clears the scratch for the next launch
  // (every other block has read and written its statuses by then)
  if (threadIdx.x == 0) {
    __threadfence();
    s_last_done = atomicAdd(sc.done, 1u) == (unsigned)(tiles + pads - 1);
  }
  __syncthreads();
  if (s_last_done) {
    __threadfence();
    for (int k = threadIdx.x; k < tiles; k += CT) sc.status[k] = 0ull;
    if (threadIdx.x == 0) {
      *sc.ticket = 0u;
      *sc.done = 0u;
    }
  }
}

}  // namespace

extern "C" {

// 8-byte words of the zeroed scratch a launch needs (any n below 2^31)
int rgbd_compact_scratch_words() { return 1 + MAX_TILES; }

// flags: n bytes, 8-byte aligned; ids: capacity int64; slot: n int32
// (16-byte aligned) or null; count: one int32; scratch: the zeroed
// rgbd_compact_scratch_words() words of this stream. n and capacity below
// 2^31.
int rgbd_compact(const void* flags, int n, int bit, int capacity, void* ids,
                 void* slot, void* count, void* scratch, void* stream) {
  if (n < 0 || capacity < 0 || bit < 0 || bit > 7 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = n > 0 ? (int)((n + (long long)TILE - 1) / TILE) : 1;
  const int pads = (int)(((long long)capacity + PAD - 1) / PAD);
  compact_kernel<<<tiles + pads, CT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, n, tiles, pads, bit, capacity, (long long*)ids,
      (int*)slot, (int*)count, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
