// Fixed-capacity stream compaction: the first `capacity` indices of a
// flag array whose bit `bit` is set, in ascending order, padded with n;
// the count of set flags on the device; optionally each index's position
// in the list (-1 where it is not listed).
//
// Replaces the fixed-size nonzero of the render (rgbd_recon_tpu/recon/
// tsdf_pipeline.py:1292, :1425, :1465, `jnp.nonzero(size=, fill_value=)`;
// no Pallas kernel), in the port `ops/compact.py compact_plain`, and
// before it `torch.nonzero` and a host sync for each list.
//
// One launch, no host sync. Block b of 1024 threads owns the tile of 8192
// flags [8192 b, 8192 (b + 1)), 8 flags a thread read as one 8-byte word.
// It counts the set flags before its tile itself (the flags as 8-byte
// words, a popcount each: at the render's 184,320 flags the last block
// reads 180 KB from L2), so no block waits for another; then a scan of its
// threads' counts (warp shuffles, then the 32 warp totals) places each set
// flag. The last block writes the count and the padding. The order is
// ascending, so a list past its capacity drops the same indices as the
// reference's nonzero.
//
// Bound on this card: bytes (the flags once, the list, the slot map), a
// few microseconds at the render's sizes. The prefix re-count grows as
// the square of n: block b re-reads 8192 b bytes, n^2 / 16,384 bytes from
// L2 over all blocks (2.1 MB at the 1280x720 render's 184,320 flags over
// 23 blocks), and the last block re-reads all n alone. At a 4K camera's
// ~1.66 M flags (~200 blocks) it is ~170 MB, with 1.66 MB re-read by one
// SM, and the re-count, not the bytes, sets the time. Past ~1 M flags a
// two-pass or decoupled look-back scan should replace it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 1024;
constexpr int ITEMS = 8;
constexpr int TILE = CT * ITEMS;

__device__ __forceinline__ int block_sum(int v, int* warp_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  int t = lane < (CT >> 5) ? warp_buf[lane] : 0;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) warp_buf[32] = t;
  }
  __syncthreads();
  return warp_buf[32];
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
  __syncthreads();
  if (lane == 31) warp_buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (CT >> 5) ? warp_buf[lane] : 0;
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += u;
    }
    warp_buf[lane] = winc - w;  // exclusive prefix of the warp totals
    if (lane == 31) warp_buf[32] = winc;
  }
  __syncthreads();
  *total = warp_buf[32];
  return warp_buf[warp] + inc - v;
}

__global__ void __launch_bounds__(CT)
    compact_kernel(const uint8_t* __restrict__ flags, int n, int bit,
                   int capacity, long long* __restrict__ ids,
                   int* __restrict__ slot, int* __restrict__ count) {
  __shared__ int warp_buf[33];
  const long long tile0 = (long long)blockIdx.x * TILE;
  const unsigned long long sel = 0x0101010101010101ull << bit;
  const unsigned long long* words = (const unsigned long long*)flags;

  // the set flags before this tile (whole words: tile0 is a multiple of 8)
  int before = 0;
  for (long long k = threadIdx.x; k < tile0 / 8; k += CT)
    before += __popcll(__ldg(words + k) & sel);
  const int prefix = block_sum(before, warp_buf);

  // this thread's 8 flags
  const long long base = tile0 + (long long)threadIdx.x * ITEMS;
  unsigned long long word = 0;
  if (base + ITEMS <= n) {
    word = __ldg(words + base / 8) & sel;
  } else {
    for (int j = 0; j < ITEMS && base + j < n; ++j)
      word |= (unsigned long long)flags[base + j] << (8 * j);
    word &= sel;
  }
  int total;
  int pos = prefix + block_exclusive_scan(__popcll(word), warp_buf, &total);
  for (int j = 0; j < ITEMS && base + j < n; ++j) {
    const long long i = base + j;
    int s = -1;
    if ((word >> (8 * j + bit)) & 1ull) {
      if (pos < capacity) {
        ids[pos] = i;
        s = pos;
      }
      ++pos;
    }
    if (slot != nullptr) slot[i] = s;
  }

  if (blockIdx.x == gridDim.x - 1) {
    const int all = prefix + total;
    if (threadIdx.x == 0) *count = all;
    for (int p = all + threadIdx.x; p < capacity; p += CT) ids[p] = n;
  }
}

}  // namespace

extern "C" {

// flags: n bytes, 8-byte aligned; ids: capacity int64; slot: n int32 or
// null; count: one int32. n and capacity below 2^31.
int rgbd_compact(const void* flags, int n, int bit, int capacity, void* ids,
                 void* slot, void* count, void* stream) {
  if (n < 0 || capacity < 0 || bit < 0 || bit > 7)
    return (int)cudaErrorInvalidValue;
  const int blocks = n > 0 ? (n + TILE - 1) / TILE : 1;
  compact_kernel<<<blocks, CT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, n, bit, capacity, (long long*)ids, (int*)slot,
      (int*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
