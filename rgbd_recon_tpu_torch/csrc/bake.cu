// March-volume bake: the surface-brick mask, the brick clearance, the
// sentinel-coded march table and the oct hit table's corner rows.
//
// surface_occ and sentinel_bake replace the Pallas TPU kernels
// surface_occ_tpu and sentinel_bake_tpu of
// rgbd_recon_tpu/ops/bake_pallas.py; brick_clearance and oct_table replace
// XLA stages of the JAX package's jitted render (below).
//
// surface_occ: a brick is set iff some voxel of its box, grown by one voxel
// on each side and clipped to the volume, is > 0 (the brick any-pool of the
// 1-voxel box dilation of volume > 0, with zero padding at the faces).
// Bound: bytes, one read of the volume (35.2 MB at 200x220x200, 10.5 us at
// 3.35 TB/s). Design, two launches that read the volume once:
//  1. pack_positive (below, shared with sentinel_bake): volume > 0 as
//     32-voxel bit words along z (1.2 MB of words at reference scale). A
//     variant with four lanes a word, each with its 8 loads in flight at
//     once (4x the threads, one round trip each), ran slower on the H100
//     with a cold and with a warm L2 (PERF.md §6);
//  2. brick_occ: one block per (by, bx) column of bricks. Its warps OR,
//     word by word along z, the words of the columns of the bricks'
//     footprint grown by one voxel (lanes over the columns, then a warp
//     OR-reduction) into shared memory; then one thread per brick of the
//     column tests the bits of its grown z range. Each word is read by the
//     1-4 brick columns whose grown footprints hold it, from L2.
// The first port's one-block-per-brick kernel walked each grown box with
// three divisions a voxel and re-read the halos (1.73x the volume).
//
// sentinel_bake: for every voxel
//   fine  = clamp(cheb - 1, 0, K)      (cheb: Chebyshev distance to the
//                                       nearest voxel > 0)
//         = the number of the K box-dilation rounds of volume > 0 that have
//           not reached the voxel
//   field = max(fine, bs_scaled[brick of the voxel])
//   out   = field > 0 ? -(2 + field) : tsdf value, as bf16 (RNE) or f32.
// Bound: bytes. The function must read the f32 volume once and write the
// table once (52.8 MB in bf16 at reference scale, 15.8 us at 3.35 TB/s).
// Design, three launches (one, the encode, when K = 0):
//  1. pack_positive: volume > 0 as 32-voxel bit words along z, one thread
//     per 4 (y, x) columns (1 where X is not a multiple of 4) and word,
//     float4 loads 8 in flight (1.2 MB of words at reference scale).
//  2. dilate_count: one 32 x 32 block of threads per tile of (y, x)
//     columns, one column a thread, its words along z in registers (the
//     whole column up to 224 voxels; longer columns go in chunks of 5
//     words with one word of halo each side). The tile overlaps its
//     neighbours by K columns each side, so its (32 - 2K)^2 core columns
//     see every voxel within K. Each of the K box-dilation rounds, as the
//     TPU kernel runs them, is a shift with carry between the words of a
//     column (z), a warp shuffle from the lanes beside it (x) and an
//     exchange through shared memory with the rows beside it (y); a
//     bit-sliced counter in registers adds the voxels each round missed.
//     The core columns write the counters' P bit planes (P = bits of K;
//     3.7 MB at K = 6). One launch takes at most PASS_ROUNDS = 15 rounds
//     (a core of 2 columns); K > 15 runs ceil(K / 15) launches of about
//     K / passes rounds each: every launch but the last also writes the
//     dilated words of its core columns, which the next one dilates
//     further, and adds its counts to the planes (a bit-sliced ripple
//     add). Rounds compose: a voxel at distance d misses clamp(d - 1, 0,
//     Ka) of the first Ka rounds and clamp(d - 1 - Ka, 0, Kb) of the next
//     Kb, clamp(d - 1, 0, Ka + Kb) in all. Dilated words past the volume
//     (bits past Z, columns outside) only ever hold voxels within the
//     rounds' reach of a positive one, so they change no count.
//  3. encode: one thread per 4 voxels along x (1 where X is not a multiple
//     of 4) at 8 successive z, neighbouring threads on neighbouring x: its
//     plane words read once, then per z one float4 read of the volume and
//     the table written as 4 bf16 (8 bytes) or a float4. Brick indices come
//     from a multiply-high by a reciprocal of brick_vox, exact below 2^16.
// Indices are 32-bit products of grid coordinates; no thread divides a
// 64-bit index. What stays above the bound: the volume is read twice (the
// pack and the encode, 88 MB against 52.8), and the dilation rounds run
// between the two passes.
// Every value is an integer or a copy until the single rounding, so the
// output is bit-exact against the plain version (ops/bake.py).
//
// brick_clearance: the render bake's brick-level clearance to the surface
// bricks. Replaces no Pallas kernel: the XLA ops of brick_safe_field
// (rgbd_recon_tpu/recon/tsdf_pipeline.py:1042), R = skip_brick_rounds
// 3x3x3 dilations of the (Bz, By, Bx) surface-brick mask, which the port
// ran as ~40 torch launches (ops/bake.py brick_clearance_plain). For each
// brick, with D the Chebyshev distance in bricks to the nearest set brick
// inside the grid (infinite when none is set):
//   bsafe     = min(max(D - 1, 0), R)   (the rounds that miss the brick)
//   bs_scaled = bsafe * brick_vox       (sentinel_bake's input; small
//                                        integers, so the product is exact)
// It need not repeat the R dilations: the Chebyshev distance is separable,
// the distance along x, then the min over dy of max(|dy|, that), then the
// same over dz, each capped at R + 1 (so a byte holds it: R <= 254). A
// pass along y or z stops at the first |d| not below the best so far.
// Bound: launch latency (8,800 bricks: 8.8 KB in, 70.4 KB out, 0.024 us
// at 3.35 TB/s). Design: one cooperative launch of a thread a brick
// (grid-strided past what the card holds at once), the passes between two
// grid barriers over two byte planes in global memory (L2). One block of
// 1,024 threads holding the grid and its two planes in shared memory
// measured 3-4x slower on the H100 (its one SM issues every brick's taps;
// PERF.md §6).
//
// oct_table: the oct hit table's corner rows. Replaces no Pallas kernel:
// the XLA gathers of build_oct_bricks (rgbd_recon_tpu/ops/raymarch.py:351),
// which the port ran as ~25 torch launches (ops/raymarch.py
// oct_rows_plain). For each slot of compact's ascending list of surface
// bricks (padded with B; the id clamped to B - 1, as the JAX code's idc),
// each voxel (lz, ly, lx) of the brick gets one row of the eight corners
// of the cell it anchors, in the order dz*4 + dy*2 + dx, edge-clamped at
// the volume's faces, rounded to the table's type as Tensor.to rounds
// (bf16 round-to-nearest-even, or f32 unchanged). Bound: bytes (the
// slots' extended bricks read once, the rows written once: 4.09 + 12.29
// MB in bf16 at 768 slots of 10-voxel bricks, 4.9 us at 3.35 TB/s).
// Design: a block a slot; its (v+1)^3 extended brick staged in shared
// memory (5.3 KB at v = 10; neighbouring threads load neighbouring x of a
// run), then a thread a row, neighbouring threads on neighbouring rows,
// each row one 16-byte store (bf16) or two (f32). Bricks whose extended
// block passes 48 KB (v > 22) read their corners from global memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 32;       // bake block: BT x BT threads, one column each
constexpr int ZREG = 7;      // words of a column in registers
// the rounds of one dilate_count launch: K halo columns each side leave a
// core of BT - 2K
constexpr int PASS_ROUNDS = 15;
// the most rounds in all (8 bit planes); kernels/bake.py MAX_ROUNDS holds
// the same limit
constexpr int MAX_PLANES = 8;
constexpr int MAX_ROUNDS = (1 << MAX_PLANES) - 1;
constexpr int PACK_TY = 8;   // pack block: 32 x 8 threads

// bits[zw][y][x]: bit i is volume[32 zw + i, y, x] > 0; bits past Z are 0.
// VEC = 4: a thread packs columns x .. x+3 (X % 4 == 0) from float4 loads,
// 8 in flight at a time; VEC = 1: one column.
template <int VEC>
__global__ void pack_positive_kernel(const float* __restrict__ vol,
                                     uint32_t* __restrict__ bits, int Z,
                                     int Y, int X) {
  const int x = (blockIdx.x * 32 + threadIdx.x) * VEC;
  const int y = blockIdx.y * PACK_TY + threadIdx.y;
  const int zw = blockIdx.z;
  if (x >= X || y >= Y) return;
  const size_t plane = (size_t)Y * X;
  const float* p = vol + (size_t)zw * 32 * plane + (size_t)y * X + x;
  const int nz = min(32, Z - zw * 32);
  const size_t o = ((size_t)zw * Y + y) * X + x;
  if (VEC == 4) {
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    for (int i0 = 0; i0 < nz; i0 += 8) {
      float4 f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < nz)
          f[i] = *reinterpret_cast<const float4*>(p + (i0 + i) * plane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < nz) {
          w0 |= (f[i].x > 0.0f ? 1u : 0u) << (i0 + i);
          w1 |= (f[i].y > 0.0f ? 1u : 0u) << (i0 + i);
          w2 |= (f[i].z > 0.0f ? 1u : 0u) << (i0 + i);
          w3 |= (f[i].w > 0.0f ? 1u : 0u) << (i0 + i);
        }
      }
    }
    *reinterpret_cast<uint4*>(bits + o) = make_uint4(w0, w1, w2, w3);
  } else {
    uint32_t w = 0;
    for (int i = 0; i < nz; ++i) w |= (p[i * plane] > 0.0f ? 1u : 0u) << i;
    bits[o] = w;
  }
}

// pack_positive over the whole volume: ZW = ceil(Z / 32) words a column
int launch_pack(const float* vol, uint32_t* bits, int Z, int Y, int X,
                cudaStream_t s) {
  const int ZW = (Z + 31) / 32;
  if (X % 4 == 0) {
    const dim3 grid((X / 4 + 31) / 32, (Y + PACK_TY - 1) / PACK_TY, ZW);
    pack_positive_kernel<4><<<grid, dim3(32, PACK_TY), 0, s>>>(vol, bits, Z,
                                                               Y, X);
  } else {
    const dim3 grid((X + 31) / 32, (Y + PACK_TY - 1) / PACK_TY, ZW);
    pack_positive_kernel<1><<<grid, dim3(32, PACK_TY), 0, s>>>(vol, bits, Z,
                                                               Y, X);
  }
  return (int)cudaGetLastError();
}

constexpr int OCC_WARPS = 8;  // brick_occ block: 8 warps

// out[bz][by][bx] for the column of bricks (by, bx) = (blockIdx.y,
// blockIdx.x): 1 iff a bit of bits is set in the brick's box grown by one
// voxel and clipped to the volume. Dynamic shared memory: ZW words.
__global__ void __launch_bounds__(32 * OCC_WARPS)
brick_occ_kernel(const uint32_t* __restrict__ bits,
                 unsigned char* __restrict__ out, int Z, int Y, int X,
                 int ZW, int v, int Bz, int By, int Bx) {
  extern __shared__ uint32_t grown[];  // [zw]: OR over the grown footprint
  const int by = blockIdx.y, bx = blockIdx.x;
  const int y0 = max(by * v - 1, 0), y1 = min(by * v + v, Y - 1);
  const int x0 = max(bx * v - 1, 0), x1 = min(bx * v + v, X - 1);
  const int nx = x1 - x0 + 1;
  const int cols = (y1 - y0 + 1) * nx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int zw = warp; zw < ZW; zw += OCC_WARPS) {
    const uint32_t* plane = bits + ((size_t)zw * Y + y0) * X + x0;
    uint32_t acc = 0u;
    for (int c = lane; c < cols; c += 32) {
      const int cy = c / nx;
      acc |= plane[(size_t)cy * X + (c - cy * nx)];
    }
    acc = __reduce_or_sync(0xffffffffu, acc);
    if (lane == 0) grown[zw] = acc;
  }
  __syncthreads();
  for (int bz = threadIdx.x; bz < Bz; bz += 32 * OCC_WARPS) {
    const int z0 = max(bz * v - 1, 0), z1 = min(bz * v + v, Z - 1);
    bool found = false;
    for (int zw = z0 >> 5; zw <= z1 >> 5; ++zw) {
      // bits z0 - 32 zw .. z1 - 32 zw of the word, clipped to 0 .. 31
      const int lo = max(z0 - 32 * zw, 0), hi = min(z1 - 32 * zw, 31);
      const uint32_t mask = (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
      found |= (grown[zw] & mask) != 0u;
    }
    out[((size_t)bz * By + by) * Bx + bx] = found ? 1 : 0;
  }
}

// K <= PASS_ROUNDS rounds of src. P: bit planes of this launch's
// per-voxel counters (enough for K, P >= 1). planes[p][zw][y][x], p <
// ptot: bit i counts, in binary digit p, the rounds that missed voxel
// (32 zw + i, y, x); this launch's counts are written there (accumulate
// = 0) or added to what is there (accumulate = 1). dst, unless null,
// gets the words of src dilated by the K rounds.
template <int P>
__global__ void __launch_bounds__(BT * BT, 1)
dilate_count_kernel(const uint32_t* __restrict__ src,
                    uint32_t* __restrict__ dst,
                    uint32_t* __restrict__ planes, int Y, int X, int ZW,
                    int K, int ptot, int accumulate) {
  __shared__ uint32_t ex[BT][ZREG][BT];  // the y exchange: [row][word][lane]
  const int lane = threadIdx.x, row = threadIdx.y;
  const int core = BT - 2 * K;
  const int x = blockIdx.x * core - K + lane;
  const int y = blockIdx.y * core - K + row;
  // the column's words in registers: all of them, or a chunk of
  // ZREG - 2 core words with one halo word each side
  const bool whole = ZW <= ZREG;
  const int base = whole ? 0 : blockIdx.z * (ZREG - 2) - 1;
  const int k_lo = whole ? 0 : 1;
  const int k_hi = whole ? ZW : min(ZREG - 1, ZW - base);
  const bool inside = x >= 0 && x < X && y >= 0 && y < Y;
  uint32_t c[ZREG];
#pragma unroll
  for (int k = 0; k < ZREG; ++k) {
    const int wz = base + k;
    c[k] = (inside && wz >= 0 && wz < ZW) ? src[(wz * Y + y) * X + x] : 0u;
  }
  uint32_t cnt[P][ZREG];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < ZREG; ++k) cnt[p][k] = 0u;

  for (int r = 0; r < K; ++r) {
    uint32_t t[ZREG];
#pragma unroll
    for (int k = 0; k < ZREG; ++k) {
      // z: the neighbours in the word, and across the word boundaries
      const uint32_t lo = k > 0 ? c[k - 1] >> 31 : 0u;
      const uint32_t hi = k < ZREG - 1 ? c[k + 1] << 31 : 0u;
      t[k] = c[k] | (c[k] << 1) | (c[k] >> 1) | lo | hi;
    }
#pragma unroll
    for (int k = 0; k < ZREG; ++k) {
      // x: the lanes beside (lanes 0 and 31 get their own word back,
      // which changes nothing)
      t[k] |= __shfl_up_sync(0xffffffffu, t[k], 1) |
              __shfl_down_sync(0xffffffffu, t[k], 1);
    }
    __syncthreads();  // the last round's reads of ex are done
#pragma unroll
    for (int k = 0; k < ZREG; ++k) ex[row][k][lane] = t[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ZREG; ++k) {
      // y: the rows beside
      const uint32_t up = row > 0 ? ex[row - 1][k][lane] : 0u;
      const uint32_t dn = row < BT - 1 ? ex[row + 1][k][lane] : 0u;
      c[k] = t[k] | up | dn;
      // bit-sliced increment of the counters by the missed voxels
      uint32_t carry = ~c[k];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint32_t s = cnt[p][k];
        cnt[p][k] = s ^ carry;
        carry &= s;
      }
    }
  }

  // the core columns write their counters (and dilated words)
  if (!inside || lane < K || lane >= K + core || row < K ||
      row >= K + core)
    return;
  const size_t plane_words = (size_t)ZW * Y * X;
#pragma unroll
  for (int k = 0; k < ZREG; ++k) {
    if (k < k_lo || k >= k_hi) continue;
    const size_t i = ((size_t)(base + k) * Y + y) * X + x;
    if (dst != nullptr) dst[i] = c[k];
    // planes += cnt, bit-sliced with a ripple carry (planes = cnt on the
    // first launch)
    uint32_t carry = 0u;
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p) {
      if (p >= ptot) break;
      const uint32_t b = p < P ? cnt[p < P ? p : 0][k] : 0u;
      const uint32_t a = accumulate ? planes[p * plane_words + i] : 0u;
      planes[p * plane_words + i] = a ^ b ^ carry;
      carry = (a & b) | (carry & (a ^ b));
    }
  }
}

__device__ __forceinline__ float encode(int fine, float bs, float tsdf) {
  const float field = fmaxf((float)fine, bs);
  return field > 0.0f ? -(2.0f + field) : tsdf;
}

// floor(n / v) for n, v < 2^16 from m = ceil(2^32 / v)
__device__ __forceinline__ int div_small(int n, unsigned long long m) {
  return (int)(((unsigned long long)n * m) >> 32);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i,
                                       const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = w;
}

__device__ __forceinline__ void store4(float* out, size_t i,
                                       const float (&a)[4]) {
  *reinterpret_cast<float4*>(out + i) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* out, size_t i,
                                       float a) {
  out[i] = __float2bfloat16_rn(a);
}

__device__ __forceinline__ void store1(float* out, size_t i, float a) {
  out[i] = a;
}

constexpr int ENC_TY = 8;  // encode block: 32 x 8 threads
constexpr int ENC_Z = 8;   // voxels along z a thread (divides 32)

// VEC = 4: a thread encodes voxels x .. x+3 (X % 4 == 0) at ENC_Z
// successive z, reading its plane words once; VEC = 1: one x.
template <typename OutT, int P, int VEC>
__global__ void encode_kernel(const float* __restrict__ vol,
                              const uint32_t* __restrict__ planes,
                              const float* __restrict__ bs_scaled,
                              OutT* __restrict__ out, int Z, int Y, int X,
                              int ZW, unsigned long long inv_v, int By,
                              int Bx) {
  const int x = (blockIdx.x * 32 + threadIdx.x) * VEC;
  const int y = blockIdx.y * ENC_TY + threadIdx.y;
  const int z0 = blockIdx.z * ENC_Z;
  if (x >= X || y >= Y) return;
  const size_t plane = (size_t)Y * X;
  const size_t plane_words = (size_t)ZW * plane;
  const size_t w = ((size_t)(z0 >> 5) * Y + y) * X + x;
  const int by = div_small(y, inv_v);
  int bx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) bx[e] = div_small(x + e, inv_v);
  // the counter words of the VEC columns, one per binary digit
  uint32_t q[P > 0 ? P : 1][VEC];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (VEC == 4) {
      const uint4 t =
          *reinterpret_cast<const uint4*>(planes + p * plane_words + w);
      q[p][0] = t.x;
      q[p][VEC > 1 ? 1 : 0] = t.y;
      q[p][VEC > 2 ? 2 : 0] = t.z;
      q[p][VEC > 3 ? 3 : 0] = t.w;
    } else {
      q[p][0] = planes[p * plane_words + w];
    }
  }
#pragma unroll
  for (int iz = 0; iz < ENC_Z; ++iz) {
    const int z = z0 + iz;
    if (z >= Z) break;
    const int bit = z & 31;
    const float* bs_row = bs_scaled + (div_small(z, inv_v) * By + by) * Bx;
    const size_t i = (size_t)z * plane + (size_t)y * X + x;
    float a[4];
    if (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(vol + i);
      a[0] = t.x;
      a[1] = t.y;
      a[2] = t.z;
      a[3] = t.w;
    } else {
      a[0] = vol[i];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      int fine = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) fine |= (int)((q[p][e] >> bit) & 1u) << p;
      a[e] = encode(fine, bs_row[bx[e]], a[e]);
    }
    if (VEC == 4)
      store4(out, i, a);
    else
      store1(out, i, a[0]);
  }
}

int bits_for(int k) {
  int p = 0;
  while ((1 << p) <= k) ++p;
  return p;
}

// one dilate_count launch of K <= PASS_ROUNDS rounds
template <int P>
int launch_dilate(const uint32_t* src, uint32_t* dst, uint32_t* planes,
                  int Y, int X, int ZW, int K, int ptot, int accumulate,
                  cudaStream_t s) {
  const int core = BT - 2 * K;
  const int chunks = ZW <= ZREG ? 1 : (ZW + ZREG - 3) / (ZREG - 2);
  const dim3 grid((X + core - 1) / core, (Y + core - 1) / core, chunks);
  dilate_count_kernel<P><<<grid, dim3(BT, BT), 0, s>>>(
      src, dst, planes, Y, X, ZW, K, ptot, accumulate);
  return (int)cudaGetLastError();
}

// pack, then the K >= 1 rounds into the ptot bit planes after the words in
// bits: ceil(K / PASS_ROUNDS) launches, their rounds as equal as they can
// be; the dilated words go back and forth between bits and the spare
// words after the planes
int launch_rounds(const float* vol, uint32_t* bits, int Z, int Y, int X,
                  int ZW, int K, int ptot, cudaStream_t s) {
  int err = launch_pack(vol, bits, Z, Y, X, s);
  if (err) return err;
  const size_t words = (size_t)ZW * Y * X;
  uint32_t* planes = bits + words;
  uint32_t* src = bits;
  uint32_t* spare = planes + (size_t)ptot * words;
  const int passes = (K + PASS_ROUNDS - 1) / PASS_ROUNDS;
  for (int j = 0; j < passes; ++j) {
    const int k = K / passes + (j < K % passes ? 1 : 0);
    uint32_t* dst = j + 1 < passes ? spare : nullptr;
    const int acc = j > 0 ? 1 : 0;
    switch (bits_for(k)) {
      case 1:
        err = launch_dilate<1>(src, dst, planes, Y, X, ZW, k, ptot, acc, s);
        break;
      case 2:
        err = launch_dilate<2>(src, dst, planes, Y, X, ZW, k, ptot, acc, s);
        break;
      case 3:
        err = launch_dilate<3>(src, dst, planes, Y, X, ZW, k, ptot, acc, s);
        break;
      default:
        err = launch_dilate<4>(src, dst, planes, Y, X, ZW, k, ptot, acc, s);
    }
    if (err) return err;
    spare = src;
    src = dst;
  }
  return 0;
}

template <typename OutT, int P>
int launch_encode(const float* vol, const float* bs_scaled, OutT* out,
                  const uint32_t* planes, int Z, int Y, int X, int ZW, int v,
                  int By, int Bx, cudaStream_t s) {
  const unsigned long long inv_v = ((1ull << 32) + v - 1) / v;
  const int zblocks = (Z + ENC_Z - 1) / ENC_Z;
  if (X % 4 == 0) {
    const dim3 grid((X / 4 + 31) / 32, (Y + ENC_TY - 1) / ENC_TY, zblocks);
    encode_kernel<OutT, P, 4><<<grid, dim3(32, ENC_TY), 0, s>>>(
        vol, planes, bs_scaled, out, Z, Y, X, ZW, inv_v, By, Bx);
  } else {
    const dim3 grid((X + 31) / 32, (Y + ENC_TY - 1) / ENC_TY, zblocks);
    encode_kernel<OutT, P, 1><<<grid, dim3(32, ENC_TY), 0, s>>>(
        vol, planes, bs_scaled, out, Z, Y, X, ZW, inv_v, By, Bx);
  }
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_bake(const float* vol, const float* bs_scaled, OutT* out,
                uint32_t* bits, int Z, int Y, int X, int v, int K, int By,
                int Bx, cudaStream_t s) {
  const int ZW = (Z + 31) / 32;
  const int ptot = bits_for(K);
  if (K > 0) {
    const int err = launch_rounds(vol, bits, Z, Y, X, ZW, K, ptot, s);
    if (err) return err;
  }
  const uint32_t* planes = bits + (size_t)ZW * Y * X;
#define RGBD_ENCODE(P)                                                      \
  return launch_encode<OutT, P>(vol, bs_scaled, out, planes, Z, Y, X, ZW, v, \
                                By, Bx, s)
  switch (ptot) {
    case 0: RGBD_ENCODE(0);
    case 1: RGBD_ENCODE(1);
    case 2: RGBD_ENCODE(2);
    case 3: RGBD_ENCODE(3);
    case 4: RGBD_ENCODE(4);
    case 5: RGBD_ENCODE(5);
    case 6: RGBD_ENCODE(6);
    case 7: RGBD_ENCODE(7);
    default: RGBD_ENCODE(8);
  }
#undef RGBD_ENCODE
}


// ---- brick_clearance -------------------------------------------------------

constexpr int CLR_THREADS = 256;        // threads a block
// the most rounds: distances capped at R + 1 fit a byte
constexpr int CLR_MAX_ROUNDS = 254;

// distance along x from brick i (column x of its row) to the nearest set
// brick of the row, capped at R + 1
__device__ __forceinline__ unsigned char clr_x(const unsigned char* occ,
                                               int i, int x, int Bx, int R) {
  const unsigned char* row = occ + (i - x);
  for (int k = 0; k <= R; ++k) {
    const bool lo = x - k >= 0, hi = x + k < Bx;
    if (!lo && !hi) break;
    if ((lo && row[x - k]) || (hi && row[x + k])) return (unsigned char)k;
  }
  return (unsigned char)(R + 1);
}

// min over d of max(|d|, p[i + d s]) along an axis of extent E where brick
// i sits at coordinate c: the distance over this axis and the ones before
__device__ __forceinline__ int clr_fold(const unsigned char* p, int i, int c,
                                        int E, int s) {
  int best = p[i];
  for (int k = 1; k < best; ++k) {
    const bool lo = c - k >= 0, hi = c + k < E;
    if (!lo && !hi) break;
    int t = 255;
    if (lo) t = p[i - k * s];
    if (hi) t = min(t, (int)p[i + k * s]);
    best = min(best, max(k, t));
  }
  return best;
}

__device__ __forceinline__ void clr_store(float* __restrict__ bsafe,
                                          float* __restrict__ bs, int i,
                                          int d, float v) {
  const float f = (float)(d > 0 ? d - 1 : 0);
  bsafe[i] = f;
  bs[i] = f * v;
}

// one cooperative launch, a thread a brick (grid-strided): the x
// distances of the mask into plane a, a grid barrier, their y fold into
// plane b, a grid barrier, the z fold of b out
__global__ void __launch_bounds__(CLR_THREADS)
clearance_grid_kernel(const unsigned char* __restrict__ occ,
                      unsigned char* __restrict__ a,
                      unsigned char* __restrict__ b,
                      float* __restrict__ bsafe, float* __restrict__ bs,
                      int Bz, int By, int Bx, int R, float v) {
  const int plane = By * Bx, n = Bz * plane;
  const int first = blockIdx.x * CLR_THREADS + threadIdx.x;
  const int step = gridDim.x * CLR_THREADS;
  for (int i = first; i < n; i += step) a[i] = clr_x(occ, i, i % Bx, Bx, R);
  cooperative_groups::this_grid().sync();
  for (int i = first; i < n; i += step)
    b[i] = (unsigned char)clr_fold(a, i, (i / Bx) % By, By, Bx);
  cooperative_groups::this_grid().sync();
  for (int i = first; i < n; i += step)
    clr_store(bsafe, bs, i, clr_fold(b, i, i / plane, Bz, plane), v);
}

// the blocks: a thread a brick, at most as many blocks as the card holds
// at once (a cooperative launch); 0 on an error
int clearance_blocks(int n) {
  int dev = 0, sms = 0, resident = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, clearance_grid_kernel, CLR_THREADS, 0) !=
          cudaSuccess)
    return 0;
  const long long want = (n + CLR_THREADS - 1) / CLR_THREADS;
  return (int)max(1ll, min(want, (long long)sms * max(resident, 1)));
}


// ---- oct_table -------------------------------------------------------------

constexpr int OCT_THREADS = 256;
constexpr int OCT_STAGE_BYTES = 48 * 1024;  // the largest staged brick

__device__ __forceinline__ void store8(__nv_bfloat16* out,
                                       const float (&c)[8]) {
  uint4 w;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(c[0], c[1]);
  w.x = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(c[2], c[3]);
  w.y = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(c[4], c[5]);
  w.z = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(c[6], c[7]);
  w.w = *reinterpret_cast<uint32_t*>(&h);
  *reinterpret_cast<uint4*>(out) = w;
}

__device__ __forceinline__ void store8(float* out, const float (&c)[8]) {
  reinterpret_cast<float4*>(out)[0] = make_float4(c[0], c[1], c[2], c[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(c[4], c[5], c[6], c[7]);
}

// rows[slot * v^3 + (lz * v + ly) * v + lx][dz * 4 + dy * 2 + dx] =
// vol[min(z0 + lz + dz, Z - 1), min(y0 + ly + dy, Y - 1), min(x0 + lx +
// dx, X - 1)] for the brick min(ids[slot], B - 1) at (z0, y0, x0). STAGED:
// the (v+1)^3 extended brick in dynamic shared memory first.
template <typename OutT, bool STAGED>
__global__ void __launch_bounds__(OCT_THREADS)
oct_table_kernel(const float* __restrict__ vol,
                 const long long* __restrict__ ids, OutT* __restrict__ rows,
                 int Z, int Y, int X, int v, int By, int Bx, int B) {
  extern __shared__ float ext[];
  const int slot = blockIdx.x;
  const long long id = ids[slot];
  const int bid = id < (long long)B - 1 ? (int)id : B - 1;
  const int bx = bid % Bx, q = bid / Bx;
  const int by = q % By, bz = q / By;
  const int z0 = bz * v, y0 = by * v, x0 = bx * v;
  const int w = v + 1;
  if (STAGED) {
    const int m = w * w * w;
    for (int e = threadIdx.x; e < m; e += OCT_THREADS) {
      const int dx = e % w, r = e / w;
      const int dy = r % w, dz = r / w;
      const int z = min(z0 + dz, Z - 1), y = min(y0 + dy, Y - 1);
      const int x = min(x0 + dx, X - 1);
      ext[e] = vol[((size_t)z * Y + y) * X + x];
    }
    __syncthreads();
  }
  const int V = v * v * v;
  OutT* out = rows + (size_t)slot * V * 8;
  for (int r = threadIdx.x; r < V; r += OCT_THREADS) {
    const int lx = r % v, t = r / v;
    const int ly = t % v, lz = t / v;
    float c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
      if (STAGED) {
        c[k] = ext[((lz + dz) * w + ly + dy) * w + lx + dx];
      } else {
        const int z = min(z0 + lz + dz, Z - 1);
        const int y = min(y0 + ly + dy, Y - 1);
        const int x = min(x0 + lx + dx, X - 1);
        c[k] = vol[((size_t)z * Y + y) * X + x];
      }
    }
    store8(out + (size_t)r * 8, c);
  }
}

template <typename OutT>
int launch_oct(const float* vol, const long long* ids, OutT* rows,
               int capacity, int Z, int Y, int X, int v, cudaStream_t s) {
  const int By = Y / v, Bx = X / v, B = (Z / v) * By * Bx;
  const size_t stage = (size_t)(v + 1) * (v + 1) * (v + 1) * sizeof(float);
  if (stage <= OCT_STAGE_BYTES)
    oct_table_kernel<OutT, true><<<capacity, OCT_THREADS, stage, s>>>(
        vol, ids, rows, Z, Y, X, v, By, Bx, B);
  else
    oct_table_kernel<OutT, false><<<capacity, OCT_THREADS, 0, s>>>(
        vol, ids, rows, Z, Y, X, v, By, Bx, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (Z, Y, X) f32 volume -> (Bz, By, Bx) bool surface-brick mask. bits is
// ceil(Z / 32) * Y * X uint32 of scratch; the volume's sides must be below
// 2^16.
int rgbd_surface_occ(const void* vol, void* bits, void* out, int Z, int Y,
                     int X, int brick_vox, int Bz, int By, int Bx,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_pack((const float*)vol, (uint32_t*)bits, Z, Y, X, s);
  if (err) return err;
  const int ZW = (Z + 31) / 32;
  brick_occ_kernel<<<dim3(Bx, By), 32 * OCC_WARPS, ZW * sizeof(uint32_t),
                     s>>>((const uint32_t*)bits, (unsigned char*)out, Z, Y,
                          X, ZW, brick_vox, Bz, By, Bx);
  return (int)cudaGetLastError();
}

// (Z, Y, X) f32 volume + (Bz, By, Bx) f32 brick clearance * brick_vox ->
// (Z, Y, X) march table, bf16 (out_f32 = 0) or f32 (out_f32 = 1). bits is
// (1 + P + S) * ceil(Z / 32) * Y * X uint32 of scratch, P the number of
// binary digits of rounds, S = 1 when rounds > PASS_ROUNDS (the dilated
// words between launches), else 0. rounds must be in [0, MAX_ROUNDS]; the
// volume's sides must be below 2^16.
int rgbd_sentinel_bake(const void* vol, const void* bs_scaled, void* out,
                       void* bits, int Z, int Y, int X, int brick_vox,
                       int rounds, int By, int Bx, int out_f32,
                       void* stream) {
  if (rounds < 0 || rounds > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    return launch_bake<float>((const float*)vol, (const float*)bs_scaled,
                              (float*)out, (uint32_t*)bits, Z, Y, X,
                              brick_vox, rounds, By, Bx, s);
  return launch_bake<__nv_bfloat16>(
      (const float*)vol, (const float*)bs_scaled, (__nv_bfloat16*)out,
      (uint32_t*)bits, Z, Y, X, brick_vox, rounds, By, Bx, s);
}

// (Bz, By, Bx) bool surface-brick mask -> bsafe = min(max(D - 1, 0),
// rounds) and bs = bsafe * brick_vox, both f32, D the Chebyshev distance in
// bricks to the nearest set brick (rounds where none is set). One
// cooperative launch; scratch holds 2 Bz By Bx bytes. rounds in [0, 254].
int rgbd_brick_clearance(const void* occ, void* bsafe, void* bs,
                         void* scratch, int Bz, int By, int Bx, int rounds,
                         int brick_vox, void* stream) {
  const int n = Bz * By * Bx;
  if (rounds < 0 || rounds > CLR_MAX_ROUNDS || n <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float v = (float)brick_vox;
  const int blocks = clearance_blocks(n);
  if (blocks == 0) return (int)cudaGetLastError();
  unsigned char* a = (unsigned char*)scratch;
  unsigned char* b = a + n;
  const unsigned char* occ_b = (const unsigned char*)occ;
  float* bsafe_f = (float*)bsafe;
  float* bs_f = (float*)bs;
  int R = rounds;
  void* args[] = {&occ_b, &a, &b, &bsafe_f, &bs_f, &Bz, &By, &Bx, &R,
                  (void*)&v};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)clearance_grid_kernel, dim3(blocks),
      dim3(CLR_THREADS), args, 0, s);
  // a refused launch's error is cleared, so the next launch reports its own
  if (err != cudaSuccess) cudaGetLastError();
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// (Z, Y, X) f32 volume (sides multiples of brick_vox) + (capacity,) int64
// ascending brick ids padded with B -> (capacity * brick_vox^3, 8) corner
// rows, bf16 (out_f32 = 0) or f32 (out_f32 = 1). capacity >= 1.
int rgbd_oct_table(const void* vol, const void* ids, void* rows,
                   int capacity, int Z, int Y, int X, int brick_vox,
                   int out_f32, void* stream) {
  if (capacity < 1 || brick_vox < 1 || Z % brick_vox || Y % brick_vox ||
      X % brick_vox || Z < brick_vox || Y < brick_vox || X < brick_vox)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    return launch_oct<float>((const float*)vol, (const long long*)ids,
                             (float*)rows, capacity, Z, Y, X, brick_vox, s);
  return launch_oct<__nv_bfloat16>((const float*)vol, (const long long*)ids,
                                   (__nv_bfloat16*)rows, capacity, Z, Y, X,
                                   brick_vox, s);
}

}  // extern "C"
