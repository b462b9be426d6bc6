// The preprocess chain's per-pixel passes, one launch a pass: morph
// dilate, LAB colour, the bilateral finish and bbox cull (depth2),
// boundary refinement, normals and the quality weight.
//
// Replaces no Pallas kernel: in the JAX package these passes are jnp code
// that XLA fuses into one program for the whole chain
// (rgbd_recon_tpu/ops/preprocess.py preprocess_frames, :506-590:
// morph_dilate :85, lab_colors :453 with ops/color.py rgb_to_lab,
// bilateral_lab :124, boundary :244, normals :300, quality :364). In the
// port their plain PyTorch twins (ops/preprocess.py *_plain) dispatch ~1,240
// small launches a fuse; each kernel here is one.
//
// Every kernel but the boundary's runs one thread a pixel over (N, H, W),
// 32 x 8 threads a block (a warp on one row: neighbouring threads read
// neighbouring pixels, and a stencil's taps share their sectors through
// L1), grid.z the sensor; the boundary's stages a tile in shared memory
// and runs 4 pixels a thread (its section below). The twins' edge-replicated pads become clamped indices: no
// padded copy. Every map is read in place in the layout the chain keeps
// (depth2 (N, H, W, 2) interleaved, lab and normals (N, H, W, 3), the pixel
// models (N, H, W, 3 / 2)), so no pass copies or stacks.
//
// Numerics: each kernel does the twin's operations in the twin's order.
// The library is built with --fmad=false and without fast math, so every
// product and sum rounds on its own, divisions and square roots are IEEE;
// and where PyTorch's CUDA kernels compute otherwise than the formula
// reads, the kernel does as they do:
//  - x / s for a Python number s is x * f32(1 / s), the reciprocal taken
//    in double and rounded once to f32 (1.0f / f32(s) differs from it for
//    1.055, 95.047 and 108.883): INV(s);
//  - s / x is reciprocal(x) * s (the normal's 1 / |n|);
//  - a Python number meets an f32 tensor as (float)s: F(s);
//  - clamp_min keeps a NaN (clamp_lo);
//  - a sum over a last axis of 3 adds lanes 0 and 2, then lane 1 (sum3);
//  - x.to(bfloat16) rounds to nearest even (__float2bfloat16_rn);
//  - torch.pow(x, p) for a Python p other than 0.5, -0.5, -1, 2, 3, -2
//    is powf(x, (float)p) (the CUDA math library's).
// So each kernel aims to equal its twin bit for bit; tests/
// test_torch_kernels.py and chip_smoke.py hold it there.
//
// Bound on this card: bytes. A pass reads one to three (N, H, W, C) f32
// maps and writes one or two: at the reference's 4 x 424 x 512 a plane is
// 3.5 MB, a pass 10-40 MB, 3-12 us at 3.35 TB/s; the lab pass also reads
// its colour taps, a few sectors of the 1280 x 1080 colour frame a pixel.
// The arithmetic is tens of f32 operations a pixel (the boundary's 25
// taps: ~375, only at its unreliable pixels; the LAB: two pow calls a
// channel), under the bytes' time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// a Python number as PyTorch hands it to an f32 kernel
#define F(s) static_cast<float>(s)

constexpr float MIN_DEPTH = 0.5f;  // Kinect v2 range (pre_morph.fs:32-33)
constexpr float MAX_DEPTH = 4.5f;
// x / s for a Python number s: x * INV(s)
#define INV(s) static_cast<float>(1.0 / (s))
constexpr float INV_SAMPLES = INV(169.0);  // 13x13 window
constexpr float INV_255 = INV(255.0);
constexpr float INV_1055 = INV(1.055);
constexpr float INV_1292 = INV(12.92);
constexpr float INV_116 = INV(116.0);
constexpr float INV_WHITE_X = INV(95.047);
constexpr float INV_WHITE_Y = INV(100.0);
constexpr float INV_WHITE_Z = INV(108.883);

__device__ __forceinline__ int clamp_idx(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

// torch.clamp_min: a NaN stays NaN
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the pixel of this thread: false past the map's edge
__device__ __forceinline__ bool pixel(int H, int W, int& n, int& y, int& x) {
  x = blockIdx.x * BLOCK_X + threadIdx.x;
  y = blockIdx.y * BLOCK_Y + threadIdx.y;
  n = blockIdx.z;
  return x < W && y < H;
}

// ---- morph: pre_morph.fs:73-112 -------------------------------------------
// twin ops/preprocess.py morph_dilate_plain: an invalid pixel takes the
// two-pass outlier-rejecting mean of its valid 3x3 neighbours (dy outer,
// dx inner, sums from +0)
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    morph_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int H, int W) {
  int n, y, x;
  if (!pixel(H, W, n, y, x)) return;
  const float* d = depth + (long long)n * H * W;
  float s[9];
  float sum1 = 0.0f, cnt1 = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int t = (dy + 1) * 3 + dx + 1;
      s[t] = __ldg(d + clamp_idx(y + dy, H) * W + clamp_idx(x + dx, W));
      const bool v = s[t] > MIN_DEPTH && s[t] < MAX_DEPTH;
      sum1 = sum1 + (v ? s[t] : 0.0f);
      cnt1 = cnt1 + (v ? 1.0f : 0.0f);
    }
  }
  const float avg = sum1 / fmaxf(cnt1, 1.0f);
  float sum2 = 0.0f, cnt2 = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const bool v = s[t] > MIN_DEPTH && s[t] < MAX_DEPTH &&
                   fabsf(avg - s[t]) < F(0.2);
    sum2 = sum2 + (v ? s[t] : 0.0f);
    cnt2 = cnt2 + (v ? 1.0f : 0.0f);
  }
  float filled = cnt2 > 0.0f ? sum2 / fmaxf(cnt2, 1.0f) : 0.0f;
  filled = cnt1 > 0.0f ? filled : 0.0f;
  const float c = s[4];
  out[(long long)n * H * W + y * W + x] =
      (c > MIN_DEPTH && c < MAX_DEPTH) ? c : filled;
}

// ---- lab: pre_depth.fs:129-137, glsl/inc_color.glsl --------------------------
// twin ops/preprocess.py lab_colors_plain with ops/color.py rgb_to_lab and
// ops/sampling.py pair_bilinear

__device__ __forceinline__ float pivot_rgb(float n) {
  const float lin = powf(clamp_lo((n + F(0.055)) * INV_1055, F(1e-12)),
                         F(2.4));
  return (n > F(0.04045) ? lin : n * INV_1292) * 100.0f;
}

__device__ __forceinline__ float pivot_xyz(float n) {
  const float cube = powf(clamp_lo(n, 0.0f), F(1.0 / 3.0));
  return n > F(0.008856) ? cube : (F(903.3) * n + 16.0f) * INV_116;
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    lab_kernel(const float* __restrict__ colors,
               const float* __restrict__ depth_norm,
               const float* __restrict__ uv_p, const float* __restrict__ uv_q,
               const float* __restrict__ uv_r, float* __restrict__ out,
               float z_far, int H, int W, int Hc, int Wc) {
  int n, y, x;
  if (!pixel(H, W, n, y, x)) return;
  const long long p = (long long)n * H * W + y * W + x;
  const float dn = __ldg(depth_norm + p);
  // degenerate depth samples at the far plane
  const float z = (dn <= 0.0f || dn >= 1.0f) ? z_far : dn;
  float uv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float pp = __ldg(uv_p + 2 * p + c);
    const float qq = __ldg(uv_q + 2 * p + c);
    const float rr = __ldg(uv_r + 2 * p + c);
    uv[c] = (pp + qq * z) / (1.0f + rr * z);
  }
  // pair_bilinear: x taps (x0, min(x0 + 1, W - 1)), no x weight left of
  // the first texel; y taps clamped
  const float cx = uv[0] * (float)Wc - 0.5f;
  const float cy = uv[1] * (float)Hc - 0.5f;
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = x0f < 0.0f ? 0.0f : cx - x0f;
  const float fy = cy - y0f;
  const int x0 = clamp_idx((int)x0f, Wc);
  const int x1 = min(x0 + 1, Wc - 1);
  const int y0 = clamp_idx((int)y0f, Hc);
  const int y1 = clamp_idx((int)(y0f + 1.0f), Hc);
  const float* col = colors + (long long)n * Hc * Wc * 3;
  const float* r0 = col + ((long long)y0 * Wc + x0) * 3;
  const float* r0n = col + ((long long)y0 * Wc + x1) * 3;
  const float* r1 = col + ((long long)y1 * Wc + x0) * 3;
  const float* r1n = col + ((long long)y1 * Wc + x1) * 3;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = bf16_round(__ldg(r0 + c)) * gx +
                     bf16_round(__ldg(r0n + c)) * fx;
    const float c1 = bf16_round(__ldg(r1 + c)) * gx +
                     bf16_round(__ldg(r1n + c)) * fx;
    // rgb_to_lab divides the [0, 1] texel by 255 again (inc_color.glsl)
    lin[c] = pivot_rgb((c0 * gy + c1 * fy) * INV_255);
  }
  const float r = lin[0], g = lin[1], b = lin[2];
  const float X = (r * F(0.4124) + g * F(0.3576)) + b * F(0.1805);
  const float Y = (r * F(0.2126) + g * F(0.7152)) + b * F(0.0722);
  const float Z = (r * F(0.0193) + g * F(0.1192)) + b * F(0.9505);
  const float px = pivot_xyz(X * INV_WHITE_X);
  const float py = pivot_xyz(Y * INV_WHITE_Y);
  const float pz = pivot_xyz(Z * INV_WHITE_Z);
  float* o = out + 3 * p;
  o[0] = clamp_lo(py * 116.0f - 16.0f, 0.0f);
  o[1] = (px - py) * 500.0f;
  o[2] = (py - pz) * 200.0f;
}

// ---- depth2: pre_depth.fs:78-146 ----------------------------------------------
// twin ops/preprocess.py bilateral_lab_plain on the pixel models: the
// normalized depth, the bbox cull through ray_a + ray_b * d, and the
// bilateral finish from bilateral13's window sums (null: filter off)
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    depth2_kernel(const float* __restrict__ depth_m,
                  const float* __restrict__ limits,
                  const float* __restrict__ bbox_min,
                  const float* __restrict__ bbox_max,
                  const float* __restrict__ ray_a,
                  const float* __restrict__ ray_b,
                  const float* __restrict__ bf_sum,
                  const float* __restrict__ w_sum,
                  const float* __restrict__ range_sum,
                  float* __restrict__ out, int H, int W) {
  int n, y, x;
  if (!pixel(H, W, n, y, x)) return;
  const long long p = (long long)n * H * W + y * W + x;
  const float near = __ldg(limits + 2 * n), far = __ldg(limits + 2 * n + 1);
  const float span = far - near;
  const float dn = (__ldg(depth_m + p) - near) / span;
  bool in_box = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float wj = __ldg(ray_a + 3 * p + j) + __ldg(ray_b + 3 * p + j) * dn;
    in_box = in_box && wj >= __ldg(bbox_min + j) && wj <= __ldg(bbox_max + j);
  }
  float o0 = dn, o1 = 1.0f;
  if (bf_sum != nullptr) {
    const float filtered =
        __ldg(bf_sum + p) / clamp_lo(__ldg(w_sum + p), F(1e-20));
    o0 = (filtered - near) / span;
    o1 = __ldg(range_sum + p) * INV_SAMPLES;
  }
  out[2 * p] = in_box ? o0 : 0.0f;
  out[2 * p + 1] = in_box ? o1 : 0.0f;
}

// ---- boundary: pre_boundary.fs:37-118 ----------------------------------------
// twin ops/preprocess.py boundary_plain: the mean LAB distance over the
// valid 5x5 neighbours (dy outer, dx inner; total_samples 16, as the
// reference has it), the flags, the silhouette.
//
// A block of 32 x 4 threads owns a tile of 32 x 16 pixels, 4 down a
// column a thread; it stages the tile and a 2-pixel halo (edge-clamped)
// in shared memory: depth2's pairs (float2 loads) and one validity byte a
// pixel (d > 0 and q > 0.65, tested once a staged pixel). Only the
// unreliable pixels' flags read the colour difference (with the refine
// on), so the tile lists those pixels; where it lists any, it stages the
// L, A and B planes (float4 runs over lab's interleaved rows) and gives
// each listed pixel to a thread, which sums its 25 taps from shared
// memory in the twin's order (dy outer, dx inner, from +0; an invalid tap,
// which the twin adds as +0, is skipped: every sum keeps its bits). A tile
// with no such pixel reads no colour. Output pairs are stored as float2,
// the silhouette a row a warp.
//
// Bound: bytes. depth2 read once and the two outputs written once, 20
// bytes a pixel, and the LAB only around the listed pixels; the 5x5 sums
// are ~375 f32 operations a listed pixel (2.6% of a fast fuse's pixels).
// A warp sums 32 listed pixels at once, wherever they lie in the tile.
constexpr int BT_W = 32;                 // tile width: a warp's columns
constexpr int BT_ROWS = 4;               // output pixels a thread
constexpr int BT_TY = 4;                 // threads down the tile
constexpr int BT_H = BT_TY * BT_ROWS;    // tile height
constexpr int BT_THREADS = BT_W * BT_TY;
constexpr int HALO = 2;
constexpr int SW = BT_W + 2 * HALO;      // staged columns
constexpr int SH = BT_H + 2 * HALO;      // staged rows
constexpr int SP = SW * SH;              // staged pixels
// float4 words a staged lab row can touch: 3 SW floats, misaligned by up to
// 3 floats at each end
constexpr int LAB_WORDS = (3 * SW + 6 + 3) / 4;

// Stage the L, A, B planes of the halo tile (block origin x0, y0) into
// s_lab, plane c at c * SP. VEC:
// lab is 16-byte aligned and each row is read as the float4 words that
// cover its staged pixels (a word past the map's end float by float), the
// columns past the map's sides copied from its edge columns after; else
// one float a thread.
template <bool VEC>
__device__ __forceinline__ void stage_lab(const float* __restrict__ lab,
                                          long long base, int x0, int y0,
                                          int H, int W, long long floats,
                                          float* s_lab) {
  const int tid = threadIdx.y * BT_W + threadIdx.x;
  if (!VEC) {
    for (int i = tid; i < 3 * SP; i += BT_THREADS) {
      const int p = i / 3, c = i - 3 * p;
      const int hy = p / SW, hx = p - hy * SW;
      const long long q = base + clamp_idx(y0 - HALO + hy, H) * W +
                          clamp_idx(x0 - HALO + hx, W);
      s_lab[c * SP + p] = __ldg(lab + 3 * q + c);
    }
    return;
  }
  const int xa = max(x0 - HALO, 0), xb = min(x0 + BT_W + HALO - 1, W - 1);
  for (int i = tid; i < SH * LAB_WORDS; i += BT_THREADS) {
    const int hy = i / LAB_WORDS, j = i - hy * LAB_WORDS;
    const long long row = base + (long long)clamp_idx(y0 - HALO + hy, H) * W;
    const long long fa = 3 * (row + xa), fb = 3 * (row + xb + 1);
    const long long w = fa / 4 + j;  // the float4 word
    if (4 * w >= fb) continue;
    float v[4];
    if (4 * w + 3 < floats) {
      const float4 f = __ldg((const float4*)lab + w);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = 4 * w + e < floats ? __ldg(lab + 4 * w + e) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long k = 4 * w + e;
      if (k < fa || k >= fb) continue;
      const int rel = (int)(k - fa), px = rel / 3, c = rel - 3 * px;
      s_lab[c * SP + hy * SW + (xa - (x0 - HALO)) + px] = v[e];
    }
  }
  if (x0 - HALO >= 0 && x0 + BT_W + HALO - 1 <= W - 1) return;
  // a tile at a side of the map: the clamped columns repeat the edge's
  __syncthreads();
  for (int p = tid; p < SP; p += BT_THREADS) {
    const int hy = p / SW, hx = p - hy * SW;
    const int gx = x0 - HALO + hx;
    if (gx >= 0 && gx <= W - 1) continue;
    const int src = hy * SW + clamp_idx(gx, W) - (x0 - HALO);
#pragma unroll
    for (int c = 0; c < 3; ++c) s_lab[c * SP + p] = s_lab[c * SP + src];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(BT_THREADS)
    boundary_kernel(const float* __restrict__ depth2,
                    const float* __restrict__ lab,
                    float* __restrict__ out, float* __restrict__ sil,
                    int refine, int H, int W) {
  __shared__ float2 s_dq[SP];
  __shared__ float s_lab[3 * SP];  // the L, A, B planes
  __shared__ unsigned char s_v[SP];
  // the tile's pixels whose flags read their colour difference, and the
  // outcome of its test for each
  __shared__ unsigned short s_list[BT_W * BT_H];
  __shared__ bool s_kept[BT_W * BT_H];
  __shared__ int s_listed;
  const int tid = threadIdx.y * BT_W + threadIdx.x;
  const int x0 = blockIdx.x * BT_W, y0 = blockIdx.y * BT_H;
  const long long base = (long long)blockIdx.z * H * W;
  if (tid == 0) s_listed = 0;

  // depth2 of the halo tile, its validity once a pixel
  for (int p = tid; p < SP; p += BT_THREADS) {
    const int hy = p / SW, hx = p - hy * SW;
    const long long q = base + clamp_idx(y0 - HALO + hy, H) * W +
                        clamp_idx(x0 - HALO + hx, W);
    const float2 dq =
        VEC ? __ldg((const float2*)depth2 + q)
            : make_float2(__ldg(depth2 + 2 * q), __ldg(depth2 + 2 * q + 1));
    s_dq[p] = dq;
    s_v[p] = dq.x > 0.0f && dq.y > F(0.65);
  }
  __syncthreads();

  // this thread's pixels: column x, rows y0 + r0 ... y0 + r0 + 3; the
  // unreliable ones (refine on) go on the tile's list
  const int lx = threadIdx.x, r0 = threadIdx.y * BT_ROWS;
  const int x = x0 + lx;
  bool need[BT_ROWS];
#pragma unroll
  for (int r = 0; r < BT_ROWS; ++r) {
    const float2 c = s_dq[(r0 + r + HALO) * SW + lx + HALO];
    const bool unreliable = !(c.x <= 0.0f) && c.y <= F(0.65);
    need[r] = x < W && y0 + r0 + r < H && unreliable && refine != 0;
    if (need[r])
      s_list[atomicAdd(&s_listed, 1)] =
          (unsigned short)((r0 + r) * BT_W + lx);
  }
  __syncthreads();
  const int listed = s_listed;
  if (listed > 0) {
    stage_lab<VEC>(lab, base, x0, y0, H, W, 3 * (long long)gridDim.z * H * W,
                   s_lab);
    __syncthreads();
    // one listed pixel a thread: its 25 taps from shared memory, the
    // twin's order (dy outer, dx inner, from +0), invalid taps skipped
    for (int k = tid; k < listed; k += BT_THREADS) {
      const int local = s_list[k];
      const int ly = local / BT_W, lxk = local - ly * BT_W;
      const int c = (ly + HALO) * SW + lxk + HALO;
      const float L0 = s_lab[c], A0 = s_lab[SP + c], B0 = s_lab[2 * SP + c];
      float total = 0.0f, cnt = 0.0f;
#pragma unroll
      for (int dy = 0; dy <= 2 * HALO; ++dy) {
#pragma unroll
        for (int dx = 0; dx <= 2 * HALO; ++dx) {
          const int i = (ly + dy) * SW + lxk + dx;
          if (!s_v[i]) continue;
          const float dl = L0 - s_lab[i];
          const float da = A0 - s_lab[SP + i];
          const float db = B0 - s_lab[2 * SP + i];
          total = total + sqrtf((dl * dl + da * da) + db * db);
          cnt = cnt + 1.0f;
        }
      }
      const float color_diff = cnt < 8.0f ? 1.0f : total / fmaxf(cnt, 1.0f);
      s_kept[local] = color_diff <= 0.5f;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < BT_ROWS; ++r) {
    const int y = y0 + r0 + r;
    if (x >= W || y >= H) continue;
    const float2 c = s_dq[(r0 + r + HALO) * SW + lx + HALO];
    const float d0 = c.x, q0 = c.y;
    const bool outside = d0 <= 0.0f;
    const bool unreliable = !outside && q0 <= F(0.65);
    const bool kept = need[r] && s_kept[(r0 + r) * BT_W + lx];
    const bool invalidated = unreliable && !kept;
    const long long p = base + (long long)y * W + x;
    ((float2*)out)[p] = make_float2(
        invalidated ? -1.0f : d0,
        outside ? 0.0f : (invalidated ? F(0.1) : (kept ? 1.0f : 0.0f)));
    sil[p] = (outside || unreliable) ? 0.0f : 1.0f;
  }
}

// ---- normals: pre_normal.fs:26-56 ----------------------------------------------
// twin ops/preprocess.py normals_plain on the pixel models: the world
// position a + b * d at the four neighbours (an invalid neighbour takes the
// centre's depth), central differences, cross product, 1 / max(|n|, 1e-20)
__device__ __forceinline__ void world_at(
    const float* __restrict__ depth2, const float* __restrict__ ray_a,
    const float* __restrict__ ray_b, long long base, int y, int x, int H,
    int W, float d, float w[3]) {
  const long long q = base + clamp_idx(y, H) * W + clamp_idx(x, W);
  float ds = __ldg(depth2 + 2 * q);
  ds = (ds <= 0.0f || ds >= 1.0f) ? d : ds;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    w[j] = __ldg(ray_a + 3 * q + j) + __ldg(ray_b + 3 * q + j) * ds;
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    normals_kernel(const float* __restrict__ depth2,
                   const float* __restrict__ ray_a,
                   const float* __restrict__ ray_b,
                   float* __restrict__ out, int H, int W) {
  int n, y, x;
  if (!pixel(H, W, n, y, x)) return;
  const long long base = (long long)n * H * W;
  const long long p = base + y * W + x;
  const float d = __ldg(depth2 + 2 * p);
  float wt[3], wb[3], wl[3], wr[3];
  world_at(depth2, ray_a, ray_b, base, y + 1, x, H, W, d, wt);
  world_at(depth2, ray_a, ray_b, base, y - 1, x, H, W, d, wb);
  world_at(depth2, ray_a, ray_b, base, y, x - 1, H, W, d, wl);
  world_at(depth2, ray_a, ray_b, base, y, x + 1, H, W, d, wr);
  float e1[3], e2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    e1[j] = wb[j] - wt[j];
    e2[j] = wl[j] - wr[j];
  }
  const float nx = e1[1] * e2[2] - e1[2] * e2[1];
  const float ny = e1[2] * e2[0] - e1[0] * e2[2];
  const float nz = e1[0] * e2[1] - e1[1] * e2[0];
  // 1.0 / t is reciprocal(t) * 1.0 in PyTorch: the same value
  const float inv =
      1.0f / clamp_lo(sqrtf((nx * nx + ny * ny) + nz * nz), F(1e-20));
  const bool valid = d > 0.0f && d < 1.0f;
  float* o = out + 3 * p;
  o[0] = valid ? nx * inv : 0.0f;
  o[1] = valid ? ny * inv : 0.0f;
  o[2] = valid ? nz * inv : 0.0f;
}

// ---- quality: pre_quality.fs:65-119 --------------------------------------------
// twin ops/preprocess.py quality_plain on the pixel models: (1 -
// border/169)^6 (mean range weight)^6 / max(d * 6.5, 1e-20), times the
// squared cosine of the view angle
__device__ __forceinline__ float pow6(float x) {
  // the multiply order of XLA's integer_pow(x, 6)
  const float x2 = x * x;
  return x2 * (x2 * x2);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    quality_kernel(const float* __restrict__ depth2,
                   const float* __restrict__ normal,
                   const float* __restrict__ cam,
                   const float* __restrict__ border_sum,
                   const float* __restrict__ range_sum,
                   const float* __restrict__ ray_a,
                   const float* __restrict__ ray_b,
                   float* __restrict__ out, int H, int W) {
  int n, y, x;
  if (!pixel(H, W, n, y, x)) return;
  const long long p = (long long)n * H * W + y * W + x;
  const float d = __ldg(depth2 + 2 * p);
  const float lateral = 1.0f - __ldg(border_sum + p) * INV_SAMPLES;
  float q = pow6(lateral) * pow6(__ldg(range_sum + p) * INV_SAMPLES);
  q = q / clamp_lo(d * 6.5f, F(1e-20));
  float tc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float world =
        __ldg(ray_a + 3 * p + j) + __ldg(ray_b + 3 * p + j) * d;
    tc[j] = __ldg(cam + 3 * n + j) - world;
  }
  const float norm =
      clamp_lo(sqrtf(sum3(tc[0] * tc[0], tc[1] * tc[1], tc[2] * tc[2])),
               F(1e-20));
#pragma unroll
  for (int j = 0; j < 3; ++j) tc[j] = tc[j] / norm;
  const float angle = sum3(tc[0] * __ldg(normal + 3 * p),
                           tc[1] * __ldg(normal + 3 * p + 1),
                           tc[2] * __ldg(normal + 3 * p + 2));
  q = q * (angle * angle);
  out[p] = (d > 0.0f && d < 1.0f) ? q : 0.0f;
}

dim3 grid_of(int N, int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y, N);
}

const dim3 kBlock(BLOCK_X, BLOCK_Y);

}  // namespace

extern "C" {

// (N, H, W) metric depth -> (N, H, W) morphed depth.
int rgbd_pre_morph(const void* depth, void* out, int N, int H, int W,
                   void* stream) {
  morph_kernel<<<grid_of(N, H, W), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)depth, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// (N, Hc, Wc, 3) colour + (N, H, W) normalized depth + the pixel models'
// uv_p, uv_q, uv_r (N, H, W, 2) -> (N, H, W, 3) LAB.
int rgbd_pre_lab(const void* colors, const void* depth_norm,
                 const void* uv_p, const void* uv_q, const void* uv_r,
                 void* out, float z_far, int N, int H, int W, int Hc, int Wc,
                 void* stream) {
  lab_kernel<<<grid_of(N, H, W), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)colors, (const float*)depth_norm, (const float*)uv_p,
      (const float*)uv_q, (const float*)uv_r, (float*)out, z_far, H, W, Hc,
      Wc);
  return (int)cudaGetLastError();
}

// (N, H, W) metric depth, (N, 2) limits, (3,) box, ray_a / ray_b
// (N, H, W, 3), bilateral13's three sums or nulls -> (N, H, W, 2) depth2.
int rgbd_pre_depth2(const void* depth_m, const void* limits,
                    const void* bbox_min, const void* bbox_max,
                    const void* ray_a, const void* ray_b, const void* bf_sum,
                    const void* w_sum, const void* range_sum, void* out,
                    int N, int H, int W, void* stream) {
  depth2_kernel<<<grid_of(N, H, W), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)depth_m, (const float*)limits, (const float*)bbox_min,
      (const float*)bbox_max, (const float*)ray_a, (const float*)ray_b,
      (const float*)bf_sum, (const float*)w_sum, (const float*)range_sum,
      (float*)out, H, W);
  return (int)cudaGetLastError();
}

// (N, H, W, 2) depth2 + (N, H, W, 3) LAB -> (N, H, W, 2) depth2 and the
// (N, H, W) silhouette.
int rgbd_pre_boundary(const void* depth2, const void* lab, void* out,
                      void* sil, int refine, int N, int H, int W,
                      void* stream) {
  const dim3 grid((W + BT_W - 1) / BT_W, (H + BT_H - 1) / BT_H, N);
  const dim3 block(BT_W, BT_TY);
  // float2 / float4 loads where the inputs allow them (out is the
  // wrapper's own allocation)
  const bool vec = (uintptr_t)depth2 % 8 == 0 && (uintptr_t)lab % 16 == 0;
  if (vec)
    boundary_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)depth2, (const float*)lab, (float*)out, (float*)sil,
        refine, H, W);
  else
    boundary_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)depth2, (const float*)lab, (float*)out, (float*)sil,
        refine, H, W);
  return (int)cudaGetLastError();
}

// (N, H, W, 2) depth2 + ray_a / ray_b (N, H, W, 3) -> (N, H, W, 3) normals.
int rgbd_pre_normals(const void* depth2, const void* ray_a, const void* ray_b,
                     void* out, int N, int H, int W, void* stream) {
  normals_kernel<<<grid_of(N, H, W), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)depth2, (const float*)ray_a, (const float*)ray_b,
      (float*)out, H, W);
  return (int)cudaGetLastError();
}

// (N, H, W, 2) depth2, (N, H, W, 3) normals, (N, 3) camera positions,
// quality13's two sums, ray_a / ray_b -> (N, H, W) quality.
int rgbd_pre_quality(const void* depth2, const void* normal, const void* cam,
                     const void* border_sum, const void* range_sum,
                     const void* ray_a, const void* ray_b, void* out, int N,
                     int H, int W, void* stream) {
  quality_kernel<<<grid_of(N, H, W), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)depth2, (const float*)normal, (const float*)cam,
      (const float*)border_sum, (const float*)range_sum,
      (const float*)ray_a, (const float*)ray_b, (float*)out, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
