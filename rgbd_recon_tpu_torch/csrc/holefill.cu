// Pull-push hole fill over a mip pyramid: one launch a pull level, one
// thread an output texel; one push launch, one thread a LOD 0 pixel.
//
// Replaces the pull-push of the render: in the JAX package
// rgbd_recon_tpu/ops/holefill.py fill_colors_planar (:312; _pull_planar
// :56 and _push_planar :223, XLA ops and resample matmuls, no Pallas
// kernel), in the port its plain PyTorch twin (ops/holefill.py
// fill_colors_plain: ~1,950 launches and 24 pageable copies of the
// resample matrices at 1280x720 with 7 LODs).
//
// pull, LOD l -> l + 1, exactly what ops/holefill.py _pull_planar computes
// (IEEE f32, no FMA contraction: the library is compiled with
// --fmad=false and without fast math, and every sum is written in the
// twin's order):
//   the 4x4 window at rows 2j - 1 .. 2j + 2 and columns 2i - 1 .. 2i + 2,
//   clamped to the level (the twin's replicate pad (1, 2 + 2*W2 - W) never
//   reaches past the clamped edge); taps in the twin's order, dx outer and
//   dy inner, each sum from +0.0:
//     valid = alpha > 0; sum_d += valid ? d : 0; cnt += valid ? 1 : 0
//     depth_av = sum_d / max(cnt, 1)
//     keep = valid && d >= depth_av; tot_rgb, total_d += keep ? x : 0;
//     total_w += keep ? 1 : 0
//   w = max(total_w, 1); has = cnt > 0; hole = centre depth < 1
//   r, b = has ? tot / w : 0;  g = has ? tot / w : (hole ? 0 : 1)
//   alpha = has ? 1 : (hole ? -1 : 0);  depth = has ? total_d / w : centre
//
// push, ops/holefill.py _push_planar (tsdf_colorfill.fs:30-55): each LOD 0
// pixel takes the first level whose nearest texel (row y * Hl / H, column
// x * Wl / W) has alpha > 0, the last level if none has. Level 0 keeps its
// own r, g, b, alpha. Any other level blends the GL-bilinear samples of
// levels l1 = min(level + 1, L - 1) and l2 = min(level + 2, L - 1) with
// the reference's weights w1 = sqrt(u^2 + v^2), w2 = 1 - w1 and the denom
// guard. Depth passes through (the wrapper returns the input). The
// resampling is per axis: the twin's (my @ P) @ mx^T has at most two
// nonzeros a row of my and of mx, so each output row and column reads
// two taps from a table built from the twin's own matrices (their f32
// entries, merged edge taps included), vertical taps first.
//
// Bound on this card: bytes. The pull reads the 5 planes of a level once
// (18.4 MB at 1280x720 LOD 0) and writes a quarter of that; the push
// reads 4 planes at LOD 0, one alpha texel a level until the first valid
// one, and 4 taps of 4 planes at two coarser levels (L2-resident at these
// sizes), and writes 4 planes. Design: one thread an output, 32x8-thread
// blocks (a warp on one row: neighbouring threads read neighbouring
// texels, the 4x4 windows of a warp share their sectors through L1), the
// planes read through their strides (the render's (H, W, 4) image is
// passed as four column views, no copy), the per-axis tables in device
// memory, uploaded once per pyramid shape by the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
// levels of a pyramid (an int side of 2^31 halves 31 times)
constexpr int MAX_LODS = 32;
constexpr int PULL_PLANES = 5;  // r, g, b, alpha, depth
constexpr int PLANES = 4;       // r, g, b, alpha

struct Plane {
  const float* p;
  long long rs;  // row stride (elements)
  long long cs;  // column stride (elements)
};

struct PullArgs {
  Plane in[PULL_PLANES];
  float* out;  // (5, H2, W2), contiguous
  int H, W, H2, W2;
};

struct PushArgs {
  Plane in[PLANES];              // LOD 0 r, g, b, alpha
  const float* lvl[MAX_LODS];    // level l >= 1: (C >= 4, Hl, Wl)
  int hl[MAX_LODS], wl[MAX_LODS];
  int L;
  // per-axis taps: level l's rows at [l * 3 * H]: nearest, bilinear tap 0,
  // tap 1 (yi); weights at [l * 2 * H]: tap 0, tap 1 (yw); columns alike
  const int* yi;
  const int* xi;
  const float* yw;
  const float* xw;
  float* out;  // (4, H, W), contiguous
  int* level;  // (H, W) or null
  int H, W;
};

__device__ __forceinline__ float load(const Plane& pl, int r, int c) {
  return __ldg(pl.p + (long long)r * pl.rs + (long long)c * pl.cs);
}

__device__ __forceinline__ int clamp_idx(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    pull_kernel(PullArgs a) {
  const int i = blockIdx.x * BLOCK_X + threadIdx.x;
  const int j = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (i >= a.W2 || j >= a.H2) return;
  int ry[4], cx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ry[k] = clamp_idx(2 * j + k - 1, a.H);
    cx[k] = clamp_idx(2 * i + k - 1, a.W);
  }
  float d[16];
  bool valid[16];
  float sum_d = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const int t = dx * 4 + dy;
      valid[t] = load(a.in[3], ry[dy], cx[dx]) > 0.0f;
      d[t] = load(a.in[4], ry[dy], cx[dx]);
      sum_d = __fadd_rn(sum_d, valid[t] ? d[t] : 0.0f);
      cnt = __fadd_rn(cnt, valid[t] ? 1.0f : 0.0f);
    }
  }
  const float depth_av = __fdiv_rn(sum_d, fmaxf(cnt, 1.0f));
  float tr = 0.0f, tg = 0.0f, tb = 0.0f, total_d = 0.0f, total_w = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const int t = dx * 4 + dy;
      const bool keep = valid[t] && d[t] >= depth_av;
      // a colour tap that is not kept adds +0.0, which leaves the sum
      // (never -0.0: it starts at +0.0) as it is; its load is skipped
      float r = 0.0f, g = 0.0f, b = 0.0f;
      if (keep) {
        r = load(a.in[0], ry[dy], cx[dx]);
        g = load(a.in[1], ry[dy], cx[dx]);
        b = load(a.in[2], ry[dy], cx[dx]);
      }
      tr = __fadd_rn(tr, r);
      tg = __fadd_rn(tg, g);
      tb = __fadd_rn(tb, b);
      total_d = __fadd_rn(total_d, keep ? d[t] : 0.0f);
      total_w = __fadd_rn(total_w, keep ? 1.0f : 0.0f);
    }
  }
  const float w = fmaxf(total_w, 1.0f);
  // the centre tap (dy = 0, dx = 0): rows 2j, columns 2i, in range
  const float centre = d[1 * 4 + 1];
  const bool hole = centre < 1.0f;
  const bool has = cnt > 0.0f;
  const long long n = (long long)a.H2 * a.W2;
  const long long o = (long long)j * a.W2 + i;
  a.out[o] = has ? __fdiv_rn(tr, w) : 0.0f;
  a.out[n + o] = has ? __fdiv_rn(tg, w) : (hole ? 0.0f : 1.0f);
  a.out[2 * n + o] = has ? __fdiv_rn(tb, w) : 0.0f;
  a.out[3 * n + o] = has ? 1.0f : (hole ? -1.0f : 0.0f);
  a.out[4 * n + o] = has ? __fdiv_rn(total_d, w) : centre;
}

// GL-bilinear sample of level l's planes at LOD 0 pixel (y, x): vertical
// taps, then horizontal, as (my @ P) @ mx^T
__device__ __forceinline__ void bilinear(const PushArgs& a, int l, int y,
                                         int x, float out[PLANES]) {
  const int H = a.H, W = a.W;
  const int iy0 = __ldg(a.yi + (l * 3 + 1) * H + y);
  const int iy1 = __ldg(a.yi + (l * 3 + 2) * H + y);
  const float wy0 = __ldg(a.yw + (l * 2) * H + y);
  const float wy1 = __ldg(a.yw + (l * 2 + 1) * H + y);
  const int ix0 = __ldg(a.xi + (l * 3 + 1) * W + x);
  const int ix1 = __ldg(a.xi + (l * 3 + 2) * W + x);
  const float wx0 = __ldg(a.xw + (l * 2) * W + x);
  const float wx1 = __ldg(a.xw + (l * 2 + 1) * W + x);
  const int wl = a.wl[l];
  const long long plane = (long long)a.hl[l] * wl;
  const float* r0 = a.lvl[l] + (long long)iy0 * wl;
  const float* r1 = a.lvl[l] + (long long)iy1 * wl;
#pragma unroll
  for (int c = 0; c < PLANES; ++c) {
    const long long off = c * plane;
    const float t0 = __fadd_rn(__fmul_rn(wy0, __ldg(r0 + off + ix0)),
                               __fmul_rn(wy1, __ldg(r1 + off + ix0)));
    const float t1 = __fadd_rn(__fmul_rn(wy0, __ldg(r0 + off + ix1)),
                               __fmul_rn(wy1, __ldg(r1 + off + ix1)));
    out[c] = __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1));
  }
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
    push_kernel(PushArgs a) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const int L = a.L;
  int level = L - 1;
  if (load(a.in[3], y, x) > 0.0f) {
    level = 0;
  } else {
    for (int l = 1; l < L; ++l) {
      const int ny = __ldg(a.yi + (l * 3) * a.H + y);
      const int nx = __ldg(a.xi + (l * 3) * a.W + x);
      const long long plane = (long long)a.hl[l] * a.wl[l];
      if (__ldg(a.lvl[l] + 3 * plane + (long long)ny * a.wl[l] + nx) >
          0.0f) {
        level = l;
        break;
      }
    }
  }
  const long long n = (long long)a.H * a.W;
  const long long o = (long long)y * a.W + x;
  if (a.level) a.level[o] = level;
  if (level == 0) {
#pragma unroll
    for (int c = 0; c < PLANES; ++c) a.out[c * n + o] = load(a.in[c], y, x);
    return;
  }
  float c1[PLANES], c2[PLANES];
  bilinear(a, min(level + 1, L - 1), y, x, c1);
  bilinear(a, min(level + 2, L - 1), y, x, c2);
  const float u = __fdiv_rn(__fadd_rn((float)x, 0.5f), (float)a.W);
  const float v = __fdiv_rn(__fadd_rn((float)y, 0.5f), (float)a.H);
  const float w1 = __fsqrt_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)));
  const float w2 = __fsub_rn(1.0f, w1);
  const float s = __fadd_rn(w1, w2);
  const float denom = fabsf(s) < 1e-20f ? 1e-20f : s;
#pragma unroll
  for (int c = 0; c < PLANES; ++c)
    a.out[c * n + o] = __fdiv_rn(
        __fadd_rn(__fmul_rn(c1[c], w1), __fmul_rn(c2[c], w2)), denom);
}

dim3 grid_of(int W, int H) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y);
}

}  // namespace

extern "C" {

// One pull step of an (H, W) level: ins holds 5 pointers to f32 planes (r,
// g, b, alpha, depth) read through their row and column strides; out is a
// contiguous (5, H2, W2) f32 buffer, H2 = max(H / 2, 1), W2 likewise.
int rgbd_holefill_pull(const long long* ins, const long long* row_strides,
                       const long long* col_strides, void* out, int H, int W,
                       void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  PullArgs a;
  for (int k = 0; k < PULL_PLANES; ++k)
    a.in[k] = Plane{(const float*)ins[k], row_strides[k], col_strides[k]};
  a.out = (float*)out;
  a.H = H;
  a.W = W;
  a.H2 = H / 2 > 1 ? H / 2 : 1;
  a.W2 = W / 2 > 1 ? W / 2 : 1;
  pull_kernel<<<grid_of(a.W2, a.H2), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The push over an (H, W) LOD 0 of L levels: ins / strides the LOD 0 r, g,
// b, alpha planes; levels the L - 1 coarser levels, each a contiguous
// (C >= 4, Hl, Wl) f32 buffer of r, g, b, alpha planes first, level_hw
// their (Hl, Wl) pairs; taps one int32 buffer of the per-axis tables
// (L x 3 x H row taps, L x 3 x W column taps, then the f32 weights, L x 2 x
// H and L x 2 x W; level 0's entries unread); out a contiguous (4, H, W)
// f32 buffer; level an (H, W) int32 buffer of each pixel's level, or null.
int rgbd_holefill_push(const long long* ins, const long long* row_strides,
                       const long long* col_strides, const long long* levels,
                       const int* level_hw, int L, const void* taps,
                       void* out, void* level, int H, int W, void* stream) {
  if (H < 1 || W < 1 || L < 1 || L > MAX_LODS)
    return (int)cudaErrorInvalidValue;
  PushArgs a;
  for (int k = 0; k < PLANES; ++k)
    a.in[k] = Plane{(const float*)ins[k], row_strides[k], col_strides[k]};
  a.lvl[0] = nullptr;
  a.hl[0] = H;
  a.wl[0] = W;
  for (int l = 1; l < MAX_LODS; ++l) {
    const bool used = l < L;
    a.lvl[l] = used ? (const float*)levels[l - 1] : nullptr;
    a.hl[l] = used ? level_hw[2 * (l - 1)] : 0;
    a.wl[l] = used ? level_hw[2 * (l - 1) + 1] : 0;
  }
  a.L = L;
  const int* t = (const int*)taps;
  a.yi = t;
  a.xi = t + (long long)L * 3 * H;
  a.yw = (const float*)(a.xi + (long long)L * 3 * W);
  a.xw = a.yw + (long long)L * 2 * H;
  a.out = (float*)out;
  a.level = (int*)level;
  a.H = H;
  a.W = W;
  push_kernel<<<grid_of(W, H), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
