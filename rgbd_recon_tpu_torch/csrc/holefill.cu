// Pull-push hole fill over a mip pyramid, in shared-memory tiles: a pull
// launch makes two pyramid levels (the last one level when the pull steps
// are odd), one push launch fills LOD 0.
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
// pull_tile_kernel<STEPS>: a block of 256 threads owns a tile of level
// l + STEPS, 8 x 8 texels for two levels a launch, 8 x 32 for one.
//  - It stages the level-l window the tile needs into shared memory, each
//    slot holding the texel at its index clamped to the level, so that a
//    tap reads its unclamped offset: for two levels rows 4a - 3 .. 4a +
//    34 and 38 columns alike, for one 18 x 66. A slot keeps depth, one
//    validity byte (alpha > 0, tested once a texel; alpha is read for
//    nothing else) and r, g, b of the valid texels only (a tenth of a
//    frame's at LOD 0), read after their alpha, one texel a thread
//    through the strides (the planes may be views; float4 rows where the
//    planes allowed them measured within 1% of it, and are not kept). A
//    thread issues all its loads of one kind before it waits on one.
//  - Two levels: the tile's level l + 1 region with its halo (18 x 18) is
//    computed from the window into shared memory, a halo slot outside the
//    level at its clamped index (it then holds the bits the clamp reads in
//    the twin); only the texels the tile owns go to global memory (rows
//    2a .. 2a + 15, to the level's last row in the last tile row; columns
//    alike), since the push reads every level. Level l + 2 is computed
//    from the region alone.
//  - Every tap of both levels is read from shared memory. Shared memory
//    30.1 KB a block (20.2 KB for one level), at most 64 registers: 4
//    blocks an SM. A 32 x 8 tile (45.7 KB, 5 rounds of 1,188 region texels
//    a block) measured 18-24 us a launch whatever its size: each block
//    ran one long chain of dependent instructions on an SM of 8 warps.
//  - A fill makes ceil((L - 1) / 2) launches (3 at 7 LODs). The two
//    smallest levels are a launch of their own: 6 blocks, ~5.4 us; done
//    by the last block of the launch before (a done-counter), they would
//    run on one SM after it, in about that time.
//
// push_tile_kernel: a block of 256 threads owns a 64 x 16 LOD 0 tile, 4
// pixels a thread (two rows, two columns 32 apart: a warp reads and
// writes 128 contiguous bytes a plane). Before any pixel walks the levels,
// a warp a level reads the per-axis taps of the tile's rows and columns
// and reduces them to the rectangle of texels they reach (their least and
// greatest), then stages the taps as offsets into it; the block stages
// the r, g, b, alpha planes of every level's rectangle and marks the
// levels whose rectangle holds no texel with alpha > 0, which no pixel's
// walk then looks up. The walk and the samples read shared memory only. A
// rectangle's size is bounded by min(Hl, ceil(15 Hl / H) + 3) x min(Wl,
// ceil(63 Wl / W) + 3) (one more than the taps' span can reach): the
// wrapper reserves that much a level (ops/holefill.py push_layout; the
// library refuses a layout that differs from its own tile's, and a block
// whose rectangle outgrows its reservation traps, failing the launch):
// 11 x 35 texels at level 1 of a halving pyramid (10 x 34 used at
// 1280x720), 19.8 KB with the taps (1.6 KB a level) at 1280x720 and 7
// levels, 36.1 KB at the 16 levels that planes of fewer than 2^31 entries
// allow. A
// blend whose weights sum to 1 exactly skips its division (x / 1 is x).
// Each pixel is stored from registers: staging the tile's outputs in
// shared memory to store float4 words measured no faster and cost a
// barrier.
//
// Bound on this card: bytes. The pull reads alpha and depth of its input
// levels once (LOD 0 and every second level after it), r, g, b of their
// valid texels, and writes every level once (a launch's inner level is not
// read back); the push reads LOD 0 alpha, r, g, b of the pixels that keep
// level 0, each coarser level's 4 planes (L2-resident at these sizes) and
// writes 4 planes.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a block: 8 warps
// levels of a pyramid (an int side of 2^31 halves 31 times)
constexpr int MAX_LODS = 32;
constexpr int PULL_PLANES = 5;  // r, g, b, alpha, depth
constexpr int PLANES = 4;       // r, g, b, alpha
// the push's LOD 0 tile: 16 rows of 64 pixels, 4 a thread (rows warp and
// warp + 8, columns lane and lane + 32)
constexpr int PTY = 16, PTX = 64, PR = PTY / 8, PX = PTX / 32;
// the push's per-level taps in shared memory: 5 rows of PTY (nearest,
// bilinear tap 0 and 1 as offsets into the level's rectangle planes, the
// two weights), then 5 rows of PTX (the columns alike, relative to the
// rectangle's first column), as 32-bit words
constexpr int TAP_WORDS = 5 * (PTY + PTX);
// dynamic shared memory a block may take without an opt-in
constexpr int SMEM_MAX = 48 * 1024;

// a pull launch's output tile (OY rows and OX columns of level l + STEPS),
// the level l + 1 region it computes (STEPS 2: the tile's window at level
// l + 1) and the level-l window that region reads
template <int STEPS>
struct PullTile {
  static constexpr int OY = 8, OX = STEPS == 2 ? 8 : 32;
  static constexpr int RY = STEPS == 2 ? 2 * OY + 2 : OY;
  static constexpr int RX = STEPS == 2 ? 2 * OX + 2 : OX;
  static constexpr int WY = 2 * RY + 2, WX = 2 * RX + 2;
};

struct Plane {
  const float* p;
  long long rs;  // row stride (elements)
  long long cs;  // column stride (elements)
};

struct PullArgs {
  Plane in[PULL_PLANES];  // level l
  float* out1;            // level l + 1: (5, H1, W1), contiguous
  float* out2;            // level l + 2: (5, H2, W2), contiguous (STEPS 2)
  int H, W, H1, W1, H2, W2;
};

struct PushArgs {
  Plane in[PLANES];              // LOD 0 r, g, b, alpha
  const float* lvl[MAX_LODS];    // level l >= 1: (C >= 4, Hl, Wl)
  int hl[MAX_LODS], wl[MAX_LODS];
  int roff[MAX_LODS];            // level l's rectangle at roff[l]
  int rect_texels;               // texels the rectangles reserve a plane
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

// One pull texel from its 16 taps: dv(dy, dx, d, valid) gives a tap's
// depth and validity, rgb(dy, dx, r, g, b) the colour of a kept tap (only
// kept taps are read).
template <class DV, class RGB>
__device__ __forceinline__ void pull_texel(DV dv, RGB rgb, float out[5]) {
  float d[16];
  bool valid[16];
  float sum_d = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const int t = dx * 4 + dy;
      dv(dy, dx, d[t], valid[t]);
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
      // (never -0.0: it starts at +0.0) as it is; its read is skipped
      float r = 0.0f, g = 0.0f, b = 0.0f;
      if (keep) rgb(dy, dx, r, g, b);
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
  out[0] = has ? __fdiv_rn(tr, w) : 0.0f;
  out[1] = has ? __fdiv_rn(tg, w) : (hole ? 0.0f : 1.0f);
  out[2] = has ? __fdiv_rn(tb, w) : 0.0f;
  out[3] = has ? 1.0f : (hole ? -1.0f : 0.0f);
  out[4] = has ? __fdiv_rn(total_d, w) : centre;
}

__device__ __forceinline__ void store5(float* out, int h, int w, int r,
                                       int c, const float v[5]) {
  const long long n = (long long)h * w, o = (long long)r * w + c;
#pragma unroll
  for (int k = 0; k < 5; ++k) out[k * n + o] = v[k];
}

// Stage the level-l window of WY x WX slots at unclamped origin (wy0, wx0)
// into s_c (the r, g, b and depth planes, WY * WX each) and s_v (alpha >
// 0), each slot the texel at its clamped index, one texel a thread through
// the planes' strides (they may be views); r, g, b only where alpha > 0
// (no other colour can be kept). A thread issues all its loads of one
// kind before it waits on one.
template <int WY, int WX>
__device__ __forceinline__ void stage_window(const Plane* in, int wy0,
                                             int wx0, int H, int W,
                                             float* s_c, unsigned char* s_v) {
  constexpr int N = WY * WX;
  constexpr int ITEMS = (N + THREADS - 1) / THREADS;
  const int tid = threadIdx.x;
  int gr[ITEMS], gc[ITEMS];
  float v[ITEMS][5];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int s = tid + k * THREADS;
    if (s >= N) break;
    const int sr = s / WX, sc = s - sr * WX;
    gr[k] = clamp_idx(wy0 + sr, H);
    gc[k] = clamp_idx(wx0 + sc, W);
    v[k][3] = load(in[3], gr[k], gc[k]);
    v[k][4] = load(in[4], gr[k], gc[k]);
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (tid + k * THREADS >= N) break;
    const bool ok = v[k][3] > 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[k][c] = ok ? load(in[c], gr[k], gc[k]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int s = tid + k * THREADS;
    if (s >= N) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) s_c[c * N + s] = v[k][c];
    s_c[3 * N + s] = v[k][4];
    s_v[s] = v[k][3] > 0.0f;
  }
}

template <int STEPS>
__global__ void __launch_bounds__(THREADS, 4) pull_tile_kernel(PullArgs a) {
  using T = PullTile<STEPS>;
  constexpr int WN = T::WY * T::WX;
  constexpr int RN = STEPS == 2 ? T::RY * T::RX : 1;
  __shared__ float s_c[4 * WN];       // the window's r, g, b, depth
  __shared__ unsigned char s_v[WN];   // its alpha > 0
  __shared__ float s_rc[4 * RN];      // the region's r, g, b, depth
  __shared__ unsigned char s_rv[RN];  // its alpha > 0
  const int tid = threadIdx.x;
  const int ta = blockIdx.y * T::OY, tb = blockIdx.x * T::OX;  // origin
  const int ry0 = STEPS == 2 ? 2 * ta - 1 : ta;
  const int rx0 = STEPS == 2 ? 2 * tb - 1 : tb;
  const int wy0 = 2 * ry0 - 1, wx0 = 2 * rx0 - 1;
  stage_window<T::WY, T::WX>(a.in, wy0, wx0, a.H, a.W, s_c, s_v);
  __syncthreads();

  // level l + 1: the region's texels, each from the window; the rows and
  // columns of it this tile writes (STEPS 2)
  const int own_y1 = blockIdx.y + 1 == gridDim.y ? a.H1 : 2 * ta + 2 * T::OY;
  const int own_x1 = blockIdx.x + 1 == gridDim.x ? a.W1 : 2 * tb + 2 * T::OX;
  for (int s = tid; s < T::RY * T::RX; s += THREADS) {
    const int rr = s / T::RX, cc = s - rr * T::RX;
    const int uy = ry0 + rr, ux = rx0 + cc;  // unclamped
    if (STEPS == 1 && (uy >= a.H1 || ux >= a.W1)) continue;
    const int R = clamp_idx(uy, a.H1), C = clamp_idx(ux, a.W1);
    // the window slot of tap (0, 0)
    const int b0 = (2 * R - 1 - wy0) * T::WX + 2 * C - 1 - wx0;
    float v[5];
    pull_texel(
        [&](int dy, int dx, float& d, bool& ok) {
          const int t = b0 + dy * T::WX + dx;
          d = s_c[3 * WN + t];
          ok = s_v[t] != 0;
        },
        [&](int dy, int dx, float& r, float& g, float& b) {
          const int t = b0 + dy * T::WX + dx;
          r = s_c[t];
          g = s_c[WN + t];
          b = s_c[2 * WN + t];
        },
        v);
    if (STEPS == 1) {
      store5(a.out1, a.H1, a.W1, R, C, v);
      continue;
    }
    s_rc[s] = v[0];
    s_rc[RN + s] = v[1];
    s_rc[2 * RN + s] = v[2];
    s_rc[3 * RN + s] = v[4];
    s_rv[s] = v[3] > 0.0f;
    if (uy >= 2 * ta && uy < own_y1 && ux >= 2 * tb && ux < own_x1)
      store5(a.out1, a.H1, a.W1, uy, ux, v);
  }
  if (STEPS == 1) return;
  __syncthreads();

  // level l + 2: one texel a thread from the region
  if (tid >= T::OY * T::OX) return;
  const int ly = tid / T::OX, lx = tid - ly * T::OX;
  const int j = ta + ly, i = tb + lx;
  if (j >= a.H2 || i >= a.W2) return;
  const int b0 = 2 * ly * T::RX + 2 * lx;
  float v[5];
  pull_texel(
      [&](int dy, int dx, float& d, bool& ok) {
        const int t = b0 + dy * T::RX + dx;
        d = s_rc[3 * RN + t];
        ok = s_rv[t] != 0;
      },
      [&](int dy, int dx, float& r, float& g, float& b) {
        const int t = b0 + dy * T::RX + dx;
        r = s_rc[t];
        g = s_rc[RN + t];
        b = s_rc[2 * RN + t];
      },
      v);
  store5(a.out2, a.H2, a.W2, j, i, v);
}

// GL-bilinear sample of a level's staged rectangle at the pixel of tile
// row ty, tile column tx: rect the r plane (g, b, alpha follow `plane`
// apart), t the level's staged taps (row taps as offsets into the planes,
// column taps relative to the rectangle's first column); vertical taps,
// then horizontal, as (my @ P) @ mx^T
__device__ __forceinline__ void bilinear(const float* rect, int plane,
                                         const int* t, int ty, int tx,
                                         float out[PLANES]) {
  const int r0 = t[1 * PTY + ty], r1 = t[2 * PTY + ty];
  const float wy0 = __int_as_float(t[3 * PTY + ty]);
  const float wy1 = __int_as_float(t[4 * PTY + ty]);
  const int* tc = t + 5 * PTY;
  const int c0 = tc[1 * PTX + tx], c1 = tc[2 * PTX + tx];
  const float wx0 = __int_as_float(tc[3 * PTX + tx]);
  const float wx1 = __int_as_float(tc[4 * PTX + tx]);
#pragma unroll
  for (int c = 0; c < PLANES; ++c) {
    const float* p = rect + c * plane;
    const float t0 =
        __fadd_rn(__fmul_rn(wy0, p[r0 + c0]), __fmul_rn(wy1, p[r1 + c0]));
    const float t1 =
        __fadd_rn(__fmul_rn(wy0, p[r0 + c1]), __fmul_rn(wy1, p[r1 + c1]));
    out[c] = __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1));
  }
}

__global__ void __launch_bounds__(THREADS) push_tile_kernel(PushArgs a) {
  // the rectangles (4 planes of rect_texels), then the taps
  extern __shared__ float s_dyn[];
  float* s_rect = s_dyn;
  int* s_tap = (int*)(s_dyn + PLANES * a.rect_texels);
  __shared__ int s_r0[MAX_LODS], s_c0[MAX_LODS], s_nr[MAX_LODS],
      s_nc[MAX_LODS];
  __shared__ int s_any[MAX_LODS];  // a texel of the rectangle has alpha > 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * PTX, y0 = blockIdx.y * PTY;
  const int H = a.H, W = a.W, L = a.L, plane = a.rect_texels;
  if (tid < MAX_LODS) s_any[tid] = 0;
  // this thread's pixels: tile rows warp + 8 r, tile columns lane + 32 p
  bool in[PR][PX];
  float a0[PR][PX];
#pragma unroll
  for (int r = 0; r < PR; ++r) {
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int y = y0 + warp + 8 * r, x = x0 + lane + 32 * p;
      in[r][p] = x < W && y < H;
      a0[r][p] = in[r][p] ? load(a.in[3], y, x) : 0.0f;
    }
  }

  // the taps of the tile's rows and columns (past the image's side its
  // last row or column), a warp a level: the rectangle they reach (their
  // least and greatest), then the taps staged as offsets into it
  for (int l = 1 + warp; l < L; l += THREADS / 32) {
    int* t = s_tap + (l - 1) * TAP_WORDS;
    int xv[PX][3], yv[3] = {0, 0, 0};
    float xw[PX][2], yw[2] = {0.0f, 0.0f};
    int cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int xx = min(x0 + lane + 32 * p, W - 1);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        xv[p][q] = __ldg(a.xi + (l * 3 + q) * W + xx);
        cmin = min(cmin, xv[p][q]);
        cmax = max(cmax, xv[p][q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) xw[p][q] = __ldg(a.xw + (l * 2 + q) * W + xx);
    }
    int rmin = INT_MAX, rmax = INT_MIN;
    if (lane < PTY) {
      const int yy = min(y0 + lane, H - 1);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        yv[q] = __ldg(a.yi + (l * 3 + q) * H + yy);
        rmin = min(rmin, yv[q]);
        rmax = max(rmax, yv[q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) yw[q] = __ldg(a.yw + (l * 2 + q) * H + yy);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, o));
      cmax = max(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      rmin = min(rmin, __shfl_xor_sync(0xffffffffu, rmin, o));
      rmax = max(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    }
    const int nc = cmax - cmin + 1, base = a.roff[l];
    int* tc = t + 5 * PTY;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
#pragma unroll
      for (int q = 0; q < 3; ++q) tc[q * PTX + lane + 32 * p] = xv[p][q] - cmin;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tc[(3 + q) * PTX + lane + 32 * p] = __float_as_int(xw[p][q]);
    }
    if (lane < PTY) {
#pragma unroll
      for (int q = 0; q < 3; ++q) t[q * PTY + lane] = base + (yv[q] - rmin) * nc;
#pragma unroll
      for (int q = 0; q < 2; ++q) t[(3 + q) * PTY + lane] = __float_as_int(yw[q]);
    }
    if (lane == 0) {
      // a rectangle past its reservation would overwrite the next level's
      // or the taps: the launch fails instead (the host checked the
      // reservations against this kernel's tile: push_layout_ok)
      const int end = l + 1 < L ? a.roff[l + 1] : a.rect_texels;
      if ((long long)(rmax - rmin + 1) * nc > end - base) __trap();
      s_r0[l] = rmin;
      s_nr[l] = rmax - rmin + 1;
      s_c0[l] = cmin;
      s_nc[l] = nc;
    }
  }
  __syncthreads();

  // the colour of a pixel that keeps level 0 (alpha > 0, or a pyramid of
  // LOD 0 alone), in flight with the rectangles' loads
  float c0[PR][PX][3];
#pragma unroll
  for (int r = 0; r < PR; ++r) {
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const bool own = in[r][p] && (a0[r][p] > 0.0f || L == 1);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        c0[r][p][c] = own ? load(a.in[c], y0 + warp + 8 * r,
                                 x0 + lane + 32 * p)
                          : 0.0f;
    }
  }
  // every level's rectangle, one flat loop over the levels; a level whose
  // rectangle has no texel with alpha > 0 is marked, so that no pixel
  // looks it up in its walk
  {
    int total = 0;
    for (int l = 1; l < L; ++l) total += s_nr[l] * s_nc[l];
    for (int i = tid; i < total; i += THREADS) {
      int l = 1, k = i;
      for (int n = s_nr[1] * s_nc[1]; k >= n; n = s_nr[l] * s_nc[l]) {
        k -= n;
        ++l;
      }
      const int nc = s_nc[l], rr = k / nc, cc = k - rr * nc;
      const long long lp = (long long)a.hl[l] * a.wl[l];
      const float* p =
          a.lvl[l] + (long long)(s_r0[l] + rr) * a.wl[l] + s_c0[l] + cc;
      float* q = s_rect + a.roff[l] + k;
      const float r = __ldg(p), g = __ldg(p + lp), b = __ldg(p + 2 * lp),
                  al = __ldg(p + 3 * lp);
      q[0] = r;
      q[plane] = g;
      q[2 * plane] = b;
      q[3 * plane] = al;
      if (al > 0.0f) s_any[l] = 1;
    }
  }
  __syncthreads();

  const float* s_alpha = s_rect + 3 * plane;
#pragma unroll
  for (int r = 0; r < PR; ++r) {
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      if (!in[r][p]) continue;
      const int ty = warp + 8 * r, tx = lane + 32 * p;
      const int y = y0 + ty, x = x0 + tx;
      int level = L - 1;
      if (a0[r][p] > 0.0f) {
        level = 0;
      } else {
        for (int l = 1; l < L - 1; ++l) {
          if (!s_any[l]) continue;
          const int* t = s_tap + (l - 1) * TAP_WORDS;
          if (s_alpha[t[ty] + t[5 * PTY + tx]] > 0.0f) {
            level = l;
            break;
          }
        }
      }
      if (a.level) a.level[(long long)y * W + x] = level;
      float v[PLANES] = {c0[r][p][0], c0[r][p][1], c0[r][p][2], a0[r][p]};
      if (level > 0) {
        const int l1 = min(level + 1, L - 1), l2 = min(level + 2, L - 1);
        float c1[PLANES], c2[PLANES];
        bilinear(s_rect, plane, s_tap + (l1 - 1) * TAP_WORDS, ty, tx, c1);
        if (l2 == l1) {
#pragma unroll
          for (int c = 0; c < PLANES; ++c) c2[c] = c1[c];
        } else {
          bilinear(s_rect, plane, s_tap + (l2 - 1) * TAP_WORDS, ty, tx, c2);
        }
        const float u = __fdiv_rn(__fadd_rn((float)x, 0.5f), (float)W);
        const float vv = __fdiv_rn(__fadd_rn((float)y, 0.5f), (float)H);
        const float w1 =
            __fsqrt_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(vv, vv)));
        const float w2 = __fsub_rn(1.0f, w1);
        const float s = __fadd_rn(w1, w2);
        const float denom = fabsf(s) < 1e-20f ? 1e-20f : s;
        // x / 1 is x: most pixels' weights sum to 1 exactly
#pragma unroll
        for (int c = 0; c < PLANES; ++c) {
          const float num =
              __fadd_rn(__fmul_rn(c1[c], w1), __fmul_rn(c2[c], w2));
          v[c] = denom == 1.0f ? num : __fdiv_rn(num, denom);
        }
      }
      // a warp stores 32 neighbouring pixels of a row: 128 bytes a plane
      const long long o = (long long)y * W + x, n = (long long)H * W;
#pragma unroll
      for (int c = 0; c < PLANES; ++c) a.out[c * n + o] = v[c];
    }
  }
}

template <int STEPS>
dim3 pull_grid(int W, int H) {
  using T = PullTile<STEPS>;
  return dim3((W + T::OX - 1) / T::OX, (H + T::OY - 1) / T::OY);
}

Plane level_plane(const float* lvl, int k, int h, int w) {
  return Plane{lvl + (long long)k * h * w, w, 1};
}

// `steps` pull steps from an (H, W) level whose planes are `in`: level k of
// the steps (k = 1 .. steps) at out + offsets[k - 1], (5, hw[2k - 2],
// hw[2k - 1]); two steps a launch, the last one alone when steps is odd.
int run_pulls(const Plane in0[PULL_PLANES], float* out,
              const long long* offsets, const int* hw, int steps, int H,
              int W, cudaStream_t stream, int* launches) {
  Plane cur[PULL_PLANES];
  for (int k = 0; k < PULL_PLANES; ++k) cur[k] = in0[k];
  int h = H, w = W;
  for (int s = 0; s < steps; s += 2) {
    const int n = steps - s >= 2 ? 2 : 1;
    PullArgs a;
    for (int k = 0; k < PULL_PLANES; ++k) a.in[k] = cur[k];
    a.H = h;
    a.W = w;
    a.H1 = hw[2 * s];
    a.W1 = hw[2 * s + 1];
    a.out1 = out + offsets[s];
    a.H2 = n == 2 ? hw[2 * s + 2] : 0;
    a.W2 = n == 2 ? hw[2 * s + 3] : 0;
    a.out2 = n == 2 ? out + offsets[s + 1] : nullptr;
    if (n == 2)
      pull_tile_kernel<2><<<pull_grid<2>(a.W2, a.H2), THREADS, 0, stream>>>(a);
    else
      pull_tile_kernel<1><<<pull_grid<1>(a.W1, a.H1), THREADS, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    h = n == 2 ? a.H2 : a.H1;
    w = n == 2 ? a.W2 : a.W1;
    const float* lvl = n == 2 ? a.out2 : a.out1;
    for (int k = 0; k < PULL_PLANES; ++k) cur[k] = level_plane(lvl, k, h, w);
  }
  return 0;
}

int run_push(const PushArgs& a, int smem, cudaStream_t stream) {
  if (smem < 0 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + PTX - 1) / PTX, (a.H + PTY - 1) / PTY);
  push_tile_kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Texels along one axis of level n_l that the taps of t consecutive pixels
// of an n-pixel LOD 0 axis can reach (ops/holefill.py push_rect_bound).
long long rect_bound(long long n, long long n_l, long long t) {
  const long long b = ((t - 1) * n_l + n - 1) / n + 3;
  return b < n_l ? b : n_l;
}

// Whether the rectangle layout the caller passes (ops/holefill.py
// push_layout: each level's offset, the texels reserved, the dynamic
// shared memory) is the one this kernel's PTY x PTX tile needs.
bool push_layout_ok(const int* level_hw, const int* roff, int rect_texels,
                    int smem, int L, int H, int W) {
  long long texels = 0;
  for (int l = 1; l < L; ++l) {
    if (roff[l - 1] != texels) return false;
    texels += rect_bound(H, level_hw[2 * (l - 1)], PTY) *
              rect_bound(W, level_hw[2 * (l - 1) + 1], PTX);
  }
  return rect_texels == texels &&
         smem == 16 * texels + 4LL * TAP_WORDS * (L - 1);
}

// The push's arguments but the levels' pointers.
int push_args(PushArgs* a, const long long* ins, const long long* rs,
              const long long* cs, const int* level_hw, const int* roff,
              int rect_texels, int smem, int L, const void* taps, void* out,
              void* level, int H, int W) {
  if (H < 1 || W < 1 || L < 1 || L > MAX_LODS ||
      !push_layout_ok(level_hw, roff, rect_texels, smem, L, H, W))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < PLANES; ++k)
    a->in[k] = Plane{(const float*)ins[k], rs[k], cs[k]};
  for (int l = 0; l < MAX_LODS; ++l) {
    const bool used = l >= 1 && l < L;
    a->lvl[l] = nullptr;
    a->hl[l] = used ? level_hw[2 * (l - 1)] : (l == 0 ? H : 0);
    a->wl[l] = used ? level_hw[2 * (l - 1) + 1] : (l == 0 ? W : 0);
    a->roff[l] = used ? roff[l - 1] : 0;
  }
  a->rect_texels = rect_texels;
  a->L = L;
  const int* t = (const int*)taps;
  a->yi = t;
  a->xi = t + (long long)L * 3 * H;
  a->yw = (const float*)(a->xi + (long long)L * 3 * W);
  a->xw = a->yw + (long long)L * 2 * H;
  a->out = (float*)out;
  a->level = (int*)level;
  a->H = H;
  a->W = W;
  return 0;
}

}  // namespace

extern "C" {

// `steps` pull steps of an (H, W) level: ins holds 5 pointers to f32 planes
// (r, g, b, alpha, depth) read through their row and column strides; out a
// contiguous f32 buffer holding level k of the steps (k = 1 .. steps) at
// out + offsets[k - 1] as (5, level_hw[2k - 2], level_hw[2k - 1]), each
// side max(side above / 2, 1). Two steps a launch (the last alone when
// steps is odd); *launches counts the launches made.
int rgbd_holefill_pull(const long long* ins, const long long* row_strides,
                       const long long* col_strides, void* out,
                       const long long* offsets, const int* level_hw,
                       int steps, int H, int W, int* launches,
                       void* stream) {
  *launches = 0;
  if (H < 1 || W < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  Plane in[PULL_PLANES];
  for (int k = 0; k < PULL_PLANES; ++k)
    in[k] = Plane{(const float*)ins[k], row_strides[k], col_strides[k]};
  return run_pulls(in, (float*)out, offsets, level_hw, steps, H, W,
                   (cudaStream_t)stream, launches);
}

// The push over an (H, W) LOD 0 of L levels: ins / strides the LOD 0 r, g,
// b, alpha planes; levels the L - 1 coarser levels, each a contiguous
// (C >= 4, Hl, Wl) f32 buffer of r, g, b, alpha planes first, level_hw
// their (Hl, Wl) pairs; roff each level's rectangle offset (texels)
// in the rect_texels the rectangles reserve, smem the dynamic shared
// memory (rectangles and taps, ops/holefill.py push_layout; any other
// layout than this kernel's tile needs is refused); taps one
// int32 buffer of the per-axis tables (L x 3 x H row taps, L x 3 x W
// column taps, then the f32 weights, L x 2 x H and L x 2 x W; level 0's
// entries unread); out a contiguous (4, H, W) f32 buffer; level an (H, W)
// int32 buffer of each pixel's level, or null.
int rgbd_holefill_push(const long long* ins, const long long* row_strides,
                       const long long* col_strides, const long long* levels,
                       const int* level_hw, const int* roff, int rect_texels,
                       int smem, int L, const void* taps, void* out,
                       void* level, int H, int W, void* stream) {
  PushArgs a;
  const int err = push_args(&a, ins, row_strides, col_strides, level_hw,
                            roff, rect_texels, smem, L, taps, out, level, H,
                            W);
  if (err) return err;
  for (int l = 1; l < L; ++l) a.lvl[l] = (const float*)levels[l - 1];
  return run_push(a, smem, (cudaStream_t)stream);
}

// The whole fill of an (H, W) LOD 0 in one call: the L - 1 pull steps of
// ins (r, g, b, alpha, depth; rgbd_holefill_pull) into the pyramid buffer
// pyr at offsets, then the push (rgbd_holefill_push) over them into out.
// *launches counts the pull launches made.
int rgbd_holefill_fill(const long long* ins, const long long* row_strides,
                       const long long* col_strides, void* pyr,
                       const long long* offsets, const int* level_hw,
                       const int* roff, int rect_texels, int smem, int L,
                       const void* taps, void* out, int H, int W,
                       int* launches, void* stream) {
  *launches = 0;
  PushArgs a;
  int err = push_args(&a, ins, row_strides, col_strides, level_hw, roff,
                      rect_texels, smem, L, taps, out, nullptr, H, W);
  if (err) return err;
  Plane in[PULL_PLANES];
  for (int k = 0; k < PULL_PLANES; ++k)
    in[k] = Plane{(const float*)ins[k], row_strides[k], col_strides[k]};
  err = run_pulls(in, (float*)pyr, offsets, level_hw, L - 1, H, W,
                  (cudaStream_t)stream, launches);
  if (err) return err;
  for (int l = 1; l < L; ++l) a.lvl[l] = (const float*)pyr + offsets[l - 1];
  return run_push(a, smem, (cudaStream_t)stream);
}

}  // extern "C"
