// The block stages of the render's staged march, one launch each: the
// interval scan, the block set-up, the bracket and the fine march's ray
// rows, the hit gather and the image assembly (ops/render_stages.py; the
// compaction between them is csrc/compact.cu, the marches csrc/march.cu).
//
// Replaces the XLA ops of rgbd_recon_tpu/recon/tsdf_pipeline.py:1208
// render_from_baked (ray_dirs :881, surface_aabb :899, scan_intervals
// :920, upc :1253, the bracket :1327, ray8 :1390, hit_pos_h :1472, the
// mode="drop" scatters :1312-1316, :1521, :1529; no Pallas kernel), in the
// port the plain twins of ops/render_stages.py, which on the card ran as
// ~860 PyTorch launches a render around 9 host syncs.
//
// Per element, exactly what the twins compute on the card (IEEE f32, no
// FMA contraction: the library is compiled with --fmad=false and without
// fast math, and every product and sum is written in the twins' order),
// with PyTorch's CUDA rules where they differ from the written formula:
//   x / s for a Python number s is x * f32(1 / s), the reciprocal taken
//   in double (INV, computed by the wrapper); 1.0 / x is reciprocal(x) * 1;
//   torch.rsqrt is rsqrtf; minimum / maximum return a NaN operand, else
//   fminf / fmaxf; clamp_min / clamp_max keep a NaN; a min / max over an
//   axis keeps the first NaN, else the first of the extreme values;
//   float -> int32 truncates (cvt.rzi), // of an int32 floors.
//
// Bound on this card: bytes. The scan reads the surface-brick grid and
// writes 5 values a scan ray (its 53 samples a ray read the brick grid
// through L1); the set-up, the bracket and the compose are one thread an
// element and write what they own once. Each stage is a few microseconds
// at the cells' 1280x720 camera: the design's aim is the host, not the
// device (each stage replaces 40-400 launches and the syncs between them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// kernels/render_stages.py RenderParams, field for field
struct RenderParams {
  // geometry
  int H, W, ds, Hb, Wb, NB, B2, sc, Hs, Ws, n_scan;
  int Z, Y, X, brick_vox, Bz, By, Bx, per_block;
  float inv_W, inv_H, tan_half, aspect;
  float inv_bbox[3];
  float inv_Z, inv_Y, inv_X, inv_nscan1;
  float step_len, brick_norm, pad, bracket_max, lo_gap, margin;
  // camera: eye in volume coordinates (3), rotation (3, 3), on the device
  const float* eye;
  const float* rot;
  // scan
  const unsigned char* occ;
  const float* bsafe;
  float* scan5;
  int* counts;
  int count_slot;
  // block set-up
  float* blk;
  float* s_end;
  unsigned char* bflags;
  float* grid;
  // bracket
  const long long* blk_idx;
  int capB;
  float* ray8;
  // hits
  const float* st8;
  const long long* hit_idx;
  int capH;
  int R;
  float* hrows;
  float* hpos;
  unsigned char* live;
  // compose
  const int* blk_slot;
  const int* hit_slot;
  const float* rgba_h;
  const float* depth_h;
  float* planes;
  float* depth;
  unsigned char* hit;
  int* num;
  int* overflow;
  int caps[5];  // ops/render_stages.py NUM_COUNTS
};

__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp_min0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ bool is_finite(float v) {
  return v == v && fabsf(v) != INFINITY;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ops/render_stages.py ray_dirs at pixel (py, px)
__device__ __forceinline__ void ray_dir(const RenderParams& p, int py,
                                        int px, float d[3]) {
  const float xs = __fsub_rn(
      __fmul_rn(__fmul_rn(__fadd_rn((float)px, 0.5f), p.inv_W), 2.0f),
      1.0f);
  const float ys = __fsub_rn(
      1.0f,
      __fmul_rn(__fmul_rn(__fadd_rn((float)py, 0.5f), p.inv_H), 2.0f));
  const float yy = __fmul_rn(ys, p.tan_half);
  const float xx = __fmul_rn(__fmul_rn(xs, p.tan_half), p.aspect);
  float dv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = __fmul_rn(xx, __ldg(p.rot + 3 * j));
    const float b = __fmul_rn(yy, __ldg(p.rot + 3 * j + 1));
    dv[j] = __fmul_rn(__fsub_rn(__fadd_rn(a, b), __ldg(p.rot + 3 * j + 2)),
                      p.inv_bbox[j]);
  }
  const float n2 = __fadd_rn(
      __fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
      __fmul_rn(dv[2], dv[2]));
  const float inv_n = rsqrtf(n2);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = __fmul_rn(dv[j], inv_n);
}

// _pool3 at (i, j) of an (h, w) plane with row stride w: the centre, then
// op with the 9 taps of the edge-padded window in row-major order
template <bool MIN>
__device__ __forceinline__ float pool3(const float* v, int h, int w, int i,
                                       int j) {
  float out = v[i * w + j];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int y = clampi(i + dy - 1, 0, h - 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float tap = v[y * w + clampi(j + dx - 1, 0, w - 1)];
      out = MIN ? t_min(out, tap) : t_max(out, tap);
    }
  }
  return out;
}

// ---- scan ----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) scan_kernel(RenderParams p) {
  // the surface bricks' AABB, every block for itself (a few KB of bricks
  // from L2)
  __shared__ int s_lo[3], s_hi[3], s_count;
  if (threadIdx.x < 3) {
    const int n[3] = {p.Bz, p.By, p.Bx};
    s_lo[threadIdx.x] = n[threadIdx.x];
    s_hi[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  {
    int lo[3] = {p.Bz, p.By, p.Bx}, hi[3] = {-1, -1, -1}, cnt = 0;
    const int nb = p.Bz * p.By * p.Bx;
    for (int k = threadIdx.x; k < nb; k += THREADS) {
      if (p.occ[k]) {
        const int z = k / (p.By * p.Bx), y = (k / p.Bx) % p.By,
                  x = k % p.Bx;
        lo[0] = min(lo[0], z);
        lo[1] = min(lo[1], y);
        lo[2] = min(lo[2], x);
        hi[0] = max(hi[0], z);
        hi[1] = max(hi[1], y);
        hi[2] = max(hi[2], x);
        ++cnt;
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMin(&s_lo[a], lo[a]);
      atomicMax(&s_hi[a], hi[a]);
    }
    atomicAdd(&s_count, cnt);
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.counts[p.count_slot] = s_count;
  // box in (x, y, z): lo * brick_vox / n, min(hi + 1 ..., 1)
  const float bv = (float)p.brick_vox;
  const float inv_n[3] = {p.inv_X, p.inv_Y, p.inv_Z};
  float box_lo[3], box_hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ax = 2 - a;  // x <- brick axis 2, z <- brick axis 0
    box_lo[a] = __fmul_rn(__fmul_rn((float)s_lo[ax], bv), inv_n[a]);
    const float h =
        __fmul_rn(__fmul_rn((float)(s_hi[ax] + 1), bv), inv_n[a]);
    box_hi[a] = h != h ? h : fminf(h, 1.0f);
  }

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  if (ray >= p.Hs * p.Ws) return;
  const int i = ray / p.Ws, j = ray % p.Ws;
  const int half = p.ds / 2;
  float d[3];
  ray_dir(p, half + p.ds * p.sc * i, half + p.ds * p.sc * j, d);
  const float e[3] = {__ldg(p.eye), __ldg(p.eye + 1), __ldg(p.eye + 2)};
  float l[3], h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = __fdiv_rn(1.0f, d[a]);
    const float tb = __fmul_rn(inv, __fsub_rn(box_lo[a], e[a]));
    const float tt = __fmul_rn(inv, __fsub_rn(box_hi[a], e[a]));
    l[a] = t_min(tb, tt);
    h[a] = t_max(tb, tt);
  }
  float s0 = t_max(t_max(l[0], l[1]), l[2]);
  float s1 = t_min(t_min(h[0], h[1]), h[2]);
  const bool valid = (s0 <= s1) && (s1 > 0.0f);
  s0 = clamp_min0(s0);
  s1 = valid ? s1 : -1.0f;
  float spacing = __fmul_rn(__fsub_rn(s1, s0), p.inv_nscan1);
  spacing = spacing != spacing ? spacing : fminf(spacing, p.step_len);
  const int n_dim[3] = {p.X, p.Y, p.Z};
  const int nb_dim[3] = {p.Bx, p.By, p.Bz};
  float first = 0.0f, last = 0.0f, fsurf = 0.0f;
  for (int k = 0; k < p.n_scan; ++k) {
    const float t = __fadd_rn(s0, __fmul_rn((float)k, spacing));
    int bi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float c = __fmul_rn(__fadd_rn(e[a], __fmul_rn(d[a], t)),
                                (float)n_dim[a]);
      bi[a] = clampi(floor_div((int)c, p.brick_vox), 0, nb_dim[a] - 1);
    }
    const int idx = (bi[2] * p.By + bi[1]) * p.Bx + bi[0];
    const float s = p.occ[idx] ? -1.0f : (p.bsafe[idx] == 0.0f ? 0.0f : 1.0f);
    const bool inside = valid && (t <= s1);
    const bool tgt = (s < 0.5f) && inside;
    const bool surf = (s < -0.5f) && inside;
    const float cf = tgt ? t : INFINITY;
    const float cl = surf ? t : -INFINITY;
    const float cs = surf ? t : INFINITY;
    if (k == 0) {
      first = cf;
      last = cl;
      fsurf = cs;
    } else {
      if (first == first && (cf != cf || cf < first)) first = cf;
      if (last == last && (cl != cl || cl > last)) last = cl;
      if (fsurf == fsurf && (cs != cs || cs < fsurf)) fsurf = cs;
    }
  }
  const int plane = p.Hs * p.Ws;
  p.scan5[ray] = first;
  p.scan5[plane + ray] = last;
  p.scan5[2 * plane + ray] = fsurf;
  p.scan5[3 * plane + ray] = s0;
  p.scan5[4 * plane + ray] = valid ? s1 : 0.0f;
}

// ---- block set-up ---------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    block_setup_kernel(RenderParams p) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= p.NB) return;
  const int by = b / p.Wb, bx = b % p.Wb;
  const int i = by / p.sc, j = bx / p.sc;
  const int plane = p.Hs * p.Ws;
  const float first = pool3<true>(p.scan5, p.Hs, p.Ws, i, j);
  const float last = pool3<false>(p.scan5 + plane, p.Hs, p.Ws, i, j);
  const float fsurf = pool3<true>(p.scan5 + 2 * plane, p.Hs, p.Ws, i, j);
  const float s0p = pool3<true>(p.scan5 + 3 * plane, p.Hs, p.Ws, i, j);
  const float s1p = pool3<false>(p.scan5 + 4 * plane, p.Hs, p.Ws, i, j);
  const bool found = is_finite(first) && is_finite(last);
  float s_start = t_max(
      t_max(__fsub_rn(first, p.pad),
            __fsub_rn(__fsub_rn(fsurf, p.brick_norm), p.pad)),
      s0p);
  const float s_end =
      t_min(__fadd_rn(__fadd_rn(last, p.step_len), p.pad), s1p);
  const float length =
      found ? clamp_min0(__fsub_rn(s_end, s_start)) : 0.0f;
  s_start = found ? s_start : 0.0f;
  float d[3];
  ray_dir(p, by * p.ds + p.ds / 2, bx * p.ds + p.ds / 2, d);
  float* row = p.blk + (long long)b * 8;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    row[a] = __fadd_rn(__ldg(p.eye + a), __fmul_rn(d[a], s_start));
    row[3 + a] = d[a];
  }
  row[6] = length;
  row[7] = s_start;
  p.s_end[b] = s_end;
  p.bflags[b] = (unsigned char)((length > 0.0f ? 1 : 0) | (found ? 2 : 0));
  p.grid[b] = 0.0f;
  p.grid[p.NB + b] = INFINITY;
  p.grid[2 * p.NB + b] = -INFINITY;
}

// ---- bracket --------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) bracket_kernel(RenderParams p) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= (long long)p.capB * p.B2) return;
  const int slot = (int)(r / p.B2), k = (int)(r % p.B2);
  const long long bid = __ldg(p.blk_idx + slot);
  const bool live = bid < p.NB;
  const int b = live ? (int)bid : p.NB - 1;
  const int by = b / p.Wb, bx = b % p.Wb;
  const float* hit_g = p.grid;
  const float* lo_g = p.grid + p.NB;
  const float* hi_g = p.grid + 2 * p.NB;
  const bool all9 = pool3<true>(hit_g, p.Hb, p.Wb, by, bx) > 0.5f;
  const float lo9 = pool3<true>(lo_g, p.Hb, p.Wb, by, bx);
  const float hi9 = pool3<false>(hi_g, p.Hb, p.Wb, by, bx);
  const float* row = p.blk + (long long)b * 8;
  const float s_start = row[7];
  const float length = row[6];
  const float s_end = p.s_end[b];
  const bool found = (p.bflags[b] & 2) != 0;
  const bool ok = all9 && (__fsub_rn(hi9, lo9) < p.bracket_max) &&
                  (__fsub_rn(lo9, s_start) < p.lo_gap);
  float b_lo, b_hi;
  if (p.per_block) {
    const float spread = __fmul_rn(__fsub_rn(hi9, lo9), 0.125f);
    const float lo_b = lo_g[b], hi_b = hi_g[b];
    b_lo = __fsub_rn(__fsub_rn(is_finite(lo_b) ? lo_b : s_start, p.margin),
                     spread);
    b_hi = __fadd_rn(__fadd_rn(is_finite(hi_b) ? hi_b : s_end, p.margin),
                     spread);
  } else {
    b_lo = __fsub_rn(lo9, p.margin);
    b_hi = __fadd_rn(hi9, p.margin);
  }
  const float f_start = ok ? t_max(b_lo, s_start) : s_start;
  const float len_brkt =
      (found && ok) ? clamp_min0(__fsub_rn(t_min(b_hi, s_end), f_start))
                    : length;
  const float len_full =
      clamp_min0(found ? __fsub_rn(s_end, f_start) : 0.0f);
  const float start = live ? f_start : 0.0f;
  float d[3];
  ray_dir(p, by * p.ds + k / p.ds, bx * p.ds + k % p.ds, d);
  float* out = p.ray8 + r * 8;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[a] = __fadd_rn(__ldg(p.eye + a), __fmul_rn(d[a], start));
    out[3 + a] = d[a];
  }
  out[6] = live ? len_full : 0.0f;
  out[7] = live ? len_brkt : 0.0f;
}

// ---- hits -----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    hit_gather_kernel(RenderParams p) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= p.capH) return;
  const long long id = __ldg(p.hit_idx + h);
  const bool live = id < p.R;
  const long long r = live ? id : p.R - 1;
  const float* ray = p.ray8 + r * 8;
  const float* st = p.st8 + r * 8;
  const float hit_t = __ldg(st + 5);
  float* out = p.hrows + (long long)h * 8;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p0 = __ldg(ray + a), d = __ldg(ray + 3 + a);
    out[a] = p0;
    out[3 + a] = d;
    p.hpos[(long long)h * 3 + a] = __fadd_rn(p0, __fmul_rn(d, hit_t));
  }
  out[6] = __ldg(st + 3);
  out[7] = __ldg(st + 4);
  p.live[h] = live;
}

// ---- compose --------------------------------------------------------------

// the list counts' slots as ops/render_stages.py lays them out (COUNT_*):
// 0 the blocks, 1 and 2 the tail stages, 3 the hits, 4 the surface bricks
__device__ __forceinline__ int past(const RenderParams& p, int k) {
  return p.caps[k] < 0 ? 0 : max(p.counts[k] - p.caps[k], 0);
}

__global__ void __launch_bounds__(THREADS) compose_kernel(RenderParams p) {
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix == 0) {
    p.overflow[0] = past(p, 0);
    p.overflow[1] = max(past(p, 1), past(p, 2));
    p.overflow[2] = past(p, 3);
    p.overflow[3] = past(p, 4);
  }
  const int n = p.H * p.W;
  if (pix >= n) return;
  const int y = pix / p.W, x = pix % p.W;
  const int sb = __ldg(p.blk_slot + (y / p.ds) * p.Wb + x / p.ds);
  int num = 0, hs = -1;
  if (sb >= 0) {
    const long long r =
        (long long)sb * p.B2 + (y % p.ds) * p.ds + (x % p.ds);
    num = (int)__ldg(p.st8 + r * 8 + 7);
    hs = __ldg(p.hit_slot + r);
  }
  const bool hit = hs >= 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    p.planes[(long long)c * n + pix] =
        hit ? __ldg(p.rgba_h + (long long)hs * 4 + c) : 0.0f;
  p.depth[pix] = hit ? __ldg(p.depth_h + hs) : 1.0f;
  p.hit[pix] = hit;
  p.num[pix] = num;
}

int blocks_for(long long n) {
  return n > 0 ? (int)((n + THREADS - 1) / THREADS) : 0;
}

}  // namespace

extern "C" {

int rgbd_render_params_size(int* out) {
  *out = (int)sizeof(RenderParams);
  return 0;
}

// Each entry point takes the parameter block (host memory, copied into the
// launch) and the stream; a stage of no elements launches nothing.
int rgbd_render_scan(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for((long long)p.Hs * p.Ws);
  // the surface-brick count is written even without scan rays
  scan_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0,
                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int rgbd_render_block_setup(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for(p.NB);
  if (blocks == 0) return 0;
  block_setup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int rgbd_render_bracket(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for((long long)p.capB * p.B2);
  if (blocks == 0) return 0;
  bracket_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int rgbd_render_hit_gather(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for(p.capH);
  if (blocks == 0) return 0;
  hit_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int rgbd_render_compose(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for((long long)p.H * p.W);
  // the overflow vector is written even without pixels
  compose_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0,
                   (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
