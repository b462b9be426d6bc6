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
// Bound on this card: the scan's operations, the other stages' bytes. The
// set-up, the hit gather and the compose are one thread an element and
// write what they own once; each is a few microseconds at the cells'
// 1280x720 camera, and the design's aim is the host (each stage replaces
// 40-400 launches and the syncs between them). The bracket runs a block
// slot's rays as one lane group: the slot's pools and bracket once, a
// thread a ray for its direction and its row, the thread block's rows
// stored as whole lines (its section below).
//
// The scan (14,400 rays of 53 samples at the cells' camera: 26.8 M
// operations, 0.0004 ms at the f32 peak; it reads 44 KB of brick grid and
// writes 288 KB) takes its time from latency: each sample's brick lookup
// depends on its position, and the grid is small. Its design:
//  - a persistent grid sized to the card (SCAN_BLOCKS_PER_SM blocks an SM,
//    the SM count passed by the wrapper), each block looping over its share
//    of the rays;
//  - the brick grid staged once a block into shared memory as a code a brick
//    (surface -1 where occ, clear 0 where bsafe == 0, else 1) by 16-byte
//    loads of occ and bsafe, 16 bricks a thread a step; the same pass
//    reduces the surface bricks' AABB and count by warp reductions and one
//    shared atomic a warp per word. The table holds grids of up to
//    SCAN_TABLE_MAX bricks (98,304 bytes: a 46^3 grid; the cells' 20 x 22 x
//    20 grid is 8,800); a larger grid reads its codes from occ and bsafe in
//    global memory in the same kernel (scan_kernel<false>);
//  - a ray's samples split over SCAN_LANES lanes of a warp, each lane a
//    contiguous run of ceil(n_scan / SCAN_LANES) samples folded by the
//    sequential rule, the lanes' partials combined by shuffles with the
//    lower samples' run always the left operand: a NaN held stays, a NaN
//    arriving wins, else strict < (> for last) replaces. The rule is
//    associative over ordered runs, so first, last and fsurf keep the
//    sequential fold's bits (signed zeros and NaNs included);
//  - a sample's brick index (int)c // brick_vox, clamped to the grid, by
//    a multiply and a shift in place of the integer division (exact below
//    2^31; a negative index is brick 0 either way).

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
  int sms;      // the card's SM count (the scan's grid)
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

// lanes a scan ray (a power of two), blocks an SM, bricks the shared table
// holds (a byte each), bricks a staging step of a thread
constexpr int SCAN_LANES = 8;
constexpr int SCAN_BLOCKS_PER_SM = 2;
constexpr int SCAN_TABLE_MAX = 96 * 1024;
constexpr int SCAN_CHUNK = 16;

// a brick's code: the twin's field, -1 surface, 0 clear, 1 other
__device__ __forceinline__ int brick_code(unsigned char occ, float bsafe) {
  return occ ? -1 : (bsafe == 0.0f ? 0 : 1);
}

// the sequential fold of the extremes: a NaN held stays, a NaN arriving
// wins, else a strictly smaller (larger) value replaces
__device__ __forceinline__ float fold_min(float acc, float v) {
  return (acc == acc && (v != v || v < acc)) ? v : acc;
}

__device__ __forceinline__ float fold_max(float acc, float v) {
  return (acc == acc && (v != v || v > acc)) ? v : acc;
}

// bricks [k0, k0 + SCAN_CHUNK) of occ and bsafe into o and b (16-byte
// loads where both are aligned and the run is whole; past the grid occ 0)
__device__ __forceinline__ void load_chunk(const RenderParams& p, int k0,
                                           int nb, bool vec,
                                           unsigned char o[SCAN_CHUNK],
                                           float b[SCAN_CHUNK]) {
  if (vec && k0 + SCAN_CHUNK <= nb) {
    const uint4 ov = __ldg(reinterpret_cast<const uint4*>(p.occ + k0));
    const unsigned w[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
    for (int i = 0; i < SCAN_CHUNK; ++i)
      o[i] = (w[i / 4] >> (8 * (i % 4))) & 0xff;
#pragma unroll
    for (int q = 0; q < SCAN_CHUNK / 4; ++q) {
      const float4 bv =
          __ldg(reinterpret_cast<const float4*>(p.bsafe + k0) + q);
      b[4 * q] = bv.x;
      b[4 * q + 1] = bv.y;
      b[4 * q + 2] = bv.z;
      b[4 * q + 3] = bv.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < SCAN_CHUNK; ++i) {
    const int k = k0 + i;
    o[i] = k < nb ? p.occ[k] : 0;
    b[i] = k < nb ? __ldg(p.bsafe + k) : 1.0f;
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) scan_kernel(RenderParams p) {
  extern __shared__ __align__(16) signed char s_code[];
  // the surface bricks' AABB (lo z y x, hi z y x) and count
  __shared__ int s_box[7];
  const int nbz[3] = {p.Bz, p.By, p.Bx};
  if (threadIdx.x < 3) {
    s_box[threadIdx.x] = nbz[threadIdx.x];
    s_box[3 + threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) s_box[6] = 0;
  __syncthreads();
  {
    const int nb = p.Bz * p.By * p.Bx;
    const bool vec = ((reinterpret_cast<uintptr_t>(p.occ) |
                       reinterpret_cast<uintptr_t>(p.bsafe)) & 15) == 0;
    int lo[3] = {p.Bz, p.By, p.Bx}, hi[3] = {-1, -1, -1}, cnt = 0;
    for (int k0 = threadIdx.x * SCAN_CHUNK; k0 < nb;
         k0 += THREADS * SCAN_CHUNK) {
      unsigned char o[SCAN_CHUNK];
      float b[SCAN_CHUNK];
      load_chunk(p, k0, nb, vec, o, b);
      if (STAGED) {
        unsigned w[SCAN_CHUNK / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < SCAN_CHUNK; ++i)
          w[i / 4] |= (unsigned)(brick_code(o[i], b[i]) & 0xff)
                      << (8 * (i % 4));
        if (k0 + SCAN_CHUNK <= nb) {
          *reinterpret_cast<uint4*>(s_code + k0) =
              make_uint4(w[0], w[1], w[2], w[3]);
        } else {
          for (int i = 0; i < nb - k0; ++i)
            s_code[k0 + i] = (signed char)(w[i / 4] >> (8 * (i % 4)));
        }
      }
      bool any = false;
#pragma unroll
      for (int i = 0; i < SCAN_CHUNK; ++i) any |= o[i] != 0;
      if (any) {
        int x = k0 % p.Bx, y = (k0 / p.Bx) % p.By, z = k0 / (p.By * p.Bx);
#pragma unroll
        for (int i = 0; i < SCAN_CHUNK; ++i) {
          if (o[i]) {
            lo[0] = min(lo[0], z);
            lo[1] = min(lo[1], y);
            lo[2] = min(lo[2], x);
            hi[0] = max(hi[0], z);
            hi[1] = max(hi[1], y);
            hi[2] = max(hi[2], x);
            ++cnt;
          }
          if (++x == p.Bx) {
            x = 0;
            if (++y == p.By) {
              y = 0;
              ++z;
            }
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __reduce_min_sync(0xffffffffu, lo[a]);
      hi[a] = __reduce_max_sync(0xffffffffu, hi[a]);
    }
    cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        atomicMin(&s_box[a], lo[a]);
        atomicMax(&s_box[3 + a], hi[a]);
      }
      atomicAdd(&s_box[6], cnt);
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.counts[p.count_slot] = s_box[6];
  // box in (x, y, z): lo * brick_vox / n, min(hi + 1 ..., 1)
  const float bv = (float)p.brick_vox;
  const float inv_n[3] = {p.inv_X, p.inv_Y, p.inv_Z};
  float box_lo[3], box_hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ax = 2 - a;  // x <- brick axis 2, z <- brick axis 0
    box_lo[a] = __fmul_rn(__fmul_rn((float)s_box[ax], bv), inv_n[a]);
    const float h =
        __fmul_rn(__fmul_rn((float)(s_box[3 + ax] + 1), bv), inv_n[a]);
    box_hi[a] = h != h ? h : fminf(h, 1.0f);
  }

  constexpr int L = SCAN_LANES;
  static_assert(L >= 1 && L <= 16 && (L & (L - 1)) == 0,
                "SCAN_LANES: a power of two up to 16");
  constexpr int RAYS_A_STEP = THREADS / L;
  const int lane = threadIdx.x % L;
  // the lanes of this ray in its warp
  const unsigned group = ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int run = (p.n_scan + L - 1) / L;
  const int k_begin = min(lane * run, p.n_scan);
  const int k_end = min(k_begin + run, p.n_scan);
  const int rays = p.Hs * p.Ws, plane = rays;
  const int half = p.ds / 2;
  const float e[3] = {__ldg(p.eye), __ldg(p.eye + 1), __ldg(p.eye + 2)};
  const int n_dim[3] = {p.X, p.Y, p.Z};
  const int nb_dim[3] = {p.Bx, p.By, p.Bz};
  // v // brick_vox for 0 <= v < 2^31 as (v * magic) >> shift, magic =
  // ceil(2^shift / brick_vox), shift = 31 + ceil(log2 brick_vox): exact,
  // since (magic * brick_vox - 2^shift) * v < brick_vox * 2^31 <= 2^shift
  const unsigned shift = 31u + (32u - __clz(p.brick_vox - 1));
  const unsigned long long magic =
      ((1ull << shift) + (unsigned long long)(p.brick_vox - 1)) /
      (unsigned long long)p.brick_vox;
  for (int ray = blockIdx.x * RAYS_A_STEP + threadIdx.x / L; ray < rays;
       ray += gridDim.x * RAYS_A_STEP) {
    const int i = ray / p.Ws, j = ray % p.Ws;
    float d[3];
    ray_dir(p, half + p.ds * p.sc * i, half + p.ds * p.sc * j, d);
    float l[3], h[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float inv = __frcp_rn(d[a]);  // 1 / d, correctly rounded
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
    // this lane's run; a sample outside the interval leaves the fold as
    // it is (its candidates are the identities inf, -inf, inf)
    float first = INFINITY, last = -INFINITY, fsurf = INFINITY;
    if (valid) {
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k) {
        const float t = __fadd_rn(s0, __fmul_rn((float)k, spacing));
        if (!(t <= s1)) continue;
        int bi[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float c = __fmul_rn(__fadd_rn(e[a], __fmul_rn(d[a], t)),
                                    (float)n_dim[a]);
          // (int)c // brick_vox clamped to the grid: a negative index is
          // brick 0, a non-negative one divided by the magic product
          const unsigned long long v = (unsigned long long)max((int)c, 0);
          bi[a] = min((int)((v * magic) >> shift), nb_dim[a] - 1);
        }
        const int idx = (bi[2] * p.By + bi[1]) * p.Bx + bi[0];
        const int code =
            STAGED ? (int)s_code[idx] : brick_code(p.occ[idx], p.bsafe[idx]);
        if (code <= 0) first = fold_min(first, t);
        if (code < 0) {
          last = fold_max(last, t);
          fsurf = fold_min(fsurf, t);
        }
      }
    }
    // the runs, lower samples on the left
#pragma unroll
    for (int s = 1; s < L; s <<= 1) {
      const float f = __shfl_down_sync(group, first, s, L);
      const float la = __shfl_down_sync(group, last, s, L);
      const float fs = __shfl_down_sync(group, fsurf, s, L);
      if (lane % (2 * s) == 0) {
        first = fold_min(first, f);
        last = fold_max(last, la);
        fsurf = fold_min(fsurf, fs);
      }
    }
    if (lane == 0) {
      p.scan5[ray] = first;
      p.scan5[plane + ray] = last;
      p.scan5[2 * plane + ray] = fsurf;
      p.scan5[3 * plane + ray] = s0;
      p.scan5[4 * plane + ray] = valid ? s1 : 0.0f;
    }
  }
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
// A thread block of (ds, ds, slots) threads: a block slot's B2 = ds^2 rays
// are one lane group (threadIdx.x the ray's column in its block, .y its
// row, .z the slot), BRACKET_THREADS / B2 slots a thread block (at most
// BRACKET_MAX_SLOTS, blockDim.z's limit; B2 at most 1024, the wrapper
// refuses a larger one). The slot's work runs once:
//  1. a thread a slot reads its block index and derives its row and column
//     (the one division);
//  2. the block's 27 window taps of the three grids (edge-clamped, row-major
//     from the centre's row above) and its interval columns (blk's start
//     and length, s_end, the flags) staged into shared memory, a word a
//     thread, only for live slots (a padding slot's rows need none);
//  3. a thread a slot folds the pools in pool3's order (the centre, then
//     the 9 taps row-major, t_min / t_max: the same bits as the sequential
//     pool3) and computes f_start, len_brkt and len_full;
//  4. a thread a ray: its direction and its start point, its 32-byte row
//     staged in shared memory; the thread block's rows, contiguous in
//     ray8, then stored as float4 words by consecutive threads: whole
//     lines (two float4 stores a thread straight to its row measured
//     slower: bench/bracket_morph_variants.py).
// Bound: bytes, most of them the rows written (5.9 of the cells' 6.2 MB).
// Shared memory is dynamic: 32 bytes a thread for the rows, 160 a slot.
constexpr int BRACKET_THREADS = 256;
constexpr int BRACKET_MAX_SLOTS = 64;
constexpr int BRACKET_MAX_B2 = 1024;
// staged words a slot: 27 taps, s_start, length, s_end, the flags; the
// stride 33 keeps step 3's threads (a slot each) on distinct banks
constexpr int SLOT_WORDS = 32;
constexpr int SLOT_STRIDE = SLOT_WORDS + 1;
// shared bytes a slot: block, row, column, live; the taps; the start and
// lengths
constexpr int SLOT_BYTES = 4 * 4 + SLOT_STRIDE * 4 + 3 * 4;

// block slots a thread block of the launch
int bracket_slots(int B2) {
  const int s = B2 > 0 ? BRACKET_THREADS / B2 : 1;
  return s < 1 ? 1 : (s > BRACKET_MAX_SLOTS ? BRACKET_MAX_SLOTS : s);
}

__global__ void __launch_bounds__(BRACKET_MAX_B2)
    bracket_kernel(RenderParams p) {
  const int slots = blockDim.z;
  const int nthreads = blockDim.x * blockDim.y * slots;
  extern __shared__ float4 s_dyn[];
  float4* s_rows = s_dyn;  // 2 words a thread
  int(*s_blk)[4] = reinterpret_cast<int(*)[4]>(s_rows + 2 * nthreads);
  float* s_tap = reinterpret_cast<float*>(s_blk + slots);
  float(*s_ray)[3] =
      reinterpret_cast<float(*)[3]>(s_tap + slots * SLOT_STRIDE);
  const int tid =
      (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int slot0 = blockIdx.x * slots;
  // 1. a slot's block (the padding's: block NB - 1, whose directions its
  //    rows carry)
  if (tid < slots) {
    const int slot = slot0 + tid;
    int b = p.NB - 1, live = 0;
    if (slot < p.capB) {
      const long long bid = __ldg(p.blk_idx + slot);
      live = bid < p.NB;
      b = live ? (int)bid : p.NB - 1;
    }
    const int by = b / p.Wb;
    s_blk[tid][0] = b;
    s_blk[tid][1] = by;
    s_blk[tid][2] = b - by * p.Wb;
    s_blk[tid][3] = live;
  }
  __syncthreads();
  // 2. the live slots' taps and interval columns, a word a thread
  for (int i = tid; i < slots * SLOT_WORDS; i += nthreads) {
    const int s = i / SLOT_WORDS, t = i % SLOT_WORDS;
    if (!s_blk[s][3] || t > 30) continue;
    const int b = s_blk[s][0];
    float v;
    if (t < 27) {
      const int g = t / 9, w = t - 9 * g, dy = w / 3, dx = w - 3 * dy;
      const int y = clampi(s_blk[s][1] + dy - 1, 0, p.Hb - 1);
      const int x = clampi(s_blk[s][2] + dx - 1, 0, p.Wb - 1);
      v = __ldg(p.grid + (long long)g * p.NB + y * p.Wb + x);
    } else if (t == 27) {
      v = __ldg(p.blk + (long long)b * 8 + 7);
    } else if (t == 28) {
      v = __ldg(p.blk + (long long)b * 8 + 6);
    } else if (t == 29) {
      v = __ldg(p.s_end + b);
    } else {
      v = __int_as_float((int)p.bflags[b]);
    }
    s_tap[s * SLOT_STRIDE + t] = v;
  }
  __syncthreads();
  // 3. a thread a slot: the pools (pool3's order), the bracket
  if (tid < slots) {
    float start = 0.0f, len_full = 0.0f, len_brkt = 0.0f;
    if (s_blk[tid][3]) {
      const float* tp = s_tap + tid * SLOT_STRIDE;
      float all = tp[4], lo9 = tp[9 + 4], hi9 = tp[18 + 4];
#pragma unroll
      for (int w = 0; w < 9; ++w) {
        all = t_min(all, tp[w]);
        lo9 = t_min(lo9, tp[9 + w]);
        hi9 = t_max(hi9, tp[18 + w]);
      }
      const bool all9 = all > 0.5f;
      const float s_start = tp[27], length = tp[28], s_end = tp[29];
      const bool found = (__float_as_int(tp[30]) & 2) != 0;
      const bool ok = all9 && (__fsub_rn(hi9, lo9) < p.bracket_max) &&
                      (__fsub_rn(lo9, s_start) < p.lo_gap);
      float b_lo, b_hi;
      if (p.per_block) {
        // the block's own coarse bracket: its window's centre taps
        const float spread = __fmul_rn(__fsub_rn(hi9, lo9), 0.125f);
        const float lo_b = tp[9 + 4], hi_b = tp[18 + 4];
        b_lo = __fsub_rn(
            __fsub_rn(is_finite(lo_b) ? lo_b : s_start, p.margin), spread);
        b_hi = __fadd_rn(
            __fadd_rn(is_finite(hi_b) ? hi_b : s_end, p.margin), spread);
      } else {
        b_lo = __fsub_rn(lo9, p.margin);
        b_hi = __fadd_rn(hi9, p.margin);
      }
      start = ok ? t_max(b_lo, s_start) : s_start;
      len_brkt = (found && ok)
                     ? clamp_min0(__fsub_rn(t_min(b_hi, s_end), start))
                     : length;
      len_full = clamp_min0(found ? __fsub_rn(s_end, start) : 0.0f);
    }
    s_ray[tid][0] = start;
    s_ray[tid][1] = len_full;
    s_ray[tid][2] = len_brkt;
  }
  __syncthreads();
  // 4. a thread a ray, its row staged; the thread block's rows (contiguous
  //    in ray8) stored as whole lines
  const int s = threadIdx.z, slot = slot0 + s;
  if (slot < p.capB) {
    float d[3];
    ray_dir(p, s_blk[s][1] * p.ds + threadIdx.y,
            s_blk[s][2] * p.ds + threadIdx.x, d);
    const float start = s_ray[s][0];
    float pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      pos[a] = __fadd_rn(__ldg(p.eye + a), __fmul_rn(d[a], start));
    s_rows[2 * tid] = make_float4(pos[0], pos[1], pos[2], d[0]);
    s_rows[2 * tid + 1] = make_float4(d[1], d[2], s_ray[s][1], s_ray[s][2]);
  }
  __syncthreads();
  const int words = 2 * min(slots, p.capB - slot0) * p.B2;
  float4* rows = reinterpret_cast<float4*>(p.ray8) + 2LL * slot0 * p.B2;
  for (int i = tid; i < words; i += nthreads) rows[i] = s_rows[i];
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
// The scan's launch: {blocks, threads, lanes a ray, dynamic shared bytes,
// 1 if the brick grid is staged in shared memory}. The grid is
// SCAN_BLOCKS_PER_SM blocks an SM, fewer when the rays fill fewer, and one
// block without rays (the surface-brick count is written all the same).
int rgbd_render_scan_plan(const void* params, int* out) {
  const RenderParams& p = *(const RenderParams*)params;
  const long long rays = (long long)p.Hs * p.Ws;
  const long long nb = (long long)p.Bz * p.By * p.Bx;
  const int per_block = THREADS / SCAN_LANES;
  long long blocks = (rays + per_block - 1) / per_block;
  const long long cap = (long long)(p.sms > 0 ? p.sms : 1) * SCAN_BLOCKS_PER_SM;
  blocks = blocks < cap ? blocks : cap;
  const bool staged = nb <= SCAN_TABLE_MAX;
  out[0] = blocks > 0 ? (int)blocks : 1;
  out[1] = THREADS;
  out[2] = SCAN_LANES;
  out[3] = staged ? (int)((nb + 15) / 16 * 16) : 0;
  out[4] = staged;
  return 0;
}

int rgbd_render_scan(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  int plan[5];
  rgbd_render_scan_plan(params, plan);
  cudaStream_t s = (cudaStream_t)stream;
  if (plan[4]) {
    if (plan[3] > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          plan[3]);
      if (err != cudaSuccess) return (int)err;
    }
    scan_kernel<true><<<plan[0], THREADS, plan[3], s>>>(p);
  } else {
    scan_kernel<false><<<plan[0], THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

int rgbd_render_block_setup(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  const int blocks = blocks_for(p.NB);
  if (blocks == 0) return 0;
  block_setup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The bracket's launch: {blocks, threads x, y, z (the ray's column, its
// row, the slot), dynamic shared bytes}; blocks 0 without slots.
int rgbd_render_bracket_plan(const void* params, int* out) {
  const RenderParams& p = *(const RenderParams*)params;
  const int slots = bracket_slots(p.B2);
  out[0] = p.capB > 0 ? (p.capB + slots - 1) / slots : 0;
  out[1] = p.ds;
  out[2] = p.ds;
  out[3] = slots;
  out[4] = p.B2 * slots * 32 + slots * SLOT_BYTES;
  return 0;
}

int rgbd_render_bracket(const void* params, void* stream) {
  const RenderParams& p = *(const RenderParams*)params;
  if (p.B2 != p.ds * p.ds || p.B2 < 1 || p.B2 > BRACKET_MAX_B2)
    return (int)cudaErrorInvalidValue;
  int plan[5];
  rgbd_render_bracket_plan(params, plan);
  if (plan[0] == 0) return 0;
  bracket_kernel<<<plan[0], dim3(plan[1], plan[2], plan[3]), plan[4],
                   (cudaStream_t)stream>>>(p);
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
