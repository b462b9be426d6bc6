// The render's per-hit stage: one launch refines every hit, one launch
// shades every hit, one thread a hit in each.
//
// Replaces the hit path of the render: in the JAX package the part of the
// one jitted render program at rgbd_recon_tpu/recon/tsdf_pipeline.py:
// 1486-1505 (the refine, then _shade_hits at :695; raymarch.py:409
// oct_refine_crossing, :809 refine_crossing, :312 OctVolume.gradient_p,
// :852 gradient_normal, :1035 blend_colors_analytic, :1119 blend_colors,
// :950 blend_colors_fast, :1307 shade; no Pallas kernel), in the port its
// plain PyTorch twins (ops/hits.py refine_hits_plain and shade_hits_plain:
// ~1,000 launches a fast render, ~2,000 a parity render).
//
// hit_refine, per hit (ops/raymarch.py oct_refine_crossing and
// refine_crossing): a hit that is not live keeps its march position. From
// the oct cell-corner table: the secant of the bracket's ends, or with the
// widened bracket K samples over [lo - w, hi + w], the first rising sign
// change and two secant iterations; from the march table: the secant of
// the bracket's ends on pair_trilinear samples, each tap clamped from
// below by the floor where one is given. The position of an unconfirmed
// crossing is the march's.
//
// hit_shade, per hit (ops/hits.py shade_hits_plain): the normal (the oct
// cell's analytic gradient with its toward-camera fallback off the table,
// or the central difference of the march table at +-step, nearest or
// trilinear taps, clamped by the floor), divided by the box size and
// normalised; the world and view positions; the blend over the N sensors
// (the analytic projection models with the bf16-rounded colour map and
// nearest or bilinear depth/quality taps; the calibration volumes with
// trilinear lookups and f32 bilinear fetches; or their nearest lookups
// with the bf16 colour map and pair_bilinear fetches); shade modes 0
// (textured), 1 (Blinn-Phong), 2 (normals); the window depth. A hit that
// is not live gets rgba 0 and window depth 1.
//
// Numerics: exactly the twins' operations on the card, in their order
// (IEEE f32, no FMA contraction: the library is compiled with --fmad=false
// and without fast math, and every product and sum is an explicit
// round-to-nearest intrinsic), with PyTorch's CUDA rules where they differ
// from the written formula:
//  - x / s for a Python number s is x * (1 / s), the reciprocal taken in
//    f32 on the host (the wrapper passes it): the widened bracket's
//    k / (K - 1) and span / (K - 1), the window depth's scale;
//  - s / x is reciprocal(x) * s;
//  - a sum over a last axis of 3 adds lanes 0 and 2, then lane 1 (the
//    reduction splits 3 inputs over 2 lanes): sum3 below, for every norm
//    and dot product;
//  - x.to(bfloat16) rounds to nearest even (__float2bfloat16_rn);
//  - the view transform's f32 product v @ rot (cuBLAS, TF32 off) is, for
//    each output, a chain of fused multiply-adds over v's components in
//    order, from v[0] * rot[0][j]: the intrinsics below.
//
// Bound on this card: bytes. Each hit reads a few texels of the oct or
// march table and, per sensor, a few of the colour, depth and quality maps
// (and of the calibration volumes), all gathered; the arithmetic is a few
// hundred f32 operations a hit. What sets the time is the chain of
// dependent gathers and the load instructions that issue them: each
// gather's address depends on the one before (a projection, or a lookup of
// cv_inv, then of cv_uv at its result, then the maps' taps), sensor after
// sensor.
//
// Design, common to both: one thread a hit, 128 threads a block (the
// cells' 101,376 hit slots are one wave of the card); every table and map
// read in place through the read-only path (__ldg), bf16 entries shifted
// into an f32 (exact, as the twin's .to(float32)); an oct row's 8 corners
// one 16-byte load (two in f32), shared by the refine and the shade; the
// colour map read as f32 and rounded to bf16 in registers (no per-call
// bf16 copy), depth and quality read from their own planes through their
// strides (no per-call stack), the camera and the box's minimum read from
// their device tensors (no upload, no sync); the per-hit inputs read in
// place, so the render's column views need no copy. The render
// compacts the hits of 4x4 screen blocks next to each other, so
// neighbouring hits read neighbouring texels and share sectors.
//
// hit_refine: what sets its time is the chain of dependent loads a hit
// waits on, so each round of loads is issued whole:
//  - the ray and bracket: where they are columns 0-7 of one row-major
//    (n, 8) f32 tensor on 16 bytes (the render's hit rows; the wrapper
//    finds it), two float4 loads issued with the live byte, before the
//    live test (a dead hit's row is in bounds); any other layout, the
//    strided scalar loads, only for a live hit;
//  - an oct row (8 corners, 16 bytes in bf16, 32 in f32) one uint4 or two
//    float4 loads (the wrapper checks the table's 16-byte alignment), its
//    brick and local index by a multiply and a shift in place of runtime
//    divisions by brick_vox (exact below 2^31, Divisor below);
//  - the widened bracket's K samples in chunks of REFINE_CHUNK: every
//    sample's position, then every sample's slot load, then every row
//    load, and only then the test for the first rising sign change, after
//    each chunk (the cells' K = 8 is two chunks; their first rise lies at
//    samples 3-5). The same bits as one sample after the other with a
//    break: each d_k is the same function of the same inputs, and the
//    first k with d_k > 0 and d_k-1 <= 0 the same k (a NaN fails both
//    tests). A chunk of 8 held 119 registers, so the cells' 792 blocks
//    took two waves, and measured slower, as did 8 under a bound of 80
//    registers (spills);
//  - the bracket's two ends (the oct table without widening, or the march
//    table's pair_trilinear taps) sampled the same way: both samples'
//    loads (2 slots and 2 rows, or 16 table entries) before the first
//    lerp (the SASS of refine_kernel<float> issues the march table's 16
//    loads, then its first lerp);
//  - the march's position read only where it is the result (not live, or
//    the crossing not confirmed).
// A hit's samples spread over lanes of a warp (a sample a lane, the first
// rising pair by a ballot) measured slower: bench/setup_refine_variants.py.
//
// hit_shade: the sensors are folded one after the other into the sums in
// sensor order from 0.0f, as the twins' loop adds them. Each sensor's
// gathers take as few load instructions as the layouts allow:
//  - the projection models of every sensor (analytic blend) are staged
//    once a block in shared memory as a 16-byte aligned record a sensor
//    (MODEL_FLOATS), read as seven float4 in place of 26 loads;
//  - a calibration-volume tap's 4 (cv_inv) or 2 (cv_uv) channels are one
//    float4 / float2 load (the wrapper checks the volumes' 16- and 8-byte
//    alignment); each channel's lerps keep their order;
//  - a map's four taps' addresses are taken once for all its channels;
//    the colour map's 3-channel texels stay scalar loads.
// A hit's sensors spread over lanes of a warp, or gathered together in one
// thread, cost more than they hide: the lanes repeat the hit's own work
// (its normal, its view transform) and add the fold's shuffles, the
// gathered sensors the registers of a second wave. Reciprocals 1 / x are
// __frcp_rn (the bits of the IEEE division). A hit that is not live reads
// nothing more than its live byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// refine inputs: pos0 x y z, dir x y z, lo_t, hi_t, hit_pos x y z
constexpr int REFINE_IN = 11;
constexpr int NORMAL_OCT = 0, NORMAL_NEAREST = 1, NORMAL_TRILINEAR = 2;
constexpr int BLEND_ANALYTIC = 0, BLEND_VOLUME = 1, BLEND_VOLUME_FAST = 2;

struct RefineParams {
  const void* table;  // oct rows (M, 8) or the (D, H, W) march table
  const int* slots;   // oct: flat brick id -> slot, -1 off the table
  int table_f32;      // 1: f32 entries, 0: bf16
  int oct;            // 1: the oct table, 0: the march table
  int D, H, W;        // the volume's shape
  int brick_vox;      // oct
  int widen_k;        // oct: 0 the bracket's ends, >= 3 the widened window
  int floor_on;       // march table: clamp each tap from below by floor
  float neg_limit;    // oct: the value off the table, -limit
  float floor;
  float widen_lo;     // f32(widen_steps * sd)
  float widen_span;   // f32(2 * widen_steps * sd)
  float inv_km1;      // f32(1) / f32(K - 1)
  const float* in[REFINE_IN];
  long long stride[REFINE_IN];
  const unsigned char* hit;
  long long hit_stride;
  float* out;  // (n, 3)
  int n;
  // in[0..7] as the rows of one (n, 8) f32 tensor on 16 bytes, else null
  const float* rows8;
};

struct ShadeParams {
  const unsigned char* hit;
  long long hit_stride;
  const float* pos[3];  // the hit position, volume-normalised
  long long pos_stride[3];
  int n;
  // the normal
  int normal;
  const void* table;  // oct rows or the march table
  const int* slots;
  int table_f32;
  int D, H, W;
  int brick_vox;
  int floor_on;
  float floor;
  float sd;  // the gradient's step, f32(limit) * 0.5
  // the blend
  int blend;
  int dq_bilinear;
  int N;
  const float* color;  // (N, Hc, Wc, 3) f32
  long long color_stride[4];
  int Hc, Wc;
  const float* depth;  // (N, Hd, Wd) normalised depth
  long long depth_stride[3];
  const float* quality;  // (N, Hd, Wd)
  long long quality_stride[3];
  int Hd, Wd;
  // the projection models, contiguous: (N, 2, 3), (N, 2), (N, 3), (N, 3),
  // (N,), (N, 2, 3), (N, 2), (N, 3)
  const float* uv_num;
  const float* uv_off;
  const float* uv_den;
  const float* d_lin;
  const float* d_off;
  const float* cuv_num;
  const float* cuv_off;
  const float* cuv_den;
  const float* cv_inv;  // (N, iD, iH, iW, 4), contiguous
  int iD, iH, iW;
  const float* cv_uv;  // (N, uD, uH, uW, 2), contiguous
  int uD, uH, uW;
  float limit;
  // shading and the window depth
  int shade_mode;
  const float* eye;       // (3,) world eye
  const float* rot;       // (3, 3) camera-to-world rotation, row-major
  const float* bbox_min;  // (3,)
  float bbox_size[3];
  float near_clamp;   // f32(near * 1.001)
  float inv_near;     // f32(1 / near)
  float depth_scale;  // f32(1) / f32(1 / near - 1 / far)
  float* rgba;        // (n, 4)
  float* depth_win;   // (n,)
};

__device__ __forceinline__ float load_entry(const float* t, long long i) {
  return __ldg(t + i);
}

__device__ __forceinline__ float load_entry(const unsigned short* t,
                                            long long i) {
  return __uint_as_float(((unsigned int)__ldg(t + i)) << 16);
}

__device__ __forceinline__ int clamp_idx(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// 1 / b, correctly rounded (the bits of dvd(1.0f, b))
__device__ __forceinline__ float rcp(float b) { return __frcp_rn(b); }

// a + b * t: the twins' position along a ray (a product, then a sum)
__device__ __forceinline__ float along(float a, float b, float t) {
  return add(a, mul(b, t));
}

// a * (1 - f) + b * f: every lerp of the twins
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return add(mul(a, sub(1.0f, f)), mul(b, f));
}

// x.sum(dim=-1) over 3 lanes on the card: lanes 0 and 2, then lane 1,
// each from +0.0
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(add(0.0f, a), add(0.0f, c)), add(0.0f, b));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(sum3(mul(x, x), mul(y, y), mul(z, z)));
}

// x / max(|x|, 1e-20), the twins' _unit
__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = clamp_min(norm3(x, y, z), 1e-20f);
  x = dvd(x, n);
  y = dvd(y, n);
  z = dvd(z, n);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ops/raymarch.py _secant_den
__device__ __forceinline__ float secant_den(float d) {
  return fabsf(d) < 1e-20f ? 1e-20f : d;
}

// v // d for 0 <= v < 2^31 as (v * magic) >> shift, magic =
// ceil(2^shift / d), shift = 31 + ceil(log2 d): exact, since
// (magic * d - 2^shift) * v < d * 2^31 <= 2^shift
struct Divisor {
  unsigned long long magic;
  unsigned shift;
};

Divisor divisor(int d) {
  if (d < 1) d = 1;  // no oct table: brick_vox unused
  unsigned l = 0;
  while ((1ll << l) < (long long)d) ++l;
  Divisor q;
  q.shift = 31u + l;
  q.magic = ((1ull << q.shift) + (unsigned long long)(d - 1)) /
            (unsigned long long)d;
  return q;
}

__device__ __forceinline__ int div_by(int v, const Divisor& q) {
  return (int)(((unsigned long long)v * q.magic) >> q.shift);
}

// ---- the march table ------------------------------------------------------

// ops/raymarch.py sample_nearest_p, then clamp_min(floor) where floor_on
template <typename T>
__device__ float table_nearest(const T* table, float px, float py, float pz,
                               int D, int H, int W, int floor_on,
                               float floor) {
  const int xi = clamp_idx((int)mul(px, (float)W), W);
  const int yi = clamp_idx((int)mul(py, (float)H), H);
  const int zi = clamp_idx((int)mul(pz, (float)D), D);
  const float v = load_entry(table, ((long long)zi * H + yi) * W + xi);
  return floor_on ? clamp_min(v, floor) : v;
}

// ops/sampling.py pair_trilinear's taps: the 4 (z, y) rows' x pairs
struct TriTaps {
  long long base[4];
  int x0, x1;
  float fx, fy, fz;
};

__device__ __forceinline__ TriTaps trilinear_taps(float px, float py,
                                                  float pz, int D, int H,
                                                  int W) {
  TriTaps t;
  const float cx = sub(mul(px, (float)W), 0.5f);
  const float cy = sub(mul(py, (float)H), 0.5f);
  const float cz = sub(mul(pz, (float)D), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy), z0f = floorf(cz);
  t.fx = x0f < 0.0f ? 0.0f : sub(cx, x0f);
  t.fy = sub(cy, y0f);
  t.fz = sub(cz, z0f);
  t.x0 = clamp_idx((int)x0f, W);
  t.x1 = min(t.x0 + 1, W - 1);
  const int y0 = clamp_idx((int)y0f, H);
  const int y1 = clamp_idx((int)add(y0f, 1.0f), H);
  const int z0 = clamp_idx((int)z0f, D);
  const int z1 = clamp_idx((int)add(z0f, 1.0f), D);
  const int zs[4] = {z0, z0, z1, z1};
  const int ys[4] = {y0, y1, y0, y1};
#pragma unroll
  for (int k = 0; k < 4; ++k) t.base[k] = ((long long)zs[k] * H + ys[k]) * W;
  return t;
}

// the taps' 8 entries: pair k's x0 and x1 at 2k and 2k + 1
template <typename T>
__device__ __forceinline__ void trilinear_load(const T* table,
                                               const TriTaps& t, float e[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[2 * k] = load_entry(table, t.base[k] + t.x0);
    e[2 * k + 1] = load_entry(table, t.base[k] + t.x1);
  }
}

// pair_trilinear's value of the loaded taps, each clamped from below by
// floor where floor_on
__device__ __forceinline__ float trilinear_value(const TriTaps& t,
                                                 const float e[8],
                                                 int floor_on, float floor) {
  float pair[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float a = e[2 * k], b = e[2 * k + 1];
    if (floor_on) {
      a = clamp_min(a, floor);
      b = clamp_min(b, floor);
    }
    pair[k] = lerp(a, b, t.fx);
  }
  return lerp(lerp(pair[0], pair[1], t.fy), lerp(pair[2], pair[3], t.fy),
              t.fz);
}

// ops/sampling.py pair_trilinear with its clamp floor
template <typename T>
__device__ float table_trilinear(const T* table, float px, float py, float pz,
                                 int D, int H, int W, int floor_on,
                                 float floor) {
  const TriTaps t = trilinear_taps(px, py, pz, D, H, W);
  float e[8];
  trilinear_load(table, t, e);
  return trilinear_value(t, e, floor_on, floor);
}

// ---- the oct cell-corner table ---------------------------------------------

struct Cell {
  float c[8];
  float fx, fy, fz;
  bool valid;
};

// an anchor cell's place: its fractions, its brick's flat id and the
// cell's index in the brick
struct CellAt {
  float fx, fy, fz;
  int bid, local;
};

// ops/raymarch.py OctVolume._cells up to the slot lookup; q divides by
// the brick edge v
__device__ __forceinline__ CellAt oct_locate(float px, float py, float pz,
                                             int D, int H, int W, int v,
                                             const Divisor& q) {
  CellAt at;
  const float cx = sub(mul(px, (float)W), 0.5f);
  const float cy = sub(mul(py, (float)H), 0.5f);
  const float cz = sub(mul(pz, (float)D), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy), z0f = floorf(cz);
  at.fx = x0f < 0.0f ? 0.0f : clamp_to(sub(cx, x0f), 0.0f, 1.0f);
  at.fy = y0f < 0.0f ? 0.0f : clamp_to(sub(cy, y0f), 0.0f, 1.0f);
  at.fz = z0f < 0.0f ? 0.0f : clamp_to(sub(cz, z0f), 0.0f, 1.0f);
  const int x0 = clamp_idx((int)x0f, W);
  const int y0 = clamp_idx((int)y0f, H);
  const int z0 = clamp_idx((int)z0f, D);
  const int bx = div_by(x0, q), by = div_by(y0, q), bz = div_by(z0, q);
  at.bid = (bz * div_by(H, q) + by) * div_by(W, q) + bx;
  at.local = ((z0 - bz * v) * v + (y0 - by * v)) * v + (x0 - bx * v);
  return at;
}

// an oct row's 8 corners in one load: 16 bytes of bf16, or two float4
__device__ __forceinline__ void load_row(const float* rows, long long row,
                                         float c[8]) {
  const float4* r = reinterpret_cast<const float4*>(rows) + 2 * row;
  const float4 lo = __ldg(r), hi = __ldg(r + 1);
  c[0] = lo.x;
  c[1] = lo.y;
  c[2] = lo.z;
  c[3] = lo.w;
  c[4] = hi.x;
  c[5] = hi.y;
  c[6] = hi.z;
  c[7] = hi.w;
}

__device__ __forceinline__ void load_row(const unsigned short* rows,
                                         long long row, float c[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(rows) + row);
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[2 * k] = __uint_as_float(u[k] << 16);
    c[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// OctVolume.sample_p's lerps of a valid cell
__device__ __forceinline__ float cell_value(const float c[8], float fx,
                                            float fy, float fz) {
  const float c00 = lerp(c[0], c[1], fx);
  const float c01 = lerp(c[2], c[3], fx);
  const float c10 = lerp(c[4], c[5], fx);
  const float c11 = lerp(c[6], c[7], fx);
  return lerp(lerp(c00, c01, fy), lerp(c10, c11, fy), fz);
}

// ops/raymarch.py OctVolume._cells: the anchor cell's eight corners
template <typename T>
__device__ Cell oct_cell(const T* rows, const int* slots, float px, float py,
                         float pz, int D, int H, int W, int v,
                         const Divisor& q) {
  const CellAt at = oct_locate(px, py, pz, D, H, W, v, q);
  Cell cell;
  cell.fx = at.fx;
  cell.fy = at.fy;
  cell.fz = at.fz;
  const int slot = __ldg(slots + at.bid);
  cell.valid = slot >= 0;
  if (cell.valid) {
    load_row(rows, (long long)slot * (v * v * v) + at.local, cell.c);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) cell.c[k] = 0.0f;
  }
  return cell;
}

// OctVolume.sample_p of N positions (those below n): every position,
// then every slot load, then every row load, then the lerps; fill off
// the table
template <typename T, int N>
__device__ __forceinline__ void oct_samples(const T* rows, const int* slots,
                                            const float px[N],
                                            const float py[N],
                                            const float pz[N], int n, int D,
                                            int H, int W, int v,
                                            const Divisor& q, float fill,
                                            float out[N]) {
  CellAt at[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n) at[k] = oct_locate(px[k], py[k], pz[k], D, H, W, v, q);
  int slot[N];
#pragma unroll
  for (int k = 0; k < N; ++k) slot[k] = k < n ? __ldg(slots + at[k].bid) : -1;
  float c[N][8];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (slot[k] >= 0) {
      load_row(rows, (long long)slot[k] * (v * v * v) + at[k].local, c[k]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[k][j] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[k] = slot[k] >= 0 ? cell_value(c[k], at[k].fx, at[k].fy, at[k].fz)
                          : fill;
}

// ---- hit_refine -----------------------------------------------------------

// the widened bracket's samples a round of loads (a compile-time constant:
// 72 registers, 7 blocks of 128 an SM, the cells' 792 blocks one wave)
constexpr int REFINE_CHUNK = 4;

// the march's position, the result of a hit that is not live or whose
// bracket does not confirm the crossing: read only for those
__device__ __forceinline__ void keep_march_pos(const RefineParams& a,
                                               long long r, float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = __ldg(a.in[8 + k] + r * a.stride[8 + k]);
}

// a read-only float4 load issued where it is written (not moved past the
// live test that follows it)
__device__ __forceinline__ float4 ldg4_here(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// the oct table's samples (fill -limit off it) at t[0 .. n) along the ray
// (n <= N), every load of the N samples issued before the first lerp
template <typename T, int N>
__device__ __forceinline__ void oct_ray_samples(const RefineParams& a,
                                                const Divisor& q,
                                                const T* table,
                                                const float p0[3],
                                                const float dir[3],
                                                const float t[N], int n,
                                                float out[N]) {
  float px[N], py[N], pz[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    px[k] = along(p0[0], dir[0], t[k]);
    py[k] = along(p0[1], dir[1], t[k]);
    pz[k] = along(p0[2], dir[2], t[k]);
  }
  oct_samples<T, N>(table, a.slots, px, py, pz, n, a.D, a.H, a.W,
                    a.brick_vox, q, a.neg_limit, out);
}

// the bracket's two ends t[0], t[1]: the oct table's samples or the march
// table's pair_trilinear, both samples' loads (2 slots and 2 rows, or 16
// entries) issued before the first lerp
template <typename T>
__device__ __forceinline__ void end_samples(const RefineParams& a,
                                            const Divisor& q, const T* table,
                                            const float p0[3],
                                            const float dir[3],
                                            const float t[2], float out[2]) {
  if (a.oct) {
    oct_ray_samples<T, 2>(a, q, table, p0, dir, t, 2, out);
    return;
  }
  TriTaps taps[2];
  float e[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    taps[k] = trilinear_taps(along(p0[0], dir[0], t[k]),
                             along(p0[1], dir[1], t[k]),
                             along(p0[2], dir[2], t[k]), a.D, a.H, a.W);
#pragma unroll
  for (int k = 0; k < 2; ++k) trilinear_load(table, taps[k], e[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    out[k] = trilinear_value(taps[k], e[k], a.floor_on, a.floor);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    refine_kernel(const RefineParams a, const Divisor q) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long r = i;
  float* out = a.out + r * 3;
  // the live byte and, from one (n, 8) row, the ray and bracket: one round
  const bool live = __ldg(a.hit + r * a.hit_stride) != 0;
  float v[8];
  if (a.rows8) {
    const float4 lo = ldg4_here(a.rows8 + r * 8);
    const float4 hi = ldg4_here(a.rows8 + r * 8 + 4);
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = lo.z;
    v[3] = lo.w;
    v[4] = hi.x;
    v[5] = hi.y;
    v[6] = hi.z;
    v[7] = hi.w;
  }
  if (!live) {
    keep_march_pos(a, r, out);
    return;
  }
  if (!a.rows8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(a.in[k] + r * a.stride[k]);
  }
  const float p0[3] = {v[0], v[1], v[2]};
  const float dir[3] = {v[3], v[4], v[5]};
  const float lo = v[6], hi = v[7];
  const T* table = (const T*)a.table;
  float tstar;
  if (a.oct && a.widen_k >= 3) {
    // the widened bracket: K samples a chunk at a time, the first rising
    // sign change after each chunk
    const float span_lo = sub(lo, a.widen_lo);
    const float span = add(sub(hi, lo), a.widen_span);
    float prev = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
    int kstar = -1;
    for (int k0 = 0; k0 < a.widen_k && kstar < 0; k0 += REFINE_CHUNK) {
      float t[REFINE_CHUNK], d[REFINE_CHUNK];
#pragma unroll
      for (int c = 0; c < REFINE_CHUNK; ++c)
        t[c] = add(span_lo, mul(mul((float)(k0 + c), a.inv_km1), span));
      oct_ray_samples<T, REFINE_CHUNK>(a, q, table, p0, dir, t,
                                       a.widen_k - k0, d);
#pragma unroll
      for (int c = 0; c < REFINE_CHUNK; ++c) {
        const int k = k0 + c;
        if (k < a.widen_k && kstar < 0) {
          if (k > 0 && d[c] > 0.0f && prev <= 0.0f) {
            kstar = k - 1;
            d_lo = prev;
            d_hi = d[c];
          }
          prev = d[c];
        }
      }
    }
    if (kstar < 0) {
      keep_march_pos(a, r, out);
      return;
    }
    const float step = mul(span, a.inv_km1);
    const float t_lo = add(span_lo, mul((float)kstar, step));
    const float t_hi = add(t_lo, step);
    float ts[1] = {sub(t_hi, mul(sub(t_hi, t_lo),
                                 dvd(d_hi, secant_den(sub(d_hi, d_lo)))))};
    float dm[1];
    oct_ray_samples<T, 1>(a, q, table, p0, dir, ts, 1, dm);
    const bool up = dm[0] > 0.0f;
    const float t_lo2 = up ? t_lo : ts[0];
    const float d_lo2 = up ? d_lo : dm[0];
    const float t_hi2 = up ? ts[0] : t_hi;
    const float d_hi2 = up ? dm[0] : d_hi;
    tstar = sub(t_hi2, mul(sub(t_hi2, t_lo2),
                           dvd(d_hi2, secant_den(sub(d_hi2, d_lo2)))));
  } else {
    // the secant of the bracket's ends, both samples' loads in one round
    const float t[2] = {hi, lo};
    float d[2];
    end_samples<T>(a, q, table, p0, dir, t, d);
    const float v1 = d[0], v0 = d[1];
    if (!(v1 > 0.0f && v0 <= 0.0f)) {
      keep_march_pos(a, r, out);
      return;
    }
    tstar = sub(hi, mul(sub(hi, lo), dvd(v1, secant_den(sub(v1, v0)))));
  }
  out[0] = along(p0[0], dir[0], tstar);
  out[1] = along(p0[1], dir[1], tstar);
  out[2] = along(p0[2], dir[2], tstar);
}

// ---- hit_shade: the normal ------------------------------------------------

// OctVolume.gradient_p, negated and normalised; the toward-camera
// fallback off the table (ops/hits.py shade_hits_plain)
template <typename T>
__device__ void normal_oct(const ShadeParams& a, const Divisor& q,
                           const T* rows, float px, float py, float pz,
                           float g[3]) {
  const Cell e = oct_cell(rows, a.slots, px, py, pz, a.D, a.H, a.W,
                          a.brick_vox, q);
  if (e.valid) {
    const float* c = e.c;
    const float wx0 = sub(1.0f, e.fx), wx1 = e.fx;
    const float wy0 = sub(1.0f, e.fy), wy1 = e.fy;
    const float wz0 = sub(1.0f, e.fz), wz1 = e.fz;
    float gx = mul(sub(c[1], c[0]), wy0);
    gx = add(mul(gx, wz0), mul(mul(sub(c[3], c[2]), wy1), wz0));
    gx = add(gx, mul(mul(sub(c[5], c[4]), wy0), wz1));
    gx = add(gx, mul(mul(sub(c[7], c[6]), wy1), wz1));
    gx = mul(gx, (float)a.W);
    const float gy = mul(
        add(mul(add(mul(sub(c[2], c[0]), wx0), mul(sub(c[3], c[1]), wx1)),
                wz0),
            mul(add(mul(sub(c[6], c[4]), wx0), mul(sub(c[7], c[5]), wx1)),
                wz1)),
        (float)a.H);
    const float gz = mul(
        add(mul(add(mul(sub(c[4], c[0]), wx0), mul(sub(c[5], c[1]), wx1)),
                wy0),
            mul(add(mul(sub(c[6], c[2]), wx0), mul(sub(c[7], c[3]), wx1)),
                wy1)),
        (float)a.D);
    const float n = clamp_min(norm3(gx, gy, gz), 1e-20f);
    g[0] = dvd(-gx, n);
    g[1] = dvd(-gy, n);
    g[2] = dvd(-gz, n);
    return;
  }
  const float pos[3] = {px, py, pz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = sub(__ldg(a.eye + k),
                        add(mul(pos[k], a.bbox_size[k]),
                            __ldg(a.bbox_min + k)));
    g[k] = mul(w, a.bbox_size[k]);
  }
  unit3(g[0], g[1], g[2]);
}

// ops/raymarch.py gradient_normal: the central difference at +-sd
template <typename T>
__device__ void normal_table(const ShadeParams& a, const T* table, float px,
                             float py, float pz, float g[3]) {
  const float p[3] = {px, py, pz};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    float hi[3] = {p[0], p[1], p[2]};
    float lo[3] = {p[0], p[1], p[2]};
    hi[axis] = add(p[axis], a.sd);
    lo[axis] = sub(p[axis], a.sd);
    float s_hi, s_lo;
    if (a.normal == NORMAL_NEAREST) {
      s_hi = table_nearest(table, hi[0], hi[1], hi[2], a.D, a.H, a.W,
                           a.floor_on, a.floor);
      s_lo = table_nearest(table, lo[0], lo[1], lo[2], a.D, a.H, a.W,
                           a.floor_on, a.floor);
    } else {
      s_hi = table_trilinear(table, hi[0], hi[1], hi[2], a.D, a.H, a.W,
                             a.floor_on, a.floor);
      s_lo = table_trilinear(table, lo[0], lo[1], lo[2], a.D, a.H, a.W,
                             a.floor_on, a.floor);
    }
    g[axis] = sub(s_hi, s_lo);
  }
  const float n = clamp_min(norm3(g[0], g[1], g[2]), 1e-20f);
  g[0] = dvd(-g[0], n);
  g[1] = dvd(-g[1], n);
  g[2] = dvd(-g[2], n);
}

// ---- hit_shade: the sensor maps -------------------------------------------

struct Taps {
  int x0, x1, y0, y1;
  float fx, fy;
};

// ops/sampling.py quad_bilinear's taps: corners (x0|x0+1) x (y0|y0+1),
// each +1 tap clamped to the edge, zero weight toward a tap left of or
// above the first texel
__device__ __forceinline__ Taps quad_taps(float u, float v, int H, int W) {
  Taps t;
  const float cx = sub(mul(u, (float)W), 0.5f);
  const float cy = sub(mul(v, (float)H), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy);
  t.fx = x0f < 0.0f ? 0.0f : sub(cx, x0f);
  t.fy = y0f < 0.0f ? 0.0f : sub(cy, y0f);
  t.x0 = clamp_idx((int)x0f, W);
  t.y0 = clamp_idx((int)y0f, H);
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  return t;
}

// ops/sampling.py pair_bilinear's taps: the x pair of quad_bilinear, the
// y taps floor and floor + 1, each truncated and clamped
__device__ __forceinline__ Taps pair_taps(float u, float v, int H, int W) {
  Taps t;
  const float cx = sub(mul(u, (float)W), 0.5f);
  const float cy = sub(mul(v, (float)H), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy);
  t.fx = x0f < 0.0f ? 0.0f : sub(cx, x0f);
  t.fy = sub(cy, y0f);
  t.x0 = clamp_idx((int)x0f, W);
  t.x1 = min(t.x0 + 1, W - 1);
  t.y0 = clamp_idx((int)y0f, H);
  t.y1 = clamp_idx((int)add(y0f, 1.0f), H);
  return t;
}

// ops/sampling.py bilinear_2d's taps: floor and floor + 1 on both axes,
// each truncated and clamped, no zero weight
__device__ __forceinline__ Taps edge_taps(float u, float v, int H, int W) {
  Taps t;
  const float cx = sub(mul(u, (float)W), 0.5f);
  const float cy = sub(mul(v, (float)H), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy);
  t.fx = sub(cx, x0f);
  t.fy = sub(cy, y0f);
  t.x0 = clamp_idx((int)x0f, W);
  t.x1 = clamp_idx((int)add(x0f, 1.0f), W);
  t.y0 = clamp_idx((int)y0f, H);
  t.y1 = clamp_idx((int)add(y0f, 1.0f), H);
  return t;
}

// the four taps' texels of sensor i's map (strides s: sensor, row,
// column), corners (y0, x0), (y0, x1), (y1, x0), (y1, x1): their addresses
// taken once for every channel
struct Corners {
  const float* p[4];
};

__device__ __forceinline__ Corners corners(const float* m, const long long* s,
                                           int i, const Taps& t) {
  const float* base = m + i * s[0];
  const long long r0 = t.y0 * s[1], r1 = t.y1 * s[1];
  const long long c0 = t.x0 * s[2], c1 = t.x1 * s[2];
  return Corners{{base + r0 + c0, base + r0 + c1, base + r1 + c0,
                  base + r1 + c1}};
}

// the blend of the four taps at channel offset off, rounding each to bf16
// first where bf16 is set (the twins' colors.to(torch.bfloat16))
__device__ __forceinline__ float blend_taps(const Corners& q, long long off,
                                            const Taps& t, bool bf16) {
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = __ldg(q.p[k] + off);
    if (bf16) r[k] = bf16_round(r[k]);
  }
  return lerp(lerp(r[0], r[1], t.fx), lerp(r[2], r[3], t.fx), t.fy);
}

// the three colour channels of sensor i's (N, H, W, 3) map at the taps
__device__ __forceinline__ void blend_color(const ShadeParams& a, int i,
                                            const Taps& t, bool bf16,
                                            float col[3]) {
  const Corners q = corners(a.color, a.color_stride, i, t);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    col[j] = blend_taps(q, j * a.color_stride[3], t, bf16);
}

// calib/sensors.py ProjectionModels._projective: A (2, 3), b (2,), c (3,)
__device__ __forceinline__ void projective(const float A[6], const float b[2],
                                           const float c[3], float px,
                                           float py, float pz, float& u,
                                           float& v) {
  float den = add(add(add(mul(px, c[0]), mul(py, c[1])), mul(pz, c[2])),
                  1.0f);
  den = fabsf(den) < 1e-8f ? 1e-8f : den;
  const float inv = rcp(den);
  u = mul(add(add(add(mul(px, A[0]), mul(py, A[1])), mul(pz, A[2])), b[0]),
          inv);
  v = mul(add(add(add(mul(px, A[3]), mul(py, A[4])), mul(pz, A[5])), b[1]),
          inv);
}

// sensor i's projection models as the block stages them: a record of
// MODEL_FLOATS floats a sensor, 16-byte aligned, read as seven float4
// (uv_num 0-5, uv_off 6-7, uv_den 8-10, d_off 11, d_lin 12-14, cuv_num
// 16-21, cuv_off 22-23, cuv_den 24-26)
constexpr int MODEL_FLOATS = 28;

struct Models {
  float uv_num[6], uv_off[2], uv_den[3], d_lin[3], d_off;
  float cuv_num[6], cuv_off[2], cuv_den[3];
};

__device__ __forceinline__ Models load_models(const float* models, int i) {
  const float4* q =
      reinterpret_cast<const float4*>(models + i * MODEL_FLOATS);
  float r[MODEL_FLOATS];
#pragma unroll
  for (int k = 0; k < MODEL_FLOATS / 4; ++k) {
    const float4 v = q[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
  Models m;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    m.uv_num[k] = r[k];
    m.cuv_num[k] = r[16 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m.uv_den[k] = r[8 + k];
    m.d_lin[k] = r[12 + k];
    m.cuv_den[k] = r[24 + k];
  }
  m.uv_off[0] = r[6];
  m.uv_off[1] = r[7];
  m.d_off = r[11];
  m.cuv_off[0] = r[22];
  m.cuv_off[1] = r[23];
  return m;
}

// the block's record of every sensor's models (analytic blend), from the
// wrapper's (N, 2, 3), (N, 2), (N, 3), (N, 3), (N,), (N, 2, 3), (N, 2),
// (N, 3) tensors; the padding words are not read
__device__ void stage_models(const ShadeParams& a, float* models) {
  for (int k = threadIdx.x; k < a.N * MODEL_FLOATS; k += THREADS) {
    const int i = k / MODEL_FLOATS, f = k % MODEL_FLOATS;
    float v = 0.0f;
    if (f < 6) v = __ldg(a.uv_num + i * 6 + f);
    else if (f < 8) v = __ldg(a.uv_off + i * 2 + f - 6);
    else if (f < 11) v = __ldg(a.uv_den + i * 3 + f - 8);
    else if (f == 11) v = __ldg(a.d_off + i);
    else if (f < 15) v = __ldg(a.d_lin + i * 3 + f - 12);
    else if (f >= 16 && f < 22) v = __ldg(a.cuv_num + i * 6 + f - 16);
    else if (f >= 22 && f < 24) v = __ldg(a.cuv_off + i * 2 + f - 22);
    else if (f >= 24 && f < 27) v = __ldg(a.cuv_den + i * 3 + f - 24);
    models[k] = v;
  }
}

// a volume tap's C channels (C = 4: one float4 load, C = 2: one float2)
template <int C>
__device__ __forceinline__ void load_tap(const float* p, float* out);

template <>
__device__ __forceinline__ void load_tap<4>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_tap<2>(const float* p, float* out) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  out[0] = v.x;
  out[1] = v.y;
}

// trilinear_3d of sensor i's (D, H, W, C) volume at (x, y, z): the eight
// taps' channels, then each channel's lerps in the twin's order
template <int C>
__device__ void volume_trilinear(const float* vol, int i, int D, int H,
                                 int W, float x, float y, float z,
                                 float* out) {
  const float cx = sub(mul(x, (float)W), 0.5f);
  const float cy = sub(mul(y, (float)H), 0.5f);
  const float cz = sub(mul(z, (float)D), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy), z0f = floorf(cz);
  const float fx = sub(cx, x0f), fy = sub(cy, y0f), fz = sub(cz, z0f);
  const int xs[2] = {clamp_idx((int)x0f, W),
                     clamp_idx((int)add(x0f, 1.0f), W)};
  const int ys[2] = {clamp_idx((int)y0f, H),
                     clamp_idx((int)add(y0f, 1.0f), H)};
  const int zs[2] = {clamp_idx((int)z0f, D),
                     clamp_idx((int)add(z0f, 1.0f), D)};
  const float* base = vol + (long long)i * D * H * W * C;
  // tap[zz][yy][xx][ch]
  float tap[2][2][2][C];
#pragma unroll
  for (int zz = 0; zz < 2; ++zz)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
#pragma unroll
      for (int xx = 0; xx < 2; ++xx)
        load_tap<C>(
            base + (((long long)zs[zz] * H + ys[yy]) * W + xs[xx]) * C,
            tap[zz][yy][xx]);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float c00 = lerp(tap[0][0][0][ch], tap[0][0][1][ch], fx);
    const float c01 = lerp(tap[0][1][0][ch], tap[0][1][1][ch], fx);
    const float c10 = lerp(tap[1][0][0][ch], tap[1][0][1][ch], fx);
    const float c11 = lerp(tap[1][1][0][ch], tap[1][1][1][ch], fx);
    out[ch] = lerp(lerp(c00, c01, fy), lerp(c10, c11, fy), fz);
  }
}

// nearest_3d of sensor i's (D, H, W, C) volume
template <int C>
__device__ void volume_nearest(const float* vol, int i, int D, int H, int W,
                               float x, float y, float z, float* out) {
  const int xi = clamp_idx((int)mul(x, (float)W), W);
  const int yi = clamp_idx((int)mul(y, (float)H), H);
  const int zi = clamp_idx((int)mul(z, (float)D), D);
  load_tap<C>(vol + ((((long long)i * D + zi) * H + yi) * W + xi) * C, out);
}

struct Acc {
  float c[3], w, c2[3], w2;
};

// one sensor's term of the blendColors fold (ops/raymarch.py
// _blend_accumulate; the analytic blend's loop body), added to the sums
__device__ __forceinline__ void accumulate(Acc& acc, const float col[3],
                                           float depth, float qual, float z,
                                           bool in_frustum, float limit) {
  const float dist = fabsf(sub(depth, z));
  const float q = (dist < limit && in_frustum) ? qual : 0.0f;
  const float w = dvd(q, add(dist, 0.01f));
  const float w2 = in_frustum ? rcp(clamp_min(dist, 1e-20f)) : 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    acc.c[j] = add(acc.c[j], mul(col[j], w));
    acc.c2[j] = add(acc.c2[j], mul(col[j], w2));
  }
  acc.w = add(acc.w, w);
  acc.w2 = add(acc.w2, w2);
}

// blend_colors_analytic at the world position -> rgba; sensor i's
// projection models read from the block's staged record `models`
__device__ void blend_analytic(const ShadeParams& a, const float* models,
                               const float wp[3], float rgba[4]) {
  Acc acc = {{0.0f, 0.0f, 0.0f}, 0.0f, {0.0f, 0.0f, 0.0f}, 0.0f};
  for (int i = 0; i < a.N; ++i) {
    Models m = load_models(models, i);
    float u, v, cu, cv;
    projective(m.uv_num, m.uv_off, m.uv_den, wp[0], wp[1], wp[2], u, v);
    const float d = add(add(add(mul(wp[0], m.d_lin[0]),
                                mul(wp[1], m.d_lin[1])),
                            mul(wp[2], m.d_lin[2])),
                        m.d_off);
    const bool in_frustum = u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                            v <= 1.0f && d >= 0.0f && d <= 1.0f;
    projective(m.cuv_num, m.cuv_off, m.cuv_den, wp[0], wp[1], wp[2], cu, cv);
    float col[3];
    blend_color(a, i, quad_taps(cu, cv, a.Hc, a.Wc), true, col);
    float depth, qual;
    if (a.dq_bilinear) {
      const Taps dt = quad_taps(u, v, a.Hd, a.Wd);
      depth = blend_taps(corners(a.depth, a.depth_stride, i, dt), 0, dt,
                         false);
      qual = blend_taps(corners(a.quality, a.quality_stride, i, dt), 0, dt,
                        false);
    } else {
      const long long xi = clamp_idx((int)mul(u, (float)a.Wd), a.Wd);
      const long long yi = clamp_idx((int)mul(v, (float)a.Hd), a.Hd);
      const long long* ds = a.depth_stride;
      const long long* qs = a.quality_stride;
      depth = __ldg(a.depth + i * ds[0] + yi * ds[1] + xi * ds[2]);
      qual = __ldg(a.quality + i * qs[0] + yi * qs[1] + xi * qs[2]);
    }
    accumulate(acc, col, depth, qual, d, in_frustum, a.limit);
  }
  const bool primary = acc.w > 0.0f;
  const float inv_w = rcp(clamp_min(acc.w, 1e-20f));
  const float inv_w2 = rcp(clamp_min(acc.w2, 1e-20f));
#pragma unroll
  for (int j = 0; j < 3; ++j)
    rgba[j] = primary ? mul(acc.c[j], inv_w) : mul(acc.c2[j], inv_w2);
  rgba[3] = primary ? 1.0f : -1.0f;
}

// blend_colors (trilinear lookups, f32 bilinear fetches) or
// blend_colors_fast (nearest lookups, pair_bilinear fetches of the bf16
// colour map and the f32 depth and quality) at the volume position
__device__ void blend_volume(const ShadeParams& a, const float hp[3],
                             float rgba[4]) {
  const bool fast = a.blend == BLEND_VOLUME_FAST;
  Acc acc = {{0.0f, 0.0f, 0.0f}, 0.0f, {0.0f, 0.0f, 0.0f}, 0.0f};
  for (int i = 0; i < a.N; ++i) {
    float look[4], pc[2];
    if (fast) {
      volume_nearest<4>(a.cv_inv, i, a.iD, a.iH, a.iW, hp[0], hp[1], hp[2],
                        look);
      volume_nearest<2>(a.cv_uv, i, a.uD, a.uH, a.uW, look[0], look[1],
                        look[2], pc);
    } else {
      volume_trilinear<4>(a.cv_inv, i, a.iD, a.iH, a.iW, hp[0], hp[1],
                          hp[2], look);
      volume_trilinear<2>(a.cv_uv, i, a.uD, a.uH, a.uW, look[0], look[1],
                          look[2], pc);
    }
    const bool in_frustum = look[3] > 0.99f;
    float col[3];
    blend_color(a, i,
                fast ? pair_taps(pc[0], pc[1], a.Hc, a.Wc)
                     : edge_taps(pc[0], pc[1], a.Hc, a.Wc),
                fast, col);
    const Taps dt = fast ? pair_taps(look[0], look[1], a.Hd, a.Wd)
                         : edge_taps(look[0], look[1], a.Hd, a.Wd);
    const float depth =
        blend_taps(corners(a.depth, a.depth_stride, i, dt), 0, dt, false);
    const float qual =
        blend_taps(corners(a.quality, a.quality_stride, i, dt), 0, dt, false);
    accumulate(acc, col, depth, qual, look[2], in_frustum, a.limit);
  }
  // ops/raymarch.py _blend_finalize: divisions
  const bool primary = acc.w > 0.0f;
  const float w = clamp_min(acc.w, 1e-20f);
  const float w2 = clamp_min(acc.w2, 1e-20f);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    rgba[j] = primary ? dvd(acc.c[j], w) : dvd(acc.c2[j], w2);
  rgba[3] = primary ? 1.0f : -1.0f;
}

// ops/raymarch.py shade, mode 1 (Blinn-Phong, shading.glsl:32-69)
__device__ void blinn_phong(const float vp[3], const float vn[3],
                            float rgb[3]) {
  const float light[3] = {1.5f, 1.0f, 1.0f};
  const float ld[3] = {1.0f, 0.9f, 0.7f};
  float tl[3], tv[3], hv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tl[k] = sub(light[k], vp[k]);
    tv[k] = -vp[k];
  }
  unit3(tl[0], tl[1], tl[2]);
  const float la = sum3(mul(vn[0], tl[0]), mul(vn[1], tl[1]),
                        mul(vn[2], tl[2]));
  const bool lit = la > 0.0f;
  float diff = clamp_min(la, 0.0f);
  unit3(tv[0], tv[1], tv[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) hv[k] = add(tl[k], tv[k]);
  unit3(hv[0], hv[1], hv[2]);
  float spec = powf(clamp_min(sum3(mul(hv[0], vn[0]), mul(hv[1], vn[1]),
                                   mul(hv[2], vn[2])),
                              1e-20f),
                    20.0f);
  const float b = sub(1.0f, la);
  const float s = mul(b, b);
  spec = mul(spec, sub(1.0f, mul(s, mul(s, s))));
  diff = lit ? diff : 0.0f;
  spec = lit ? spec : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // ld * 0.2 * 0.5 + ld * 0.5 * diff + ls * 0.5 * spec, ls = 1
    const float ambient = mul(mul(ld[k], 0.2f), 0.5f);
    rgb[k] = add(add(ambient, mul(mul(ld[k], 0.5f), diff)),
                 mul(mul(1.0f, 0.5f), spec));
  }
}

// v @ rot as the card's f32 product computes it: a fused multiply-add
// chain over v's components in order
__device__ __forceinline__ void to_view(const float* rot, const float v[3],
                                        float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = __fmaf_rn(v[2], __ldg(rot + 6 + j),
                       __fmaf_rn(v[1], __ldg(rot + 3 + j),
                                 mul(v[0], __ldg(rot + j))));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    shade_kernel(const ShadeParams a, const Divisor q) {
  extern __shared__ __align__(16) float s_models[];
  if (a.blend == BLEND_ANALYTIC) {
    stage_models(a, s_models);
    __syncthreads();
  }
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long r = i;
  float* rgba_out = a.rgba + r * 4;
  if (!__ldg(a.hit + r * a.hit_stride)) {
    rgba_out[0] = rgba_out[1] = rgba_out[2] = rgba_out[3] = 0.0f;
    a.depth_win[r] = 1.0f;
    return;
  }
  float hp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) hp[k] = __ldg(a.pos[k] + r * a.pos_stride[k]);
  const T* table = (const T*)a.table;
  float grad[3];
  if (a.normal == NORMAL_OCT)
    normal_oct(a, q, table, hp[0], hp[1], hp[2], grad);
  else
    normal_table(a, table, hp[0], hp[1], hp[2], grad);
  // volume gradient -> world normal (the box scale's inverse transpose)
  float nw[3], wp[3], d[3], vp[3], vn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nw[k] = dvd(grad[k], a.bbox_size[k]);
  unit3(nw[0], nw[1], nw[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wp[k] = add(mul(hp[k], a.bbox_size[k]), __ldg(a.bbox_min + k));
    d[k] = sub(wp[k], __ldg(a.eye + k));
  }
  to_view(a.rot, d, vp);
  to_view(a.rot, nw, vn);
  float rgba[4];
  if (a.blend == BLEND_ANALYTIC)
    blend_analytic(a, s_models, wp, rgba);
  else
    blend_volume(a, hp, rgba);
  if (a.shade_mode == 1) {
    blinn_phong(vp, vn, rgba);
  } else if (a.shade_mode == 2) {
    rgba[0] = nw[0];
    rgba[1] = nw[1];
    rgba[2] = nw[2];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) rgba_out[k] = rgba[k];
  // the window depth: (1 / near - 1 / z) / (1 / near - 1 / far), clamped
  const float z = clamp_min(-vp[2], a.near_clamp);
  const float inv_z = mul(rcp(z), 1.0f);
  a.depth_win[r] = clamp_to(mul(sub(a.inv_near, inv_z), a.depth_scale), 0.0f,
                            1.0f);
}

int blocks_for(long long threads) {
  return (int)((threads + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// The refine's launch for n hits: {blocks, threads, lanes a hit, the
// widened bracket's samples a chunk}.
int rgbd_hit_refine_plan(int n, int* out) {
  out[0] = blocks_for(n);
  out[1] = THREADS;
  out[2] = 1;
  out[3] = REFINE_CHUNK;
  return 0;
}

// One refine launch over the hits of a RefineParams block. The table is
// bf16 (table_f32 = 0) or f32; the oct table needs brick-aligned D, H, W
// and rows on 16 bytes, rows8 16 bytes too. n = 0 launches nothing.
int rgbd_hit_refine(const void* params, void* stream) {
  const RefineParams* p = (const RefineParams*)params;
  if (p->n < 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p->rows8) & 15) ||
      (p->oct && (reinterpret_cast<uintptr_t>(p->table) & 15)))
    return (int)cudaErrorMisalignedAddress;
  if (p->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Divisor q = divisor(p->brick_vox);
  if (p->table_f32)
    refine_kernel<float><<<blocks_for(p->n), THREADS, 0, s>>>(*p, q);
  else
    refine_kernel<unsigned short><<<blocks_for(p->n), THREADS, 0, s>>>(*p,
                                                                        q);
  return (int)cudaGetLastError();
}

// The shade's launch for n hits: {blocks, threads, lanes a hit}.
int rgbd_hit_shade_plan(int n, int* out) {
  out[0] = blocks_for(n);
  out[1] = THREADS;
  out[2] = 1;
  return 0;
}

// One shade launch over the hits of a ShadeParams block; the table as for
// rgbd_hit_refine. The calibration volumes (the volume blends) must be 16-
// (cv_inv) and 8-byte (cv_uv) aligned: a tap is one vector load.
int rgbd_hit_shade(const void* params, void* stream) {
  const ShadeParams* p = (const ShadeParams*)params;
  if (p->n < 0 || p->normal < NORMAL_OCT || p->normal > NORMAL_TRILINEAR ||
      p->blend < BLEND_ANALYTIC || p->blend > BLEND_VOLUME_FAST ||
      p->shade_mode < 0 || p->shade_mode > 2)
    return (int)cudaErrorInvalidValue;
  if ((p->blend != BLEND_ANALYTIC &&
       ((reinterpret_cast<uintptr_t>(p->cv_inv) & 15) ||
        (reinterpret_cast<uintptr_t>(p->cv_uv) & 7))) ||
      (p->normal == NORMAL_OCT &&
       (reinterpret_cast<uintptr_t>(p->table) & 15)))
    return (int)cudaErrorMisalignedAddress;
  // the analytic blend's models staged a block: at most 48 KB
  const long long smem = p->blend == BLEND_ANALYTIC
                             ? (long long)p->N * MODEL_FLOATS * 4 : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (p->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = blocks_for(p->n);
  const Divisor q = divisor(p->brick_vox);
  if (p->table_f32)
    shade_kernel<float><<<blocks, THREADS, smem, s>>>(*p, q);
  else
    shade_kernel<unsigned short><<<blocks, THREADS, smem, s>>>(*p, q);
  return (int)cudaGetLastError();
}

// sizeof the parameter blocks: the wrapper checks its ctypes mirrors
int rgbd_hit_params_sizes(int* out) {
  out[0] = (int)sizeof(RefineParams);
  out[1] = (int)sizeof(ShadeParams);
  return 0;
}

}  // extern "C"
