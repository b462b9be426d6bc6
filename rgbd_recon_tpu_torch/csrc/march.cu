// Stepwise ray march: one thread a ray, each stepping its own ray until it
// hits, passes its length or spends the step budget. Two entry points:
// rgbd_march over per-ray input tensors read through their strides (the
// full-screen march, tests), and rgbd_march_rows, the render's march over
// its row arrays by an id list (march_rows_kernel below: it reads and
// writes rays by id, in place of the render's row gathers, state stacks
// and scatters).
//
// Replaces the march loop of the render: in the JAX package the XLA
// while-loop of rgbd_recon_tpu/ops/raymarch.py march (:501, :661; no
// Pallas kernel), in the port its stepwise PyTorch twin
// (ops/raymarch.py march_plain: ~40 launches a step with nearest taps, ~60
// with trilinear taps, and a host sync every 8 steps).
//
// Per ray, exactly what the twin computes (IEEE f32, no FMA contraction:
// the library is compiled with --fmad=false and without fast math, and
// every product and sum is written in the twin's order):
//   pos     = pos0 + dir * t                     (a product, then a sum)
//   raw     = the table at pos: the nearest texel (truncated, clamped) or
//             sampling.pair_trilinear's eight taps
//   density = max(raw, -limit)
//   on the first density > 0: hit_t = t - (t - prev_t) * (density / den),
//             den = density - prev, 1e-20 where |den| < 1e-20;
//             lo_t = prev_t, hi_t = t
//   advance = max((-raw - 2) * sentinel_scale, sd) where sentinel_skip and
//             raw < -1.5, else sd
//   num += 1, prev_t = t, prev = density, t += advance
// A ray is active while it has not hit, t <= its length and its length is
// > 0; once inactive it stays so, so the thread stops there (the twin runs
// on until no ray is active and changes nothing more). A ray that is never
// active keeps its initial state and takes no sample.
//
// Bound on this card: neither bytes nor operations. A frame's rays take a
// few million samples (PERF.md §6); the kernel's time is the dependent
// chain of its longest ray, each step a table load (from L2 or L1) and
// the secant's division before the next position is known. Design:
//  - one thread a ray, 128 threads a block: the render lays out the rays
//    of a 4x4 screen block next to each other, so a warp's rays sample
//    neighbouring texels and its loads share sectors;
//  - the table read through the read-only path (__ldg); bf16 entries
//    loaded as 16 bits and shifted into an f32 (exact, as the twin's
//    .to(float32));
//  - the per-ray inputs read through strides, so column views of the
//    render's (N, 8) state rows need no copy;
//  - the table is not spread over a cluster's shared memory: at 8.8 M
//    entries it fits no cluster, and remote shared memory reads were
//    slower than L2 on this card (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MARCH_THREADS = 128;

// inputs: pos0 x y z, dir x y z, ray length, resume t, prev_t, prev
constexpr int N_IN = 10;
// outputs after hit and num: t, prev_t, prev, lo_t, hi_t, hit_t
constexpr int N_STATE = 6;

struct MarchArgs {
  const float* in[N_IN];
  long long stride[N_IN];
  unsigned char* hit;
  int* num;
  float* state[N_STATE];
  int n;
  int max_steps;
  int D, H, W;
  float neg_limit;  // -limit, rounded to f32
  float sd;         // the step, f32(limit) * 0.5
  float scale;      // sentinel_scale, rounded to f32
};

__device__ __forceinline__ float load_entry(const float* t, int i) {
  return __ldg(t + i);
}

__device__ __forceinline__ float load_entry(const unsigned short* t, int i) {
  return __uint_as_float(((unsigned int)__ldg(t + i)) << 16);
}

__device__ __forceinline__ int clamp_idx(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

// ops/raymarch.py sample_nearest_p: the truncated texel, clamped
template <typename T>
__device__ __forceinline__ float sample_nearest(const T* table, float px,
                                                float py, float pz, int D,
                                                int H, int W) {
  const int xi = clamp_idx((int)__fmul_rn(px, (float)W), W);
  const int yi = clamp_idx((int)__fmul_rn(py, (float)H), H);
  const int zi = clamp_idx((int)__fmul_rn(pz, (float)D), D);
  return load_entry(table, (zi * H + yi) * W + xi);
}

// ops/sampling.py pair_trilinear (no clamp floor): x taps x0 and
// min(x0 + 1, W - 1) with zero x weight left of the first texel, y and z
// taps floor and floor + 1, each truncated and clamped
template <typename T>
__device__ __forceinline__ float sample_trilinear(const T* table, float px,
                                                  float py, float pz, int D,
                                                  int H, int W) {
  const float cx = __fsub_rn(__fmul_rn(px, (float)W), 0.5f);
  const float cy = __fsub_rn(__fmul_rn(py, (float)H), 0.5f);
  const float cz = __fsub_rn(__fmul_rn(pz, (float)D), 0.5f);
  const float x0f = floorf(cx), y0f = floorf(cy), z0f = floorf(cz);
  const float fx = x0f < 0.0f ? 0.0f : __fsub_rn(cx, x0f);
  const float fy = __fsub_rn(cy, y0f);
  const float fz = __fsub_rn(cz, z0f);
  const int x0 = clamp_idx((int)x0f, W);
  const int x1 = min(x0 + 1, W - 1);
  const int y0 = clamp_idx((int)y0f, H);
  const int y1 = clamp_idx((int)__fadd_rn(y0f, 1.0f), H);
  const int z0 = clamp_idx((int)z0f, D);
  const int z1 = clamp_idx((int)__fadd_rn(z0f, 1.0f), D);
  const float wx = __fsub_rn(1.0f, fx);
  const float wy = __fsub_rn(1.0f, fy);
  const float wz = __fsub_rn(1.0f, fz);
  float pair[4];
  const int zs[4] = {z0, z0, z1, z1};
  const int ys[4] = {y0, y1, y0, y1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int base = (zs[k] * H + ys[k]) * W;
    const float a = load_entry(table, base + x0);
    const float b = load_entry(table, base + x1);
    pair[k] = __fadd_rn(__fmul_rn(a, wx), __fmul_rn(b, fx));
  }
  const float c0 = __fadd_rn(__fmul_rn(pair[0], wy), __fmul_rn(pair[1], fy));
  const float c1 = __fadd_rn(__fmul_rn(pair[2], wy), __fmul_rn(pair[3], fy));
  return __fadd_rn(__fmul_rn(c0, wz), __fmul_rn(c1, fz));
}

// One ray's march from (t, prev_t, prev): the loop of the header, the
// twin's arithmetic step for step.
struct RayState {
  float t, prev_t, prev, lo_t, hi_t, hit_t;
  bool hit;
  int num;
};

template <typename T, bool TRILINEAR, bool SKIP>
__device__ __forceinline__ void march_ray(const T* __restrict__ table,
                                          const MarchArgs& a, float p0x,
                                          float p0y, float p0z, float dx,
                                          float dy, float dz, float len,
                                          RayState& s) {
  float t = s.t, prev_t = s.prev_t, prev = s.prev;
  float lo_t = 0.0f, hi_t = 0.0f, hit_t = 0.0f;
  bool hit = false;
  int num = 0;
  // a ray of length <= 0 (or NaN) is never active
  const int steps = len > 0.0f ? a.max_steps : 0;
  for (int k = 0; k < steps && t <= len; ++k) {
    const float px = __fadd_rn(p0x, __fmul_rn(dx, t));
    const float py = __fadd_rn(p0y, __fmul_rn(dy, t));
    const float pz = __fadd_rn(p0z, __fmul_rn(dz, t));
    const float raw =
        TRILINEAR ? sample_trilinear(table, px, py, pz, a.D, a.H, a.W)
                  : sample_nearest(table, px, py, pz, a.D, a.H, a.W);
    // torch.clamp_min: NaN stays NaN
    const float density = raw < a.neg_limit ? a.neg_limit : raw;
    const bool found = density > 0.0f;
    if (found) {
      float den = __fsub_rn(density, prev);
      den = fabsf(den) < 1e-20f ? 1e-20f : den;
      hit_t = __fsub_rn(t, __fmul_rn(__fsub_rn(t, prev_t),
                                     __fdiv_rn(density, den)));
      lo_t = prev_t;
      hi_t = t;
    }
    float advance = a.sd;
    if (SKIP && raw < -1.5f) {
      const float clr = __fmul_rn(__fsub_rn(-raw, 2.0f), a.scale);
      advance = clr < a.sd ? a.sd : clr;
    }
    num += 1;
    prev_t = t;
    prev = density;
    t = __fadd_rn(t, advance);
    if (found) {
      hit = true;
      break;
    }
  }
  s.t = t;
  s.prev_t = prev_t;
  s.prev = prev;
  s.lo_t = lo_t;
  s.hi_t = hi_t;
  s.hit_t = hit_t;
  s.hit = hit;
  s.num = num;
}

template <typename T, bool TRILINEAR, bool SKIP, bool RESUME>
__global__ void __launch_bounds__(MARCH_THREADS)
    march_kernel(const T* __restrict__ table, MarchArgs a) {
  const int i = blockIdx.x * MARCH_THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long r = i;
  RayState s{0.0f, 0.0f, a.neg_limit, 0.0f, 0.0f, 0.0f, false, 0};
  if (RESUME) {
    s.t = __ldg(a.in[7] + r * a.stride[7]);
    s.prev_t = __ldg(a.in[8] + r * a.stride[8]);
    s.prev = __ldg(a.in[9] + r * a.stride[9]);
  }
  march_ray<T, TRILINEAR, SKIP>(
      table, a, __ldg(a.in[0] + r * a.stride[0]),
      __ldg(a.in[1] + r * a.stride[1]), __ldg(a.in[2] + r * a.stride[2]),
      __ldg(a.in[3] + r * a.stride[3]), __ldg(a.in[4] + r * a.stride[4]),
      __ldg(a.in[5] + r * a.stride[5]), __ldg(a.in[6] + r * a.stride[6]),
      s);
  a.hit[i] = s.hit;
  a.num[i] = s.num;
  a.state[0][i] = s.t;
  a.state[1][i] = s.prev_t;
  a.state[2][i] = s.prev;
  a.state[3][i] = s.lo_t;
  a.state[4][i] = s.hi_t;
  a.state[5][i] = s.hit_t;
}

// The render's march over its row arrays (the redesign of the stage,
// ops/raymarch.py march_rows_plain / march_grid_plain): ray i is row
// r = ids[i] (r = i without ids) of ray8 (pos0 x y z, dir x y z, full
// length, bracket length; the coarse march's block rows: pos0, dir,
// length, interval start); ids at or past `rows` are the list's padding
// and do nothing.
//  ROWS_FRESH:  every row from the start, length column len_col; writes
//               st8[r] = (t, prev_t, prev, lo_t, hi_t, hit_t, hit, num)
//               and flags[r] (bit 0 hit, bit 1 unfinished: no hit,
//               t <= full length, full length > 0);
//  ROWS_RESUME: the listed rows from st8[r]'s (t, prev_t, prev), their
//               full length; writes st8[r] with num = st8[r][7] + num, and
//               flags[r];
//  GRID:        the listed block rows from the start; a hit writes the
//               block's grid entries (1, start + lo_t, start + hi_t) of
//               the (3, rows) hit / lo / hi grids.
enum RowMode { ROWS_FRESH = 0, ROWS_RESUME = 1, GRID = 2 };

struct RowArgs {
  const float* ray8;
  float* st8;
  unsigned char* flags;
  const long long* ids;
  float* grid;
  int n;
  int rows;
  int len_col;
};

template <typename T, bool TRILINEAR, bool SKIP, int MODE>
__global__ void __launch_bounds__(MARCH_THREADS)
    march_rows_kernel(const T* __restrict__ table, MarchArgs a, RowArgs b) {
  const int i = blockIdx.x * MARCH_THREADS + threadIdx.x;
  if (i >= b.n) return;
  const long long r = b.ids != nullptr ? __ldg(b.ids + i) : (long long)i;
  if (r >= b.rows) return;
  const float* ray = b.ray8 + r * 8;
  RayState s{0.0f, 0.0f, a.neg_limit, 0.0f, 0.0f, 0.0f, false, 0};
  float* st = MODE == GRID ? nullptr : b.st8 + r * 8;
  if (MODE == ROWS_RESUME) {
    s.t = st[0];
    s.prev_t = st[1];
    s.prev = st[2];
  }
  march_ray<T, TRILINEAR, SKIP>(table, a, __ldg(ray + 0), __ldg(ray + 1),
                                __ldg(ray + 2), __ldg(ray + 3),
                                __ldg(ray + 4), __ldg(ray + 5),
                                __ldg(ray + b.len_col), s);
  if (MODE == GRID) {
    if (s.hit) {
      const float start = __ldg(ray + 7);
      b.grid[r] = 1.0f;
      b.grid[b.rows + r] = __fadd_rn(start, s.lo_t);
      b.grid[2 * (long long)b.rows + r] = __fadd_rn(start, s.hi_t);
    }
    return;
  }
  const float fnum = (float)s.num;
  const float num = MODE == ROWS_RESUME ? __fadd_rn(st[7], fnum) : fnum;
  st[0] = s.t;
  st[1] = s.prev_t;
  st[2] = s.prev;
  st[3] = s.lo_t;
  st[4] = s.hi_t;
  st[5] = s.hit_t;
  st[6] = s.hit ? 1.0f : 0.0f;
  st[7] = num;
  const float full = __ldg(ray + 6);
  const bool unfinished = !s.hit && s.t <= full && full > 0.0f;
  b.flags[r] = (unsigned char)((s.hit ? 1 : 0) | (unfinished ? 2 : 0));
}

template <typename T, bool TRILINEAR, bool SKIP>
int launch_resume(const T* table, const MarchArgs& a, int resume,
                  cudaStream_t s) {
  const int blocks = (a.n + MARCH_THREADS - 1) / MARCH_THREADS;
  if (resume)
    march_kernel<T, TRILINEAR, SKIP, true><<<blocks, MARCH_THREADS, 0, s>>>(
        table, a);
  else
    march_kernel<T, TRILINEAR, SKIP, false><<<blocks, MARCH_THREADS, 0, s>>>(
        table, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* table, const MarchArgs& a, int trilinear,
                 int sentinel_skip, int resume, cudaStream_t s) {
  const T* tab = (const T*)table;
  if (trilinear)
    return sentinel_skip ? launch_resume<T, true, true>(tab, a, resume, s)
                         : launch_resume<T, true, false>(tab, a, resume, s);
  return sentinel_skip ? launch_resume<T, false, true>(tab, a, resume, s)
                       : launch_resume<T, false, false>(tab, a, resume, s);
}

template <typename T, bool TRILINEAR, bool SKIP>
int launch_rows_mode(const T* table, const MarchArgs& a, const RowArgs& b,
                     int mode, cudaStream_t s) {
  const int blocks = (b.n + MARCH_THREADS - 1) / MARCH_THREADS;
  if (mode == ROWS_FRESH)
    march_rows_kernel<T, TRILINEAR, SKIP, ROWS_FRESH>
        <<<blocks, MARCH_THREADS, 0, s>>>(table, a, b);
  else if (mode == ROWS_RESUME)
    march_rows_kernel<T, TRILINEAR, SKIP, ROWS_RESUME>
        <<<blocks, MARCH_THREADS, 0, s>>>(table, a, b);
  else
    march_rows_kernel<T, TRILINEAR, SKIP, GRID>
        <<<blocks, MARCH_THREADS, 0, s>>>(table, a, b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows_typed(const void* table, const MarchArgs& a,
                      const RowArgs& b, int trilinear, int sentinel_skip,
                      int mode, cudaStream_t s) {
  const T* tab = (const T*)table;
  if (trilinear)
    return sentinel_skip
               ? launch_rows_mode<T, true, true>(tab, a, b, mode, s)
               : launch_rows_mode<T, true, false>(tab, a, b, mode, s);
  return sentinel_skip
             ? launch_rows_mode<T, false, true>(tab, a, b, mode, s)
             : launch_rows_mode<T, false, false>(tab, a, b, mode, s);
}

}  // namespace

extern "C" {

// One march of n rays over a (D, H, W) table, bf16 (table_f32 = 0) or f32
// (table_f32 = 1). ins holds N_IN pointers to f32 per-ray inputs (pos0 x y
// z, dir x y z, length, then resume t, prev_t, prev, read only when
// resume = 1) and strides their element strides; outs holds hit (one byte
// a ray), num (int32) and the N_STATE f32 state outputs, each contiguous.
// D * H * W must be below 2^31. n = 0 launches nothing.
int rgbd_march(const void* table, int table_f32, int D, int H, int W,
               const long long* ins, const long long* strides, int resume,
               const long long* outs, int n, int max_steps, int trilinear,
               int sentinel_skip, float neg_limit, float sd, float scale,
               void* stream) {
  if (n < 0 || max_steps < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  MarchArgs a;
  for (int k = 0; k < N_IN; ++k) {
    const bool used = k < 7 || resume;
    a.in[k] = used ? (const float*)ins[k] : nullptr;
    a.stride[k] = used ? strides[k] : 0;
  }
  a.hit = (unsigned char*)outs[0];
  a.num = (int*)outs[1];
  for (int k = 0; k < N_STATE; ++k) a.state[k] = (float*)outs[2 + k];
  a.n = n;
  a.max_steps = max_steps;
  a.D = D;
  a.H = H;
  a.W = W;
  a.neg_limit = neg_limit;
  a.sd = sd;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_f32)
    return launch_typed<float>(table, a, trilinear, sentinel_skip, resume, s);
  return launch_typed<unsigned short>(table, a, trilinear, sentinel_skip,
                                      resume, s);
}

// The render's march over its rows (march_rows_kernel): mode 0 fresh rows
// (ids null: n = rows), 1 resumed listed rows, 2 the coarse march's block
// grids. ray8 and st8 are contiguous (rows, 8) f32, flags (rows,) bytes,
// ids (n,) int64 or null, grid (3, rows) f32. n = 0 launches nothing.
int rgbd_march_rows(const void* table, int table_f32, int D, int H, int W,
                    int mode, const void* ray8, void* st8, void* flags,
                    const void* ids, void* grid, int n, int rows,
                    int len_col, int max_steps, int trilinear,
                    int sentinel_skip, float neg_limit, float sd,
                    float scale, void* stream) {
  if (n < 0 || rows < 0 || max_steps < 0 || mode < 0 || mode > 2 ||
      len_col < 0 || len_col > 7)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  MarchArgs a = {};
  a.max_steps = max_steps;
  a.D = D;
  a.H = H;
  a.W = W;
  a.neg_limit = neg_limit;
  a.sd = sd;
  a.scale = scale;
  RowArgs b;
  b.ray8 = (const float*)ray8;
  b.st8 = (float*)st8;
  b.flags = (unsigned char*)flags;
  b.ids = (const long long*)ids;
  b.grid = (float*)grid;
  b.n = n;
  b.rows = rows;
  b.len_col = len_col;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_f32)
    return launch_rows_typed<float>(table, a, b, trilinear, sentinel_skip,
                                    mode, s);
  return launch_rows_typed<unsigned short>(table, a, b, trilinear,
                                           sentinel_skip, mode, s);
}

}  // extern "C"
