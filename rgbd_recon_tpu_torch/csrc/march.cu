// Stepwise ray march: one thread a ray, each stepping its own ray until it
// hits, passes its length or spends the step budget.
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

template <typename T, bool TRILINEAR, bool SKIP, bool RESUME>
__global__ void __launch_bounds__(MARCH_THREADS)
    march_kernel(const T* __restrict__ table, MarchArgs a) {
  const int i = blockIdx.x * MARCH_THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long r = i;
  const float p0x = __ldg(a.in[0] + r * a.stride[0]);
  const float p0y = __ldg(a.in[1] + r * a.stride[1]);
  const float p0z = __ldg(a.in[2] + r * a.stride[2]);
  const float dx = __ldg(a.in[3] + r * a.stride[3]);
  const float dy = __ldg(a.in[4] + r * a.stride[4]);
  const float dz = __ldg(a.in[5] + r * a.stride[5]);
  const float len = __ldg(a.in[6] + r * a.stride[6]);
  float t = 0.0f, prev_t = 0.0f, prev = a.neg_limit;
  if (RESUME) {
    t = __ldg(a.in[7] + r * a.stride[7]);
    prev_t = __ldg(a.in[8] + r * a.stride[8]);
    prev = __ldg(a.in[9] + r * a.stride[9]);
  }
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
  a.hit[i] = hit;
  a.num[i] = num;
  a.state[0][i] = t;
  a.state[1][i] = prev_t;
  a.state[2][i] = prev;
  a.state[3][i] = lo_t;
  a.state[4][i] = hi_t;
  a.state[5][i] = hit_t;
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

}  // extern "C"
