// The fuse's brick marking and brick-compact integration, one launch each.
//
// Replaces two XLA stages of the JAX package's jitted fuse (no Pallas
// kernel): the marking of rgbd_recon_tpu/recon/tsdf_pipeline.py:270
// _mark_bricks with rgbd_recon_tpu/ops/bricks.py:20 mark_bricks (a one-hot
// matmul histogram), and the integration of rgbd_recon_tpu/ops/tsdf.py:266
// occupied_brick_ids, :301 integrate_bricks and :410 _fold_and_scatter.
// In the port their plain twins are ops/bricks.py mark_pixels_plain and
// ops/tsdf.py integrate_compact_plain.
//
// brick_mark: one thread a sampled pixel (n, s/2 + s i, s/2 + s j). A depth
// d with 0 < d < 1 is valid; its world point is ray_a + ray_b d (the pixel
// models) or read from `worlds` (the calibration volumes' lookup, made by
// the caller). The point adds `add` (= s^2) to its brick's count and, where
// |diff.x| > border (the reference's x-only border test), to the neighbour
// brick along the dominant offset. The counts are integers, so any order
// of the atomics gives the same counts. Where the grid's counts fit in
// shared memory (MARK_SMEM_MAX bytes: 8,800 bricks of 10 cm, 35.2 KB), each
// block accumulates a histogram there over a grid-stride loop and adds its
// non-zero bins to the counts; otherwise (5 cm bricks: 70,400) every point
// adds to the counts in global memory. The launch zeroes the counts
// itself: it is cooperative (every block resident at once, at most
// MARK_BLOCKS_PER_SM an SM), its blocks zero the counts and meet at one
// grid barrier before the first add. Bound: bytes (the sampled depth and
// the two ray planes, 28 B a pixel, and the counts).
//
// brick_integrate: one launch of two kinds of thread block over the dense
// (Z, Y, X) volume. ops/compact.py's list of the occupied bricks (the first
// `capacity`, ascending, padded with B) and its slot map (-1 for a brick
// not listed: unoccupied, or past the capacity) say which bricks are
// integrated.
//  - Clear blocks: a thread CLEAR_QUADS runs of four voxels along x, each
//    run's bricks' slots loaded at once; the voxels of unlisted bricks take
//    the clear value -limit, stored as one float4 where all four do and
//    X % 4 == 0 (several stores in flight a thread: with one run a thread
//    the clear reached 1.5 TB/s).
//  - Brick blocks: INT_THREADS voxels of one listed brick, a thread a
//    voxel in the brick's row order, so a sensor's projection rows
//    (u, v, depth_norm, +-1: one float4 a voxel) are read as whole lines.
//    Each voxel loads its sensors' rows SENSOR_CHUNK at a time, taps the
//    maps (nearest: depth in f32, quality and silhouette rounded to bf16;
//    bilinear: the four-corner rule of ops/sampling.py quad_bilinear),
//    folds the sensors in registers (ops/tsdf.py fuse_sensor), applies the
//    phantom-hull rule and writes its voxel of the dense volume; a padding
//    entry's blocks and the voxels of a brick past the volume's edge write
//    nothing.
// The two write disjoint voxels. The (N, K, V) gathers and the (B, V)
// brick-major volume of the plain version are never built. Two dense forms
// ran slower and were not kept (PERF.md §6): a thread a voxel of the
// volume, and a thread four voxels along x. Bound: bytes (the volume
// written once, the listed bricks' projection rows, the maps).
//
// Rounding: every product, sum and quotient is rounded on its own, as the
// plain version's separate PyTorch launches round them (the library is
// built with --fmad=false; the intrinsics below say so at each site). The
// caller passes the scalars as PyTorch's CUDA launches see them: x / c by
// a Python c as x * f32(1 / c), a Python product as its f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MARK_THREADS = 256;
// the pixels a block takes in its grid-stride loop at most, before the
// grid grows past MARK_BLOCKS_PER_SM blocks an SM
constexpr int MARK_PIXELS_PER_THREAD = 4;
constexpr int MARK_BLOCKS_PER_SM = 2;
// the shared histogram's limit (no opt-in above 48 KB)
constexpr int MARK_SMEM_MAX = 48 * 1024;
constexpr int INT_THREADS = 256;
// sensors whose projections a voxel loads before their taps and folds
constexpr int SENSOR_CHUNK = 4;
// quads (four voxels along x) a thread of a clear block clears
constexpr int CLEAR_QUADS = 4;

}  // namespace

// the parameter block of a mark launch (kernels/fuse.py MarkParams mirrors
// it field for field); strides in elements
struct MarkParams {
  const float* depth;        // (N, H, W) view
  long long ds[3];
  const float* ray_a;        // (N, H, W, 3) views, or null with worlds
  long long sa[4];
  const float* ray_b;
  long long sb[4];
  const float* worlds;       // (N, Hs, Ws, 3) view, or null
  long long ws[4];
  const float* bbox_min;     // (3,)
  int* counts;               // (Bz, By, Bx) int32
  int N, H, W, stride, Hs, Ws;
  int bx, by, bz;
  int add;
  float inv_brick;           // f32(1) / f32(brick_size)
  float brick;               // f32(brick_size)
  float border;              // f32(brick_size * 0.1)
};

// the parameter block of an integrate launch (kernels/fuse.py
// IntegrateParams); strides in elements
struct IntegrateParams {
  const float* proj;         // (N, B, V, 4), 16-byte aligned, each
                             // sensor's (B, V, 4) contiguous
  long long proj_n;          // the sensor stride in float4
  const long long* ids;      // (capacity,) listed bricks, padded with B
  const int* slot;           // (B,) int32
  const float* depth;        // (N, H, W) views
  long long ds[3];
  const float* qual;
  long long qs[3];
  const float* sil;
  long long ss[3];
  float* out;                // (Z, Y, X)
  int N, H, W;
  int Z, Y, X, v, Bz, By, Bx, V;
  int bilinear, phantom_hull;
  int capacity;
  int clear_blocks, chunks;  // set by the launch: the blocks of each kind
  float limit, carve;
};

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// a NaN-propagating max, as torch's max reduction
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fffffff);
  return a > b ? a : b;
}

// the mark's brick and neighbour of pixel p; false for an invalid depth
__device__ __forceinline__ bool mark_pixel(const MarkParams& q, int p,
                                           int* own, int* nbr, bool* near) {
  const int per = q.Hs * q.Ws;
  const int n = p / per;
  const int rem = p - n * per;
  const int i = rem / q.Ws, j = rem - i * q.Ws;
  const int h = q.stride / 2 + q.stride * i;
  const int w = q.stride / 2 + q.stride * j;
  const float d = q.depth[n * q.ds[0] + h * q.ds[1] + w * q.ds[2]];
  if (!(d > 0.0f && d < 1.0f)) return false;
  float pt[3];
  if (q.worlds != nullptr) {
    const float* wp = q.worlds + n * q.ws[0] + i * q.ws[1] + j * q.ws[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) pt[c] = wp[c * q.ws[3]];
  } else {
    const float* ap = q.ray_a + n * q.sa[0] + h * q.sa[1] + w * q.sa[2];
    const float* bp = q.ray_b + n * q.sb[0] + h * q.sb[1] + w * q.sb[2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      pt[c] = __fadd_rn(ap[c * q.sa[3]], __fmul_rn(bp[c * q.sb[3]], d));
  }
  const int hi[3] = {q.bx - 1, q.by - 1, q.bz - 1};
  int idx[3];
  float diff[3], dab[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bmin = q.bbox_min[c];
    const float rel = __fmul_rn(__fsub_rn(pt[c], bmin), q.inv_brick);
    idx[c] = clampi(__float2int_rz(floorf(rel)), 0, hi[c]);
    const float centre = __fadd_rn(
        __fmul_rn(__fadd_rn((float)idx[c], 0.5f), q.brick), bmin);
    diff[c] = __fsub_rn(pt[c], centre);
    dab[c] = fabsf(diff[c]);
  }
  const float top = nan_max(nan_max(dab[0], dab[1]), dab[2]);
  int nidx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // sign(diff * (|diff| < top ? 0 : 1)) as int
    const int off = dab[c] < top ? 0 : (diff[c] > 0.0f) - (diff[c] < 0.0f);
    nidx[c] = clampi(idx[c] + off, 0, hi[c]);
  }
  *own = (idx[2] * q.by + idx[1]) * q.bx + idx[0];
  *nbr = (nidx[2] * q.by + nidx[1]) * q.bx + nidx[0];
  *near = dab[0] > q.border;
  return true;
}

// the marking: the counts zeroed, a grid barrier, then each pixel's adds
// (through a shared histogram a block when SMEM, else to global memory)
template <bool SMEM>
__global__ void __launch_bounds__(MARK_THREADS)
    mark_kernel(const MarkParams q, int pixels, int bins) {
  extern __shared__ int hist[];
  const int stride = gridDim.x * MARK_THREADS;
  for (int k = blockIdx.x * MARK_THREADS + threadIdx.x; k < bins;
       k += stride)
    q.counts[k] = 0;
  if (SMEM)
    for (int k = threadIdx.x; k < bins; k += MARK_THREADS) hist[k] = 0;
  cooperative_groups::this_grid().sync();
  int* dst = SMEM ? hist : q.counts;
  for (int p = blockIdx.x * MARK_THREADS + threadIdx.x; p < pixels;
       p += stride) {
    int own, nbr;
    bool near;
    if (mark_pixel(q, p, &own, &nbr, &near)) {
      atomicAdd(dst + own, q.add);
      if (near) atomicAdd(dst + nbr, q.add);
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int k = threadIdx.x; k < bins; k += MARK_THREADS) {
      const int c = hist[k];
      if (c != 0) atomicAdd(q.counts + k, c);
    }
  }
}

// map value at (y, x) of sensor n
__device__ __forceinline__ float tap(const float* m, const long long* s,
                                     int n, int y, int x) {
  return m[n * s[0] + y * s[1] + x * s[2]];
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// r00 (1 - fx) + r01 fx, then the same down y, each operation rounded
__device__ __forceinline__ float lerp2(float r00, float r01, float r10,
                                       float r11, float fx, float fy) {
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float c0 = __fadd_rn(__fmul_rn(r00, gx), __fmul_rn(r01, fx));
  const float c1 = __fadd_rn(__fmul_rn(r10, gx), __fmul_rn(r11, fx));
  return __fadd_rn(__fmul_rn(c0, gy), __fmul_rn(c1, fy));
}

// one sensor's map values (depth, quality, silhouette) at its projection
// r of a voxel: the nearest texel (quality and silhouette rounded to
// bf16), or quad_bilinear's four corners
__device__ __forceinline__ float3 sensor_taps(const IntegrateParams& q,
                                              int n, float4 r) {
  const float fW = (float)q.W, fH = (float)q.H;
  if (q.bilinear) {
    const float cx = __fsub_rn(__fmul_rn(r.x, fW), 0.5f);
    const float cy = __fsub_rn(__fmul_rn(r.y, fH), 0.5f);
    const float x0f = floorf(cx), y0f = floorf(cy);
    const float fx = x0f < 0.0f ? 0.0f : __fsub_rn(cx, x0f);
    const float fy = y0f < 0.0f ? 0.0f : __fsub_rn(cy, y0f);
    const int x0 = clampi(__float2int_rz(x0f), 0, q.W - 1);
    const int y0 = clampi(__float2int_rz(y0f), 0, q.H - 1);
    const int x1 = min(x0 + 1, q.W - 1), y1 = min(y0 + 1, q.H - 1);
    return make_float3(
        lerp2(tap(q.depth, q.ds, n, y0, x0), tap(q.depth, q.ds, n, y0, x1),
              tap(q.depth, q.ds, n, y1, x0), tap(q.depth, q.ds, n, y1, x1),
              fx, fy),
        lerp2(tap(q.qual, q.qs, n, y0, x0), tap(q.qual, q.qs, n, y0, x1),
              tap(q.qual, q.qs, n, y1, x0), tap(q.qual, q.qs, n, y1, x1),
              fx, fy),
        lerp2(tap(q.sil, q.ss, n, y0, x0), tap(q.sil, q.ss, n, y0, x1),
              tap(q.sil, q.ss, n, y1, x0), tap(q.sil, q.ss, n, y1, x1),
              fx, fy));
  }
  // (u * W).to(int32) truncates toward zero, then clamps
  const int xi = clampi(__float2int_rz(__fmul_rn(r.x, fW)), 0, q.W - 1);
  const int yi = clampi(__float2int_rz(__fmul_rn(r.y, fH)), 0, q.H - 1);
  return make_float3(tap(q.depth, q.ds, n, yi, xi),
                     bf16_round(tap(q.qual, q.qs, n, yi, xi)),
                     bf16_round(tap(q.sil, q.ss, n, yi, xi)));
}

// fuse_sensor (tsdf_integration.vs:30-55): one sensor's update of the
// running (tsd, total_w)
__device__ __forceinline__ void fuse_sensor(float& tsd, float& total_w,
                                            float4 r, float3 t, float limit,
                                            float carve_threshold) {
  const float depth = t.x, qual = t.y, sil = t.z;
  const bool inf = r.w > 0.0f;
  const bool carve = (sil < carve_threshold) && (tsd >= limit) && inf;
  const float sdist = __fsub_rn(r.z, depth);
  const bool behind = (sdist <= -limit) && inf;
  const bool skip = (sdist >= limit) || !inf;
  const float new_w = __fadd_rn(total_w, qual);
  // clamp_min(new_w, 1e-20) keeps a NaN
  const float den = new_w < 1e-20f ? 1e-20f : new_w;
  const float updated =
      new_w > 0.0f
          ? __fdiv_rn(__fadd_rn(__fmul_rn(tsd, total_w),
                                __fmul_rn(qual, sdist)),
                      den)
          : tsd;
  const float tsd_next = behind ? -limit : (skip ? tsd : updated);
  const float w_next = (behind || skip) ? total_w : new_w;
  tsd = carve ? -limit : tsd_next;
  total_w = carve ? total_w : w_next;
}

// the folded value of a listed voxel: row lv of brick b; its sensors'
// projections loaded SENSOR_CHUNK at a time before their taps and folds
__device__ __forceinline__ float integrate_voxel(const IntegrateParams& q,
                                                 int b, int lv) {
  const float limit = q.limit;
  const float4* proj = (const float4*)q.proj + (long long)b * q.V + lv;
  float tsd = limit, total_w = 0.0f;
  for (int n0 = 0; n0 < q.N; n0 += SENSOR_CHUNK) {
    float4 r[SENSOR_CHUNK];
#pragma unroll
    for (int k = 0; k < SENSOR_CHUNK; ++k)
      if (n0 + k < q.N) r[k] = proj[(n0 + k) * q.proj_n];
#pragma unroll
    for (int k = 0; k < SENSOR_CHUNK; ++k)
      if (n0 + k < q.N)
        fuse_sensor(tsd, total_w, r[k], sensor_taps(q, n0 + k, r[k]), limit,
                    q.carve);
  }
  if (!q.phantom_hull && total_w <= 0.0f && tsd >= limit) tsd = -limit;
  return tsd;
}

// the clear of quad i (four voxels along x): those of unlisted bricks
__device__ __forceinline__ void clear_quad(const IntegrateParams& q, int i) {
  const int v = q.v, X4 = (q.X + 3) >> 2;
  const int zy = i / X4, x0 = (i - zy * X4) * 4;
  const int z = zy / q.Y, y = zy - z * q.Y;
  const int row_b = ((z / v) * q.By + y / v) * q.Bx;
  int bx = x0 / v, l = x0 - bx * v;
  bool clear[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    clear[k] = x0 + k < q.X && q.slot[row_b + bx] < 0;
    if (++l == v) {
      l = 0;
      ++bx;
    }
  }
  float* out = q.out + (long long)zy * q.X + x0;
  const float c = -q.limit;
  if (q.X % 4 == 0 && clear[0] && clear[1] && clear[2] && clear[3]) {
    *(float4*)out = make_float4(c, c, c, c);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (clear[k]) out[k] = c;
  }
}

// blocks [0, clear_blocks): CLEAR_QUADS quads (four voxels along x) a
// thread, the unlisted voxels cleared; then `chunks` blocks a list entry,
// a thread a voxel of the listed brick
__global__ void __launch_bounds__(INT_THREADS)
    integrate_kernel(const IntegrateParams q) {
  const int v = q.v;
  if ((int)blockIdx.x < q.clear_blocks) {
    const int quads = q.Z * q.Y * ((q.X + 3) >> 2);
    const int i0 = blockIdx.x * INT_THREADS * CLEAR_QUADS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < CLEAR_QUADS; ++k)
      if (i0 + k * INT_THREADS < quads) clear_quad(q, i0 + k * INT_THREADS);
    return;
  }
  const int e = blockIdx.x - q.clear_blocks;
  const int j = e / q.chunks;
  const long long id = q.ids[j];
  const long long B = (long long)q.Bz * q.By * q.Bx;
  const int lv = (e - j * q.chunks) * INT_THREADS + threadIdx.x;
  if (id < 0 || id >= B || lv >= q.V) return;
  const int b = (int)id;
  const int bxi = b % q.Bx, byz = b / q.Bx;
  const int byi = byz % q.By, bzi = byz / q.By;
  const int lz = lv / (v * v), lyx = lv - lz * v * v;
  const int ly = lyx / v, lx = lyx - ly * v;
  const int z = bzi * v + lz, y = byi * v + ly, x = bxi * v + lx;
  if (z >= q.Z || y >= q.Y || x >= q.X) return;
  q.out[((long long)z * q.Y + y) * q.X + x] = integrate_voxel(q, b, lv);
}

// the launch's blocks: {clear blocks, brick blocks a list entry}
void integrate_blocks(const IntegrateParams& q, int* clear, int* chunks) {
  const long long quads = (long long)q.Z * q.Y * ((q.X + 3) / 4);
  *clear = (int)((quads + INT_THREADS * CLEAR_QUADS - 1) /
                 (INT_THREADS * CLEAR_QUADS));
  *chunks = (q.V + INT_THREADS - 1) / INT_THREADS;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// out: {blocks, threads, shared bytes, shared histogram (1) or global (0)}:
// every block resident at once (a cooperative launch)
void mark_plan(const MarkParams& q, int* out) {
  const long long pixels = (long long)q.N * q.Hs * q.Ws;
  const long long bins = (long long)q.bx * q.by * q.bz;
  const bool smem = bins * 4 <= MARK_SMEM_MAX;
  const int shared = smem ? (int)(bins * 4) : 0;
  int resident = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, smem ? mark_kernel<true> : mark_kernel<false>, MARK_THREADS,
      shared);
  const long long want =
      (pixels + (long long)MARK_THREADS * MARK_PIXELS_PER_THREAD - 1) /
      ((long long)MARK_THREADS * MARK_PIXELS_PER_THREAD);
  const long long cap =
      (long long)sm_count() * min(MARK_BLOCKS_PER_SM, max(resident, 1));
  const long long blocks = want < 1 ? 1 : (want > cap ? cap : want);
  out[0] = (int)blocks;
  out[1] = MARK_THREADS;
  out[2] = shared;
  out[3] = smem ? 1 : 0;
}

}  // namespace

extern "C" {

int rgbd_fuse_params_sizes(int* out) {
  out[0] = (int)sizeof(MarkParams);
  out[1] = (int)sizeof(IntegrateParams);
  return 0;
}

int rgbd_brick_mark_plan(const MarkParams* q, int* out) {
  mark_plan(*q, out);
  return 0;
}

// one cooperative launch, which also zeroes the counts
int rgbd_brick_mark(const MarkParams* q, void* stream) {
  long long bins = (long long)q->bx * q->by * q->bz;
  long long pixels = (long long)q->N * q->Hs * q->Ws;
  if (bins <= 0 || bins >= (1ll << 31) || q->N < 0 || q->Hs < 0 ||
      q->Ws < 0 || q->stride < 1 || pixels >= (1ll << 31) ||
      q->counts == nullptr)
    return (int)cudaErrorInvalidValue;
  int plan[4];
  mark_plan(*q, plan);
  int nbins = (int)bins, npixels = (int)pixels;
  void* args[] = {(void*)q, &npixels, &nbins};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      plan[3] ? (const void*)mark_kernel<true>
              : (const void*)mark_kernel<false>,
      dim3(plan[0]), dim3(MARK_THREADS), args, (size_t)plan[2],
      (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// out: {clear blocks, brick blocks, threads}
int rgbd_brick_integrate_plan(const IntegrateParams* q, int* out) {
  int clear, chunks;
  integrate_blocks(*q, &clear, &chunks);
  out[0] = clear;
  out[1] = chunks * q->capacity;
  out[2] = INT_THREADS;
  return 0;
}

int rgbd_brick_integrate(const IntegrateParams* q, void* stream) {
  if (q->v < 1 || q->N < 0 || q->H < 1 || q->W < 1 || q->Z < 0 ||
      q->Y < 0 || q->X < 0 || q->capacity < 0 ||
      (long long)q->Z * q->Y * (q->X + 3) >= (1ll << 31) ||
      (q->X % 4 == 0 && ((uintptr_t)q->out % 16) != 0))
    return (int)cudaErrorInvalidValue;
  IntegrateParams p = *q;
  integrate_blocks(p, &p.clear_blocks, &p.chunks);
  const long long blocks =
      (long long)p.clear_blocks + (long long)p.chunks * p.capacity;
  if ((long long)q->Z * q->Y * q->X == 0 || blocks == 0)
    return (int)cudaGetLastError();
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  integrate_kernel<<<(unsigned)blocks, INT_THREADS, 0,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out: {registers, static shared bytes, local (spill) bytes} of kernel
// `which`: 0 mark (shared histogram), 1 mark (global), 2 integrate
int rgbd_fuse_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)mark_kernel<true>
                   : which == 1 ? (const void*)mark_kernel<false>
                                : (const void*)integrate_kernel;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
