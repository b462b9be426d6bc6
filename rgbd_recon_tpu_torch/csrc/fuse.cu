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
// brick_mark: a sampled pixel (n, s/2 + s i, s/2 + s j) with a depth d,
// 0 < d < 1, adds `add` (= s^2) to the count of the brick of its world
// point (ray_a + ray_b d from the pixel models, or read from `worlds`)
// and, where |diff.x| > border (the reference's x-only border test), to
// the neighbour brick along the dominant offset. A warp takes 32 x
// MARK_UNROLL consecutive pixels, a lane MARK_UNROLL of them, every load
// of its pixels (depth and world inputs, predicated on validity only
// after) in one round. The counts are integers, so any order of the
// adds gives the same counts. Where the counts fit in shared memory
// (MARK_SMEM_MAX bytes: 8,800 bricks of 10 cm, 35.2 KB), each lane adds
// into its block's histogram there and a first add lists its bin; the
// block then adds only the bins it listed to the counts (all of its bins
// past MARK_LIST_MAX listed). Otherwise (5 cm bricks: 70,400) the adds go
// to the counts in global memory, warp-aggregated: __match_any_sync
// groups the lanes of one brick and its lowest lane adds popc x add (an
// atomic a lane measured 3x slower there; in shared memory aggregating
// measured slower than an atomic a lane). The
// launch zeroes the counts itself: it is cooperative (every block
// resident, at most MARK_BLOCKS_PER_SM an SM and at least one block an SM
// while the pixels last), its blocks zero their share and meet at one
// grid barrier, just before the flush with a histogram (the pixel loop
// runs meanwhile), before the first add without. Bound: bytes (the
// sampled depth and the two ray planes, 28 B a pixel, and the counts).
//
// brick_integrate: one launch of two kinds of thread block over the dense
// (Z, Y, X) volume. ops/compact.py's list of the occupied bricks (the first
// `capacity`, ascending, padded with B) and its slot map (-1 for a brick
// not listed: unoccupied, or past the capacity) say which bricks are
// integrated. The two kinds are interleaved evenly through the grid, so
// that on every SM the clear's stores fill the memory pipe while the brick
// blocks wait on their rounds of loads (list entry, rows, taps).
//  - Brick blocks: an item a block, INT_THREADS voxels of one listed brick
//    in its row order (ceil(V / INT_THREADS) items a list entry), a thread
//    a voxel. A voxel loads its sensors' projection rows (u, v,
//    depth_norm, +-1: one float4 a voxel, a sensor's rows whole lines)
//    SENSOR_CHUNK at a time, taps the maps (nearest: depth in f32, quality
//    and silhouette rounded to bf16; bilinear: the four-corner rule of
//    ops/sampling.py quad_bilinear), folds the sensors in registers
//    (ops/tsdf.py fuse_sensor), applies the phantom-hull rule and writes
//    its voxel of the dense volume; a padding entry and the voxels of a
//    brick past the volume's edge write nothing. The kernel is an instance
//    a tap rule, so the nearest taps hold no bilinear registers: 40 under
//    launch bounds of INT_BLOCKS_NEAREST blocks an SM (no spills), 64 for
//    the bilinear taps (48 under 5 blocks an SM ran 6% slower).
//  - Clear blocks: a warp CLEAR_ROWS x-rows of the volume, each row's
//    (z, y) and bricks worked out once (multiply and shift), its bricks'
//    listed flags read once as a ballot bit mask of 32 bricks; the voxels
//    of unlisted bricks take the clear value -limit, a lane a quad of four
//    voxels along x, stored as one float4 where all four clear and X % 4
//    == 0 (a quad that straddles a listed brick's edge by scalar stores).
// The two write disjoint voxels, each once. The (N, K, V) gathers and the
// (B, V) brick-major volume of the plain version are never built. Bound:
// bytes (the volume written once, the listed bricks' projection rows, the
// maps). bench/fuse_split.py measures the other forms (PERF.md §6); each
// ran slower on both recorded fuses: the brick blocks all before the
// clear blocks, a brick's rows copied into shared memory by 1-D bulk
// copies on an mbarrier (a block an item, a block a brick of 1,024
// threads, persistent brick blocks with a ring of two stages: the taps'
// latency then has too few threads to hide behind), 512 voxels an item.
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
// consecutive pixels a lane loads in one round (a warp 32 x this many;
// 2 and 4 measured slower than more warps)
constexpr int MARK_UNROLL = 1;
constexpr int MARK_BLOCKS_PER_SM = 4;
// the shared histogram's limit (no opt-in above 48 KB); its touched-bin
// list takes what is left of it, at most MARK_LIST_MAX bins
constexpr int MARK_SMEM_MAX = 48 * 1024;
constexpr int MARK_LIST_MAX = 2048;
constexpr int INT_THREADS = 256;
// sensors whose projection rows a voxel loads before their taps and folds
constexpr int SENSOR_CHUNK = 4;
// blocks an SM the integrate's registers leave room for, a tap rule each
// (nearest: 40 registers, no spills; bilinear: its 64)
constexpr int INT_BLOCKS_NEAREST = 6;
constexpr int INT_BLOCKS_BILINEAR = 4;
// x-rows of the volume a warp of a clear block clears
constexpr int CLEAR_ROWS = 4;

// v // d for 0 <= v < 2^31 as (v * magic) >> shift, magic =
// ceil(2^shift / d), shift = 31 + ceil(log2 d): exact, since
// (magic * d - 2^shift) * v < d * 2^31 <= 2^shift
struct Divisor {
  unsigned long long magic;
  unsigned shift;
};

Divisor divisor(int d) {
  if (d < 1) d = 1;  // an empty axis: never divided by
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

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

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
  float limit, carve;
};

namespace {

// ---- the marking ------------------------------------------------------------

// what a mark launch works out on the host
struct MarkShape {
  Divisor per, ws;           // the sampled pixels a sensor, a row
  int pixels, bins, list_cap;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// a NaN-propagating max, as torch's max reduction
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fffffff);
  return a > b ? a : b;
}

// a sampled pixel's inputs: its depth and its world inputs (the two
// ray-model rows, or its row of worlds in a)
struct PixelIn {
  float d, a[3], b[3];
};

__device__ __forceinline__ void pixel_loads(const MarkParams& q,
                                            const MarkShape& s, int p,
                                            PixelIn& in) {
  const int n = div_by(p, s.per);
  const int rem = p - n * q.Hs * q.Ws;
  const int i = div_by(rem, s.ws), j = rem - i * q.Ws;
  const int h = q.stride / 2 + q.stride * i;
  const int w = q.stride / 2 + q.stride * j;
  in.d = q.depth[n * q.ds[0] + h * q.ds[1] + w * q.ds[2]];
  if (q.worlds != nullptr) {
    const float* wp = q.worlds + n * q.ws[0] + i * q.ws[1] + j * q.ws[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) in.a[c] = wp[c * q.ws[3]];
  } else {
    const float* ap = q.ray_a + n * q.sa[0] + h * q.sa[1] + w * q.sa[2];
    const float* bp = q.ray_b + n * q.sb[0] + h * q.sb[1] + w * q.sb[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in.a[c] = ap[c * q.sa[3]];
      in.b[c] = bp[c * q.sb[3]];
    }
  }
}

// the pixel's brick and neighbour (-1: no add) from its inputs
__device__ __forceinline__ void pixel_keys(const MarkParams& q,
                                           const PixelIn& in,
                                           const float bmin[3], int* own,
                                           int* nbr) {
  *own = *nbr = -1;
  const float d = in.d;
  if (!(d > 0.0f && d < 1.0f)) return;
  float pt[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    pt[c] = q.worlds != nullptr
                ? in.a[c]
                : __fadd_rn(in.a[c], __fmul_rn(in.b[c], d));
  const int hi[3] = {q.bx - 1, q.by - 1, q.bz - 1};
  int idx[3];
  float diff[3], dab[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rel = __fmul_rn(__fsub_rn(pt[c], bmin[c]), q.inv_brick);
    idx[c] = clampi(__float2int_rz(floorf(rel)), 0, hi[c]);
    const float centre = __fadd_rn(
        __fmul_rn(__fadd_rn((float)idx[c], 0.5f), q.brick), bmin[c]);
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
  if (dab[0] > q.border) *nbr = (nidx[2] * q.by + nidx[1]) * q.bx + nidx[0];
}

// one add of `key` a lane (-1: none). Into a shared histogram each lane
// adds its own (a first add lists its bin); to the counts in global
// memory the adds are aggregated over the warp: __match_any_sync groups
// the lanes of one brick and the lowest lane adds popc x add. Every lane
// of the warp calls it.
template <bool SMEM>
__device__ __forceinline__ void warp_add(int* dst, int key, int add,
                                         int* list, int* listed,
                                         int list_cap) {
  if (SMEM) {
    if (key < 0) return;
    if (atomicAdd(dst + key, add) == 0) {
      const int i = atomicAdd(listed, 1);
      if (i < list_cap) list[i] = key;
    }
    return;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key < 0 || (int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  atomicAdd(dst + key, __popc(peers) * add);
}

// the marking: the counts zeroed, the pixels' warp-aggregated adds
// (through a shared histogram a block when SMEM, else to global memory),
// one grid barrier before the first add to the counts
template <bool SMEM>
__global__ void __launch_bounds__(MARK_THREADS)
    mark_kernel(const MarkParams q, const MarkShape s) {
  extern __shared__ int4 mark_smem[];
  int* hist = reinterpret_cast<int*>(mark_smem);
  int* list = hist + s.bins;
  __shared__ int listed;
  const int tid = threadIdx.x;
  for (int k = blockIdx.x * MARK_THREADS + tid; k < s.bins;
       k += gridDim.x * MARK_THREADS)
    q.counts[k] = 0;
  if (SMEM) {
    for (int k = tid; k < (s.bins >> 2); k += MARK_THREADS)
      mark_smem[k] = make_int4(0, 0, 0, 0);
    for (int k = (s.bins & ~3) + tid; k < s.bins; k += MARK_THREADS)
      hist[k] = 0;
    if (tid == 0) listed = 0;
    __syncthreads();
  } else {
    cooperative_groups::this_grid().sync();
  }
  int* dst = SMEM ? hist : q.counts;
  const float bmin[3] = {q.bbox_min[0], q.bbox_min[1], q.bbox_min[2]};
  constexpr int WARP_PIXELS = 32 * MARK_UNROLL;
  const long long warps = (long long)gridDim.x * (MARK_THREADS / 32);
  for (long long w = (long long)blockIdx.x * (MARK_THREADS / 32) + (tid >> 5);
       w * WARP_PIXELS < s.pixels; w += warps) {
    const int p0 = (int)(w * WARP_PIXELS) + (tid & 31);
    PixelIn in[MARK_UNROLL];
#pragma unroll
    for (int k = 0; k < MARK_UNROLL; ++k)
      if (p0 + 32 * k < s.pixels) pixel_loads(q, s, p0 + 32 * k, in[k]);
#pragma unroll
    for (int k = 0; k < MARK_UNROLL; ++k) {
      int own = -1, nbr = -1;
      if (p0 + 32 * k < s.pixels) pixel_keys(q, in[k], bmin, &own, &nbr);
      warp_add<SMEM>(dst, own, q.add, list, &listed, s.list_cap);
      warp_add<SMEM>(dst, nbr, q.add, list, &listed, s.list_cap);
    }
  }
  if (SMEM) {
    // every block's share of the counts is zeroed (and this block's adds
    // are in its histogram) past the barrier
    cooperative_groups::this_grid().sync();
    const int n = listed;
    if (n <= s.list_cap) {
      for (int i = tid; i < n; i += MARK_THREADS)
        atomicAdd(q.counts + list[i], hist[list[i]]);
    } else {
      for (int k = tid; k < s.bins; k += MARK_THREADS) {
        const int c = hist[k];
        if (c != 0) atomicAdd(q.counts + k, c);
      }
    }
  }
}

// ---- the integration ----------------------------------------------------------

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
template <bool BILINEAR>
__device__ __forceinline__ float3 sensor_taps(const IntegrateParams& q,
                                              int n, float4 r) {
  const float fW = (float)q.W, fH = (float)q.H;
  if (BILINEAR) {
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

// ---- the clear blocks -------------------------------------------------------

// clear block cb: each warp's CLEAR_ROWS x-rows, the voxels of unlisted
// bricks set to -limit
__device__ __forceinline__ void clear_rows(const IntegrateParams& q,
                                           const Divisor& dY,
                                           const Divisor& dv, int cb) {
  const int lane = threadIdx.x & 31;
  const int ZY = q.Z * q.Y;
  const int r0 =
      (cb * (INT_THREADS / 32) + (int)(threadIdx.x >> 5)) * CLEAR_ROWS;
  if (r0 >= ZY) return;
  int row_b[CLEAR_ROWS];
#pragma unroll
  for (int k = 0; k < CLEAR_ROWS; ++k) {
    const int zy = min(r0 + k, ZY - 1);
    const int z = div_by(zy, dY), y = zy - z * q.Y;
    row_b[k] = (div_by(z, dv) * q.By + div_by(y, dv)) * q.Bx;
  }
  const float c = -q.limit;
  const float4 c4 = make_float4(c, c, c, c);
  const bool vec = (q.X & 3) == 0;
  for (int b0 = 0; b0 < q.Bx; b0 += 32) {
    // bit i of clear[k]: brick b0 + i of row k is not listed
    unsigned clear[CLEAR_ROWS];
    const bool in_row = b0 + lane < q.Bx;
    int sl[CLEAR_ROWS];
#pragma unroll
    for (int k = 0; k < CLEAR_ROWS; ++k)
      sl[k] = in_row ? q.slot[row_b[k] + b0 + lane] : 0;
#pragma unroll
    for (int k = 0; k < CLEAR_ROWS; ++k)
      clear[k] = __ballot_sync(0xffffffffu, sl[k] < 0);
    // the segment's voxels: a multiple of 4 from its first (32 v is)
    const int x_lo = b0 * q.v, x_hi = min(q.X, (b0 + 32) * q.v);
#pragma unroll
    for (int k = 0; k < CLEAR_ROWS; ++k) {
      if (r0 + k >= ZY || clear[k] == 0) continue;
      float* out = q.out + (long long)(r0 + k) * q.X;
      for (int x0 = x_lo + 4 * lane; x0 < x_hi; x0 += 128) {
        int bq = div_by(x0, dv);
        int l = x0 - bq * q.v;
        bq -= b0;
        unsigned m = 0;  // bit i: voxel x0 + i is cleared
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (x0 + i < x_hi && ((clear[k] >> bq) & 1u)) m |= 1u << i;
          if (++l == q.v) {
            l = 0;
            ++bq;
          }
        }
        if (m == 15u && vec) {
          *reinterpret_cast<float4*>(out + x0) = c4;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if ((m >> i) & 1u) out[x0 + i] = c;
        }
      }
    }
  }
}

// ---- the brick blocks and the launch's shape ---------------------------------

// what an integrate launch works out on the host
struct IntegrateShape {
  Divisor Y, v;              // a row's z and y; a coordinate's brick
  int brick_blocks;          // an item a block: capacity x chunks
  int clear_blocks;          // CLEAR_ROWS rows a warp
  int chunks;                // items a list entry (INT_THREADS voxels each)
};

// item w: its list entry's brick, INT_THREADS of its voxels in row order,
// a thread a voxel, the voxel's sensors' projection rows loaded
// SENSOR_CHUNK at a time before their taps and folds
template <bool BILINEAR>
__device__ __forceinline__ void brick_item(const IntegrateParams& q,
                                           const IntegrateShape& s, int w) {
  const int j = w / s.chunks;
  const long long id = q.ids[j];
  const long long B = (long long)q.Bz * q.By * q.Bx;
  const int lv = (w - j * s.chunks) * INT_THREADS + threadIdx.x;
  if (id < 0 || id >= B || lv >= q.V) return;
  const int b = (int)id, v = q.v;
  const int bxi = b % q.Bx, byz = b / q.Bx;
  const int byi = byz % q.By, bzi = byz / q.By;
  const int lz = lv / (v * v), lyx = lv - lz * v * v;
  const int ly = lyx / v, lx = lyx - ly * v;
  const int z = bzi * v + lz, y = byi * v + ly, x = bxi * v + lx;
  if (z >= q.Z || y >= q.Y || x >= q.X) return;
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
        fuse_sensor(tsd, total_w, r[k],
                    sensor_taps<BILINEAR>(q, n0 + k, r[k]), limit, q.carve);
  }
  if (!q.phantom_hull && total_w <= 0.0f && tsd >= limit) tsd = -limit;
  q.out[((long long)z * q.Y + y) * q.X + x] = tsd;
}

// the brick blocks and the clear blocks interleaved evenly through the
// grid: block i is a brick block where (i + 1) P / total passes a whole
// number, P the brick blocks
template <bool BILINEAR>
__global__ void __launch_bounds__(INT_THREADS, BILINEAR ? INT_BLOCKS_BILINEAR
                                                        : INT_BLOCKS_NEAREST)
    integrate_kernel(const IntegrateParams q, const IntegrateShape s) {
  const int total = s.brick_blocks + s.clear_blocks;
  const int i = blockIdx.x;
  const int before = (int)((long long)i * s.brick_blocks / total);
  const int upto = (int)((long long)(i + 1) * s.brick_blocks / total);
  if (upto > before)
    brick_item<BILINEAR>(q, s, before);
  else
    clear_rows(q, s.Y, s.v, i - before);
}

// the launch's shape and dynamic shared bytes (none)
IntegrateShape integrate_shape(const IntegrateParams& q, int* shared) {
  IntegrateShape s;
  s.Y = divisor(q.Y);
  s.v = divisor(q.v);
  s.chunks = (q.V + INT_THREADS - 1) / INT_THREADS;
  s.brick_blocks = (int)min((long long)q.capacity * s.chunks, 1ll << 30);
  const long long rows = (long long)q.Z * q.Y;
  const int per_block = (INT_THREADS / 32) * CLEAR_ROWS;
  s.clear_blocks = (int)((rows + per_block - 1) / per_block);
  *shared = 0;
  return s;
}

// ---- launch plans -----------------------------------------------------------

// out: {blocks, threads, shared bytes, shared histogram (1) or global (0),
// touched-bin list capacity}: every block resident at once (a
// cooperative launch), at least one an SM while the pixels last
void mark_plan(const MarkParams& q, int* out) {
  const long long pixels = (long long)q.N * q.Hs * q.Ws;
  const long long bins = (long long)q.bx * q.by * q.bz;
  const bool smem = bins * 4 <= MARK_SMEM_MAX;
  const int list_cap =
      smem ? (int)min((long long)MARK_LIST_MAX, (MARK_SMEM_MAX - bins * 4) / 4)
           : 0;
  const int shared = smem ? (int)(bins * 4) + list_cap * 4 : 0;
  int resident = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, smem ? mark_kernel<true> : mark_kernel<false>, MARK_THREADS,
      shared);
  const int sms = sm_count();
  const long long warp_pixels = 32ll * MARK_UNROLL;
  const long long chunks = (pixels + warp_pixels - 1) / warp_pixels;
  const long long want = (chunks + MARK_THREADS / 32 - 1) / (MARK_THREADS / 32);
  const long long cap = (long long)sms * min(MARK_BLOCKS_PER_SM,
                                             max(resident, 1));
  const long long blocks =
      max(1ll, min(cap, max(want, min(chunks, (long long)sms))));
  out[0] = (int)blocks;
  out[1] = MARK_THREADS;
  out[2] = shared;
  out[3] = smem ? 1 : 0;
  out[4] = list_cap;
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
  int plan[5];
  mark_plan(*q, plan);
  MarkShape s;
  s.per = divisor(q->Hs * q->Ws);
  s.ws = divisor(q->Ws);
  s.pixels = (int)pixels;
  s.bins = (int)bins;
  s.list_cap = plan[4];
  void* args[] = {(void*)q, &s};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      plan[3] ? (const void*)mark_kernel<true>
              : (const void*)mark_kernel<false>,
      dim3(plan[0]), dim3(MARK_THREADS), args, (size_t)plan[2],
      (cudaStream_t)stream);
  // a refused launch's error is cleared, so the next launch reports its own
  if (err != cudaSuccess) cudaGetLastError();
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// out: {brick blocks, clear blocks, threads, dynamic shared bytes, items,
// items a list entry}
int rgbd_brick_integrate_plan(const IntegrateParams* q, int* out) {
  int shared;
  const IntegrateShape s = integrate_shape(*q, &shared);
  out[0] = s.brick_blocks;
  out[1] = s.clear_blocks;
  out[2] = INT_THREADS;
  out[3] = shared;
  out[4] = (int)min((long long)q->capacity * s.chunks, 1ll << 30);
  out[5] = s.chunks;
  return 0;
}

int rgbd_brick_integrate(const IntegrateParams* q, void* stream) {
  if (q->v < 1 || q->N < 0 || q->H < 1 || q->W < 1 || q->Z < 0 ||
      q->Y < 0 || q->X < 0 || q->capacity < 0 ||
      (long long)q->Z * q->Y * (q->X + 3) >= (1ll << 31) ||
      (long long)q->capacity * ((q->V + INT_THREADS - 1) / INT_THREADS) >=
          (1ll << 30) ||
      (q->X % 4 == 0 && ((uintptr_t)q->out % 16) != 0) ||
      ((uintptr_t)q->proj % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int shared;
  const IntegrateShape s = integrate_shape(*q, &shared);
  const long long blocks = (long long)s.brick_blocks + s.clear_blocks;
  if ((long long)q->Z * q->Y * q->X == 0 || blocks == 0)
    return (int)cudaGetLastError();
  if (q->bilinear)
    integrate_kernel<true><<<(unsigned)blocks, INT_THREADS, (size_t)shared,
                             (cudaStream_t)stream>>>(*q, s);
  else
    integrate_kernel<false><<<(unsigned)blocks, INT_THREADS, (size_t)shared,
                              (cudaStream_t)stream>>>(*q, s);
  return (int)cudaGetLastError();
}

// out: {registers, static shared bytes, local (spill) bytes} of kernel
// `which`: 0 mark (shared histogram), 1 mark (global), 2 integrate
// (nearest taps), 3 integrate (bilinear taps)
int rgbd_fuse_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)mark_kernel<true>
                   : which == 1 ? (const void*)mark_kernel<false>
                   : which == 2 ? (const void*)integrate_kernel<false>
                                : (const void*)integrate_kernel<true>;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
