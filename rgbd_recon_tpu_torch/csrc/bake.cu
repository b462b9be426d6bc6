// March-volume bake: the surface-brick mask and the sentinel-coded bf16
// march table.
//
// Replaces the Pallas TPU kernels surface_occ_tpu and sentinel_bake_tpu of
// rgbd_recon_tpu/ops/bake_pallas.py.
//
// surface_occ: one block per brick. A brick is set iff some voxel of its
// box, grown by one voxel on each side and clipped to the volume, is > 0
// (the brick any-pool of the 1-voxel box dilation of volume > 0, with zero
// padding at the faces). Bound: one read of the volume (35 MB at 200x220x200)
// plus the 1-voxel halo re-reads (a thread stops at its first positive
// voxel), so the kernel is a DRAM stream.
//
// sentinel_bake: the Chebyshev distance to the nearest positive voxel,
// capped at K+1, computed separably in three passes (x, then y, then z) over
// a uint8 scratch volume, each pass one thread per voxel reading 2K+1
// neighbours along its axis; the z pass also encodes the output:
//   fine_safe = clamp(cheb - 1, 0, K)
//   field     = max(fine_safe, bs_scaled[brick of the voxel])
//   out       = field > 0 ? -(2 + field) : tsdf value, rounded to bf16 (RNE).
// For L-infinity distance the separable min-max passes are exact. Bound:
// DRAM traffic of one f32 volume read, three uint8 scratch round trips and
// one bf16 write (~85 MB at reference scale); the neighbour reads along an
// axis hit L1/L2. Every value is an integer or a copy until the single
// bf16 rounding, so the output is bit-exact against the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void surface_occ_kernel(const float* __restrict__ vol,
                                   unsigned char* __restrict__ out, int Z,
                                   int Y, int X, int v, int By, int Bx) {
  const int b = blockIdx.x;
  const int bz = b / (By * Bx);
  const int by = (b / Bx) % By;
  const int bx = b % Bx;
  const int z0 = max(bz * v - 1, 0), z1 = min(bz * v + v, Z - 1);
  const int y0 = max(by * v - 1, 0), y1 = min(by * v + v, Y - 1);
  const int x0 = max(bx * v - 1, 0), x1 = min(bx * v + v, X - 1);
  const int nz = z1 - z0 + 1, ny = y1 - y0 + 1, nx = x1 - x0 + 1;
  const int total = nz * ny * nx;
  int found = 0;
  for (int i = threadIdx.x; i < total && !found; i += blockDim.x) {
    const int lz = i / (ny * nx);
    const int ly = (i / nx) % ny;
    const int lx = i % nx;
    found = vol[((size_t)(z0 + lz) * Y + (y0 + ly)) * X + (x0 + lx)] > 0.0f;
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) out[b] = found ? 1 : 0;
}

// pass 1: distance along x to the nearest positive voxel, capped at K+1
__global__ void cheb_x_kernel(const float* __restrict__ vol,
                              uint8_t* __restrict__ dist, int Z, int Y, int X,
                              int K) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)Z * Y * X;
  if (i >= n) return;
  const int x = (int)(i % X);
  const float* row = vol + (i - x);
  int best = K + 1;
  for (int d = -K; d <= K; ++d) {
    const int xx = x + d;
    if (xx < 0 || xx >= X) continue;
    const int a = d < 0 ? -d : d;
    if (a < best && row[xx] > 0.0f) best = a;
  }
  dist[i] = (uint8_t)best;
}

// pass 2: min over dy of max(|dy|, x-distance), capped at K+1
__global__ void cheb_y_kernel(const uint8_t* __restrict__ src,
                              uint8_t* __restrict__ dst, int Z, int Y, int X,
                              int K) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)Z * Y * X;
  if (i >= n) return;
  const int y = (int)((i / X) % Y);
  int best = K + 1;
  for (int d = -K; d <= K; ++d) {
    const int yy = y + d;
    if (yy < 0 || yy >= Y) continue;
    const int a = d < 0 ? -d : d;
    const int s = src[i + (ptrdiff_t)d * X];
    const int m = a > s ? a : s;
    if (m < best) best = m;
  }
  dst[i] = (uint8_t)best;
}

// pass 3: min over dz, then the sentinel encode and the bf16 cast
__global__ void cheb_z_encode_kernel(const uint8_t* __restrict__ src,
                                     const float* __restrict__ vol,
                                     const float* __restrict__ bs_scaled,
                                     __nv_bfloat16* __restrict__ out, int Z,
                                     int Y, int X, int K, int v, int By,
                                     int Bx) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)Y * X;
  const size_t n = (size_t)Z * plane;
  if (i >= n) return;
  const int z = (int)(i / plane);
  const int y = (int)((i / X) % Y);
  const int x = (int)(i % X);
  int best = K + 1;
  for (int d = -K; d <= K; ++d) {
    const int zz = z + d;
    if (zz < 0 || zz >= Z) continue;
    const int a = d < 0 ? -d : d;
    const int s = src[i + (ptrdiff_t)d * plane];
    const int m = a > s ? a : s;
    if (m < best) best = m;
  }
  const int fine = min(max(best - 1, 0), K);
  const float bs = bs_scaled[((size_t)(z / v) * By + (y / v)) * Bx + (x / v)];
  const float field = fmaxf((float)fine, bs);
  const float val = field > 0.0f ? -(2.0f + field) : vol[i];
  out[i] = __float2bfloat16_rn(val);
}

}  // namespace

extern "C" {

// (Z, Y, X) f32 volume -> (Bz, By, Bx) bool surface-brick mask.
int rgbd_surface_occ(const void* vol, void* out, int Z, int Y, int X,
                     int brick_vox, int Bz, int By, int Bx, void* stream) {
  surface_occ_kernel<<<Bz * By * Bx, 256, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (unsigned char*)out, Z, Y, X, brick_vox, By, Bx);
  return (int)cudaGetLastError();
}

// (Z, Y, X) f32 volume + (Bz, By, Bx) f32 brick clearance * brick_vox ->
// (Z, Y, X) bf16 march table. scratch_a/scratch_b are (Z, Y, X) uint8.
int rgbd_sentinel_bake(const void* vol, const void* bs_scaled, void* out,
                       void* scratch_a, void* scratch_b, int Z, int Y, int X,
                       int brick_vox, int rounds, int By, int Bx,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)Z * Y * X;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cheb_x_kernel<<<blocks, threads, 0, s>>>((const float*)vol,
                                           (uint8_t*)scratch_a, Z, Y, X,
                                           rounds);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cheb_y_kernel<<<blocks, threads, 0, s>>>((const uint8_t*)scratch_a,
                                           (uint8_t*)scratch_b, Z, Y, X,
                                           rounds);
  err = (int)cudaGetLastError();
  if (err) return err;
  cheb_z_encode_kernel<<<blocks, threads, 0, s>>>(
      (const uint8_t*)scratch_b, (const float*)vol, (const float*)bs_scaled,
      (__nv_bfloat16*)out, Z, Y, X, rounds, brick_vox, By, Bx);
  return (int)cudaGetLastError();
}

}  // extern "C"
