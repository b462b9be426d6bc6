// Gather-rate probe: four gathers of f32 values by i32 indices.
//
// Replaces the Pallas TPU kernels of scripts/probe_pallas_gather.py:
//   pallas_take  (:78)  out = table[idx], the table resident in VMEM
//   pallas_take2 (:95)  jnp.take(table, idx, axis=0): the same function
//   pallas_taa   (:116) take_along_axis(t, i, axis=1) on (8, 2^17)
//   pallas_taas  (:135) take_along_axis(t, i, axis=0) on (2^13, 128)
// The TPU probe asks whether a kernel can gather at speed from a table held
// in on-chip memory (16+ MiB of VMEM took its 4 MiB table). On Hopper the
// on-chip memory a block can address is at most 227 KiB of shared memory,
// so the probe's question splits in two:
//   gather_flat       one thread per lookup, the table read through the
//                     read-only path (__ldg). The 4 MiB table stays in the
//                     50 MB L2 after the first touches: the card's
//                     counterpart of the VMEM-resident table.
//   gather_flat_smem  the table staged in shared memory: a persistent grid
//                     (as many blocks as fit on the SMs), each block loads
//                     the table once and strides over the lookups. Tables
//                     of at most the opt-in shared memory of a block
//                     (232,448 bytes on the H100: 58,112 entries).
//   gather_rows       out[r, j] = t[r, i[r, j]]  (take_along_axis, axis 1)
//   gather_cols       out[m, c] = t[i[m, c], c]  (take_along_axis, axis 0)
// Bound: bytes. The function reads the indices once and writes the output
// once (4 + 4 bytes a lookup) and reads the table once: 12.6 MB at the
// probe's 2^20 lookups into 2^20 entries, 3.76 us at 3.35 TB/s. A random
// 4-byte lookup moves a whole 32-byte L2 sector, so a lookup costs at least
// 32 bytes of L2 traffic (33.5 MB at 2^20 lookups) wherever the table lies
// outside shared memory: the bound counts what the function must move, not
// what the memory system moves for it.
// gather_flat and gather_cols stay one lookup a thread. A design of 4 or 8
// lookups a thread (16-byte index loads and stores, a persistent grid) was
// measured on the H100 no faster at the probe's uniform random indices:
// there the card's rate of random 32-byte sectors from L2 (about 120 G
// lookups/s, for these kernels and torch.take alike) sets the time, not
// the instructions. PERF.md (gather probe) has the figures.
// Indices are i32 in [0, n) for a table of n entries along the gathered
// axis: the probe never makes any other. Out of range the JAX references
// disagree (negatives wrap in jnp indexing, table[idx] clamps, jnp.take
// and take_along_axis fill with NaN; the Pallas kernels read VMEM outside
// the table, undefined), so out-of-range indices are not part of the
// contract: these kernels clamp them into the table only so as never to
// read outside it. Every value is a copy, so the output is bit-exact
// against the plain versions (ops/gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // a block of the three streaming kernels
constexpr int SMEM_THREADS = 1024;  // a block of the shared-memory kernel

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

__global__ void gather_flat_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int n, int size) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = __ldg(table + clamp_index(__ldg(idx + i), size));
}

// Each block stages the whole table in shared memory (float4 loads where
// the table is 16-byte aligned), then its threads stride over the lookups
// with the grid's whole width, neighbouring threads on neighbouring
// lookups. With n = 0 the launch only stages the table: the probe times
// that load on its own.
__global__ void __launch_bounds__(SMEM_THREADS)
gather_flat_smem_kernel(const float* __restrict__ table,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int n, int size) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(table);
    const int n4 = size / 4;
    for (int j = threadIdx.x; j < n4; j += SMEM_THREADS) smem4[j] = __ldg(t4 + j);
    head = n4 * 4;
  }
  for (int j = head + threadIdx.x; j < size; j += SMEM_THREADS)
    tab[j] = __ldg(table + j);
  __syncthreads();
  const long long stride = (long long)gridDim.x * SMEM_THREADS;
  for (long long i = (long long)blockIdx.x * SMEM_THREADS + threadIdx.x;
       i < n; i += stride)
    out[i] = tab[clamp_index(__ldg(idx + i), size)];
}

// out (R, M) from t (R, C) and i (R, M): one thread per output.
__global__ void gather_rows_kernel(const float* __restrict__ t,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int R, int C,
                                   int M) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= R * M) return;
  const int r = k / M;
  out[k] = __ldg(t + (long long)r * C + clamp_index(__ldg(idx + k), C));
}

// out (M, C) from t (R, C) and i (M, C): one thread per output.
__global__ void gather_cols_kernel(const float* __restrict__ t,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int R, int C,
                                   int M) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= M * C) return;
  const int c = k % C;
  out[k] = __ldg(t + (long long)clamp_index(__ldg(idx + k), R) * C + c);
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// out[i] = table[idx[i]] for the n lookups; table holds size f32 entries.
int rgbd_gather_flat(const void* table, const void* idx, void* out, int n,
                     int size, void* stream) {
  if (n <= 0) return 0;
  gather_flat_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, n, size);
  return (int)cudaGetLastError();
}

// The entries of the largest table gather_flat_smem takes on the current
// device (its opt-in shared memory per block over 4 bytes).
int rgbd_gather_smem_entries(int* entries) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *entries = bytes / (int)sizeof(float);
  return (int)err;
}

// out[i] = table[idx[i]] from a shared-memory copy of the table, on a
// persistent grid: as many blocks as fit on the SMs at this table size,
// fewer when the lookups fill fewer. n = 0 launches the full grid, which
// only stages the table.
int rgbd_gather_flat_smem(const void* table, const void* idx, void* out,
                          int n, int size, void* stream) {
  const int bytes = size * (int)sizeof(float);
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (size <= 0 || bytes > limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gather_flat_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_flat_smem_kernel, SMEM_THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (n > 0) {
    const int fill = (n + SMEM_THREADS - 1) / SMEM_THREADS;
    grid = fill < grid ? fill : grid;
  }
  gather_flat_smem_kernel<<<grid, SMEM_THREADS, bytes,
                            (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, n, size);
  return (int)cudaGetLastError();
}

// take_along_axis(t, i, axis=1): t (R, C), i and out (R, M).
int rgbd_gather_rows(const void* t, const void* idx, void* out, int R, int C,
                     int M, void* stream) {
  if (R * M <= 0) return 0;
  gather_rows_kernel<<<blocks_for(R * M), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)idx, (float*)out, R, C, M);
  return (int)cudaGetLastError();
}

// take_along_axis(t, i, axis=0): t (R, C), i and out (M, C).
int rgbd_gather_cols(const void* t, const void* idx, void* out, int R, int C,
                     int M, void* stream) {
  if (M * C <= 0) return 0;
  gather_cols_kernel<<<blocks_for(M * C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)idx, (float*)out, R, C, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
