// Gather-rate probe: four gathers of f32 values by i32 indices.
//
// Replaces the Pallas TPU kernels of scripts/probe_pallas_gather.py:
//   pallas_take  (:78)  out = table[idx], the table resident in VMEM
//   pallas_take2 (:95)  jnp.take(table, idx, axis=0): the same function
//   pallas_taa   (:116) take_along_axis(t, i, axis=1) on (8, 2^17)
//   pallas_taas  (:135) take_along_axis(t, i, axis=0) on (2^13, 128)
// The TPU probe asks whether a kernel can gather at speed from a table held
// in on-chip memory (16+ MiB of VMEM took its 4 MiB table). On Hopper the
// on-chip memory a block can address is its own shared memory (at most
// 227 KiB) and, in a thread-block cluster, the shared memory of the
// cluster's other blocks (distributed shared memory), so the probe's
// question splits:
//   gather_flat       one thread per lookup, the table read through the
//                     read-only path (__ldg). The 4 MiB table stays in the
//                     50 MB L2 after the first touches: the card's
//                     counterpart of the VMEM-resident table.
//   gather_flat_smem  the table staged in shared memory: a persistent grid
//                     (as many blocks as fit on the SMs), each block loads
//                     the table once and strides over the lookups, 4 a
//                     thread at a time; each thread loads its first 4
//                     indices before the table. Tables of at most the
//                     opt-in shared memory of a block (232,448 bytes on the
//                     H100: 58,112 entries).
//   gather_rows       out[r, j] = t[r, i[r, j]]  (take_along_axis, axis 1),
//                     one thread per output, the row from L2.
//   gather_cols       out[m, c] = t[i[m, c], c]  (take_along_axis, axis 0)
// and the probe measures one more:
//   gather_rows_cluster  gather_rows with each row held in the shared
//                     memory of a cluster of ROWS_CS blocks (ROWS_CS_MAX
//                     for rows up to 1.77 MiB), each block's slice staged
//                     by bulk copy, every lookup read from the owning
//                     block (ld.shared::cluster). It answers the probe's
//                     question for rows past one block's shared memory.
// Bound: bytes. The function reads the indices once and writes the output
// once (4 + 4 bytes a lookup) and reads the table once: 12.6 MB at the
// probe's 2^20 lookups into 2^20 entries, 3.76 us at 3.35 TB/s. A random
// 4-byte lookup moves a whole 32-byte L2 sector, so a lookup costs at least
// 32 bytes of L2 traffic (33.5 MB at 2^20 lookups) wherever the table lies
// outside shared memory: the bound counts what the function must move, not
// what the memory system moves for it.
// What was measured on the H100 and not kept (PERF.md, gather probe):
//  - gather_flat and gather_cols stay one lookup a thread. 4 or 8 lookups
//    a thread (16-byte index loads and stores, a persistent grid) were no
//    faster at the probe's uniform random indices: there the card's rate
//    of random 32-byte sectors from L2 (about 120 G lookups/s, for these
//    kernels and torch.take alike) sets the time, not the instructions.
//  - gather_rows stays on L2: gather_rows_cluster at the probe's (8, 2^17)
//    takes twice its time. Random lookups from another block's shared
//    memory run at about 70 G/s over the card, from the block's own at
//    about 270 G/s, from L2 at about 120-130 G/s.
//  - gather_flat_smem's table is not loaded by bulk copy multicast to a
//    cluster's blocks: one L2 read a cluster, but each SM took 4.0-4.5 us
//    to receive its 128 KiB that way (7.0 us by a bulk copy of its own),
//    against 2.9 us for its own float4 loads from L2.
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

#include <algorithm>

namespace {

constexpr int THREADS = 256;        // a block of the three streaming kernels
constexpr int SMEM_THREADS = 1024;  // a block of gather_flat_smem
// a block of gather_rows_cluster (at the probe's shape 1024 took 5% longer)
constexpr int ROWS_THREADS = 512;
// gather_rows_cluster: the blocks of a cluster that hold one row between
// them, ROWS_CS where their shared memory holds it, else ROWS_CS_MAX (the
// largest portable cluster). 4 is the fewest that hold the probe's
// 2^17-entry row (128 KiB a block); 8 took 14% longer there.
constexpr int ROWS_CS = 4;
constexpr int ROWS_CS_MAX = 8;
// Clusters a row: this many times the clusters that fit on the card at
// once, over the rows (at least 1; at most one group of 4 lookups a thread
// of the cluster). At the probe's 8 rows, 30 clusters of 4 fit: 3 a row
// (one wave) beat 1, 2, 4 and 8 a row.
constexpr int ROWS_WAVES = 1;
// Shared memory of a block of gather_rows_cluster: [0, 16) the mbarrier,
// then the slice, shifted by 0-3 entries so that its 16-byte phase is the
// row's (a bulk copy needs both ends 16-byte aligned): RESERVED_BYTES + 4 x
// slice entries in all.
constexpr int RESERVED_BYTES = 32;
constexpr int BAR_BYTES = 16;
// One bulk copy moves at most this many bytes (chunks of 8 KiB to 1 MiB
// timed alike); a slice takes several, all completing on one mbarrier
// phase, whose transaction count must stay under 2^20 bytes (a block's
// shared memory is far less).
constexpr int COPY_CHUNK = 32 * 1024;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// ---- clusters, mbarriers and bulk copies (PTX, sm_90) ----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  // the barrier is seen initialised by the bulk copies and the cluster
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the phase, which then also waits for ``bytes``.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait for phase 0 to complete (the copies landed), with acquire at
// cluster scope: the cluster barrier after it then publishes the data.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// global [src, src + bytes) -> this block's shared memory at dst, in chunks
// completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  for (uint32_t o = 0; o < bytes; o += COPY_CHUNK) {
    const uint32_t n = min(bytes - o, (uint32_t)COPY_CHUNK);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst + o),
        "l"(reinterpret_cast<const char*>(src) + o), "r"(n), "r"(bar)
        : "memory");
  }
}

// The entry at this block's shared address ``addr`` in block ``rank`` of
// the cluster.
__device__ __forceinline__ float ld_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote)
      : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// Entries [0, len) of ``src`` go to tab[0, len), tab and src in the same
// 16-byte phase: the 0-3 entries before src's first 16-byte boundary (the
// head) and those after the last (the tail) by plain loads, the body
// between them by bulk copy. The entries of the head:
__device__ __forceinline__ int head_of(const float* src, int len) {
  return min((int)((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3),
             len);
}

// The head and the tail, by this block's threads.
__device__ __forceinline__ void plain_ends(float* tab, const float* src,
                                           int len, int threads) {
  const int head = head_of(src, len);
  const int body = (len - head) & ~3;
  for (int j = threadIdx.x; j < head; j += threads) tab[j] = __ldg(src + j);
  for (int j = head + body + threadIdx.x; j < len; j += threads)
    tab[j] = __ldg(src + j);
}

// ---- the kernels -----------------------------------------------------------

__global__ void gather_flat_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int n, int size) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = __ldg(table + clamp_index(__ldg(idx + i), size));
}

// A persistent grid, one block an SM. Each thread first loads its first 4
// indices (they do not depend on the table), then the block stages the
// whole table in shared memory (float4 loads where the table is 16-byte
// aligned). Then the threads stride over the lookups with the grid's whole
// width, 4 a thread at a time by 16-byte index loads and stores where the
// indices are 16-byte aligned (the output always is), one at a time
// otherwise. With n = 0 the launch only stages the table: the probe times
// that load on its own.
__global__ void __launch_bounds__(SMEM_THREADS)
gather_flat_smem_kernel(const float* __restrict__ table,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int n, int size) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const long long stride = (long long)gridDim.x * SMEM_THREADS;
  const long long first = (long long)blockIdx.x * SMEM_THREADS + threadIdx.x;
  const long long groups = vec ? n / 4 : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4 q = make_int4(0, 0, 0, 0);
  if (first < groups) q = __ldg(idx4 + first);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(table);
    const int n4 = size / 4;
    for (int j = threadIdx.x; j < n4; j += SMEM_THREADS)
      smem4[j] = __ldg(t4 + j);
    head = n4 * 4;
  }
  for (int j = head + threadIdx.x; j < size; j += SMEM_THREADS)
    tab[j] = __ldg(table + j);
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long g = first; g < groups; g += stride) {
    const long long gn = g + stride;
    const int4 qn = gn < groups ? __ldg(idx4 + gn) : make_int4(0, 0, 0, 0);
    out4[g] = make_float4(tab[clamp_index(q.x, size)],
                          tab[clamp_index(q.y, size)],
                          tab[clamp_index(q.z, size)],
                          tab[clamp_index(q.w, size)]);
    q = qn;
  }
  for (long long i = groups * 4 + first; i < n; i += stride)
    out[i] = tab[clamp_index(__ldg(idx + i), size)];
}

// out (R, M) from t (R, C) and i (R, M), C at most what a cluster of CS
// blocks holds (S entries a block). Cluster c takes row c / K and the
// part c % K of its lookups (a contiguous share, a multiple of 4). Block
// ``rank`` of the cluster holds entries [rank S, rank S + S) of the row.
// Its first thread sets its mbarrier to expect the slice's aligned body
// and issues the bulk copy; the block loads the 0-3 entries of head and
// tail itself, each thread its first 4 indices; then the mbarrier and a
// cluster barrier (every slice in place). Each lookup c reads entry c % S
// of block c / S. A last cluster barrier keeps every slice alive until its
// last remote reader is done.
template <int CS>
__global__ void __launch_bounds__(ROWS_THREADS)
gather_rows_cluster_kernel(const float* __restrict__ t,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int C, int M, int S,
                           int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / CS;
  const int r = cid / K, part = cid % K;
  const float* row = t + (long long)r * C;
  // S is a multiple of 4: every slice of the row has the row's phase
  float* tab = reinterpret_cast<float*>(smem + BAR_BYTES) +
               ((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const uint32_t bar = smem_u32(smem);
  const float* src = row + (long long)rank * S;
  const int len = max(0, min(S, C - (int)rank * S));
  const int head = head_of(src, len);
  const int body = (len - head) & ~3;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_expect(bar, body * 4);
    if (body > 0) bulk_load(smem_u32(tab + head), src + head, body * 4, bar);
  }
  plain_ends(tab, src, len, ROWS_THREADS);

  // this cluster's lookups: flat positions [p0, p1) of idx and out
  const int share = ((M + K - 1) / K + 3) & ~3;
  const long long base = (long long)r * M;
  const long long p0 = base + min(M, part * share);
  const long long p1 = base + min(M, part * share + share);
  const int tc = (int)rank * ROWS_THREADS + threadIdx.x;
  constexpr int CT = CS * ROWS_THREADS;
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  // the 16-byte groups [g0, g1) of the range, the ends outside them
  long long g0 = (p0 + 3) / 4, g1 = p1 / 4;
  if (!vec || g0 >= g1) g0 = g1 = p1 / 4 + 1;
  const long long a0 = vec && g0 < g1 ? g0 * 4 : p1;
  const long long a1 = vec && g0 < g1 ? g1 * 4 : p1;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4 q = make_int4(0, 0, 0, 0);
  long long g = g0 + tc;
  if (g < g1) q = __ldg(idx4 + g);
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  mbar_wait0(bar);
  cluster_arrive();
  cluster_wait();

  const uint32_t tab0 = smem_u32(tab);
  auto look = [&](int i) {
    const unsigned c = (unsigned)clamp_index(i, C);
    const unsigned owner = c / (unsigned)S;
    return ld_rank(tab0 + 4u * (c - owner * (unsigned)S), owner);
  };
  float4* out4 = reinterpret_cast<float4*>(out);
  for (; g < g1; g += CT) {
    const long long gn = g + CT;
    const int4 qn = gn < g1 ? __ldg(idx4 + gn) : make_int4(0, 0, 0, 0);
    out4[g] = make_float4(look(q.x), look(q.y), look(q.z), look(q.w));
    q = qn;
  }
  // the ends: everything when the indices are not 16-byte aligned
  for (long long p = p0 + tc; p < a0; p += CT) out[p] = look(__ldg(idx + p));
  for (long long p = a1 + tc; p < p1; p += CT) out[p] = look(__ldg(idx + p));

  cluster_arrive();
  cluster_wait();
}

// out (R, M) from t (R, C) and i (R, M): one thread per output, the row
// from L2.
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

cudaError_t optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// A launch configuration of ``blocks`` blocks in clusters of ``cs``.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int blocks, int threads, int smem, int cs,
                cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The clusters of ``kernel`` that fit on the card at once, after raising
// its dynamic shared memory to ``smem`` bytes.
template <typename Kernel>
cudaError_t active_clusters(Kernel kernel, int threads, int smem, int cs,
                            int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, threads, smem, cs, 0);
  err = cudaOccupancyMaxActiveClusters(active, kernel, &l.cfg);
  if (err == cudaSuccess && *active <= 0) err = cudaErrorInvalidConfiguration;
  return err;
}

// gather_rows_cluster's plan for (R, C, M): plan = {cluster size, S
// (entries a block), K (clusters a row), blocks, shared bytes a block,
// threads a block, the longest row a cluster of this size holds};
// ``kernel`` the instance of that cluster size. cudaErrorInvalidValue when
// the row does not fit ROWS_CS_MAX blocks: the one place that decides
// which rows the kernel takes.
cudaError_t rows_plan(int R, int C, int M, int* plan,
                      void (**kernel)(const float*, const int*, float*, int,
                                      int, int, int)) {
  int limit = 0, active = 0;
  cudaError_t err = optin_bytes(&limit);
  if (err != cudaSuccess) return err;
  if (R <= 0 || C <= 0 || M <= 0) return cudaErrorInvalidValue;
  int cs = ROWS_CS;
  long long S = ((C + cs - 1LL) / cs + 3) & ~3LL;
  if (RESERVED_BYTES + 4 * S > limit) {
    cs = ROWS_CS_MAX;
    S = ((C + cs - 1LL) / cs + 3) & ~3LL;
  }
  const long long smem = RESERVED_BYTES + 4 * S;
  if (smem > limit) return cudaErrorInvalidValue;
  *kernel = cs == ROWS_CS ? gather_rows_cluster_kernel<ROWS_CS>
                          : gather_rows_cluster_kernel<ROWS_CS_MAX>;
  err = active_clusters(*kernel, ROWS_THREADS, (int)smem, cs, &active);
  if (err != cudaSuccess) return err;
  const int most = (M + 4 * cs * ROWS_THREADS - 1) / (4 * cs * ROWS_THREADS);
  const int K = std::max(1, std::min(most, ROWS_WAVES * active / R));
  const long long blocks = (long long)R * K * cs;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  plan[0] = cs;
  plan[1] = (int)S;
  plan[2] = K;
  plan[3] = (int)blocks;
  plan[4] = (int)smem;
  plan[5] = ROWS_THREADS;
  plan[6] = cs * ((limit - RESERVED_BYTES) / 4 & ~3);
  return cudaSuccess;
}

// gather_flat_smem's grid for n lookups into a table of ``size`` entries:
// plan = {blocks, shared bytes a block, threads a block}. The persistent
// grid: as many blocks as fit on the SMs at this table size, fewer when
// the lookups fill fewer (4 a thread); n = 0 takes the full grid.
cudaError_t smem_plan(int n, int size, int* plan) {
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = optin_bytes(&limit);
  if (err != cudaSuccess) return err;
  const long long smem = 4LL * size;
  if (size <= 0 || n < 0 || smem > limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gather_flat_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_flat_smem_kernel, SMEM_THREADS, (int)smem);
  if (err != cudaSuccess) return err;
  long long blocks = (long long)sms * std::max(per_sm, 1);
  if (n > 0)
    blocks = std::min(blocks, ((long long)n + 4LL * SMEM_THREADS - 1) /
                                  (4LL * SMEM_THREADS));
  plan[0] = (int)blocks;
  plan[1] = (int)smem;
  plan[2] = SMEM_THREADS;
  return cudaSuccess;
}

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
  int bytes = 0;
  const cudaError_t err = optin_bytes(&bytes);
  *entries = bytes / (int)sizeof(float);
  return (int)err;
}

// gather_flat_smem's launch plan (see smem_plan): 3 ints.
int rgbd_gather_flat_smem_plan(int n, int size, int* plan) {
  return (int)smem_plan(n, size, plan);
}

// out[i] = table[idx[i]] from a copy of the table in each block's shared
// memory, on a persistent grid. n = 0 launches the full grid, which only
// stages the table.
int rgbd_gather_flat_smem(const void* table, const void* idx, void* out,
                          int n, int size, void* stream) {
  int plan[3];
  cudaError_t err = smem_plan(n, size, plan);
  if (err != cudaSuccess) return (int)err;
  gather_flat_smem_kernel<<<plan[0], SMEM_THREADS, plan[1],
                            (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, n, size);
  return (int)cudaGetLastError();
}

// take_along_axis(t, i, axis=1): t (R, C), i and out (R, M), the row from
// L2.
int rgbd_gather_rows(const void* t, const void* idx, void* out, int R, int C,
                     int M, void* stream) {
  if (R * M <= 0) return 0;
  gather_rows_kernel<<<blocks_for(R * M), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)idx, (float*)out, R, C, M);
  return (int)cudaGetLastError();
}

// gather_rows_cluster's launch plan (see rows_plan): 7 ints.
int rgbd_gather_rows_cluster_plan(int R, int C, int M, int* plan) {
  void (*kernel)(const float*, const int*, float*, int, int, int, int);
  return (int)rows_plan(R, C, M, plan, &kernel);
}

// The same with each row held in a cluster's shared memory. Refuses
// (cudaErrorInvalidValue) a row that does not fit.
int rgbd_gather_rows_cluster(const void* t, const void* idx, void* out,
                             int R, int C, int M, void* stream) {
  int plan[7];
  void (*kernel)(const float*, const int*, float*, int, int, int, int);
  cudaError_t err = rows_plan(R, C, M, plan, &kernel);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(plan[3], ROWS_THREADS, plan[4], plan[0],
                  (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, (const float*)t, (const int*)idx,
                           (float*)out, C, M, plan[1], plan[2]);
  if (err != cudaSuccess) return (int)err;
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
