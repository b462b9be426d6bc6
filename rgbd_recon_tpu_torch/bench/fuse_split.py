"""The fuse kernels' device time split by the work they do, and their
alternative designs, on the card.

``python -m rgbd_recon_tpu_torch.bench.fuse_split [--iters 20]
[--kept-only]`` records the marking (``ops/bricks.py mark_pixels``) and
the brick-compact integrate (``ops/tsdf.py integrate_compact``) calls of
one fast and one parity fuse of the cells' reference setup
(``bench/headline.py reference_setup``) and runs csrc/fuse.cu's kernels on
them. The kept source (the library the port loads) runs:

- ``brick_mark``: the recorded marking;
- ``brick_integrate`` on the fuse's own list of occupied bricks (the
  path's call), on an empty list (every voxel cleared: the clear blocks'
  part alone), and on a list of every brick (8,800 listed bricks: the
  brick blocks' rate when they hold nearly all the work);
- ``brick_integrate`` with the other taps (nearest on the parity fuse's
  maps and list, bilinear on the fast fuse's).

Then, unless ``--kept-only``, each variant of ``VARIANTS`` is csrc/fuse.cu
with some regions replaced, built into its own library under
``build/fuse_variants/``, and run through the same wrappers on the fuse's
own list and the empty list (an integrate variant) or on the marking (a
mark variant), every variant twice in turns (forward, then backward):

- the integrate's forms: ``sequential`` (every brick block before the
  clear blocks), ``one_instance`` (the tap rule a runtime
  branch of one instance), ``nearest_4_blocks`` / ``nearest_7_blocks`` /
  ``bilinear_5_blocks`` (the launch bounds' blocks an SM of a tap rule's
  instance), ``threads_512`` (512 voxels an item), the bulk-copy forms
  (a listed brick's rows copied into shared memory by 1-D bulk async
  copies completing on an mbarrier, the brick blocks before the clear
  blocks): ``ring_persistent_2`` / ``ring_persistent_4`` (2 or 4
  persistent brick blocks an SM, each stepping over the items through a
  ring of two stages: item k + 1's rows in flight during item k's taps),
  ``ring_block_an_item`` (an item a block) and ``ring_block_a_brick``
  (1,024 threads a block, a block a listed brick, one stage);
  ``clear_rows_2`` / ``clear_rows_8`` (x-rows a warp clears), and
  ``no_clear`` (stripped: the clear blocks store nothing);
- the marking's forms: ``no_pixels`` (stripped: the zero, the barrier and
  the flush alone), ``global_adds`` (no histogram: the warp-aggregated adds
  straight to the counts), ``global_lane_adds`` (no histogram, an atomic a
  lane to the counts), ``warp_adds`` (the adds into the histogram
  warp-aggregated too), ``full_flush`` (a block adds all of its bins, no
  list), ``early_barrier`` (the grid barrier before the pixel loop),
  ``unroll_2`` / ``unroll_4`` (pixels a lane loads in one round),
  ``unroll_4_grid_by_pixels`` (4 pixels a lane and the grid sized by
  the pixels alone: fewer blocks than SMs on the fast fuse), ``blocks_2``
  / ``blocks_5`` (blocks an SM at most), and ``cluster_4`` /
  ``cluster_8`` (the histogram spread over a thread-block cluster's
  shared memory, each block zeroing and flushing its slice, in a
  cooperative launch with a cluster dimension; refused launches are
  reported, not timed).

Each run's output is held bit-equal to its twin (``mark_pixels_plain``,
``integrate_compact_plain``) before it is timed, the stripped forms'
excepted. Times are the kernel's own device time under torch.profiler
with a cold L2 (a 256 MiB write and read before each call) and warm (back
to back); beside them the launch, ptxas' registers, shared memory and
spills (the kept library's from the loaded library too), and the bytes
each call moves counted in 32-byte sectors (the marking's sampled depth
and world inputs, the integrate's stores of the listed bricks' x-runs).
Prints the card line, a line a case, and one JSON line. Exits 1 without a
card, before any work.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import _build

SOURCE = _build._PKG / "csrc" / "fuse.cu"
OUT = _build.BUILD_DIR.parent / "fuse_variants"
ENTRIES = ("rgbd_brick_mark", "rgbd_brick_mark_plan", "rgbd_brick_integrate",
           "rgbd_brick_integrate_plan", "rgbd_fuse_params_sizes",
           "rgbd_fuse_attrs")

# ---- the regions a variant replaces (each found once in the source) -------

BRICKS = "// ---- the brick blocks and the launch's shape"
BRICKS_END = "// ---- launch plans"
CLEAR_CALL = "    clear_rows(q, s.Y, s.v, i - before);\n"
INTERLEAVE = "  const int total = s.brick_blocks + s.clear_blocks;\n"
INTERLEAVE_END = "}\n\n// the launch's shape"
TAP_RULE = "  if (BILINEAR) {\n"
MARK_KERNEL = "// the marking: the counts zeroed, the pixels'"
MARK_KERNEL_END = "// ---- the integration"
WARP_ADD = "// one add of `key` a lane (-1: none). Into a shared"
WARP_ADD_END = "// the marking: the counts zeroed"
SMEM_RULE = "  const bool smem = bins * 4 <= MARK_SMEM_MAX;\n"
LIST_CAP = "  const int list_cap =\n"
LIST_CAP_END = "  const int shared ="
SHARED_MARK = "  const int shared = smem ? (int)(bins * 4) + list_cap * 4 : 0;\n"
PIXELS = "  s.pixels = (int)pixels;\n"
GRID = "      max(1ll, min(cap, max(want, min(chunks, (long long)sms))));\n"
MARK_BLOCKS = "  out[0] = (int)blocks;\n"
EARLY_ZERO = ("    if (tid == 0) listed = 0;\n    __syncthreads();\n  } else {\n"
              "    cooperative_groups::this_grid().sync();\n  }\n")
LATE_SYNC = ("    cooperative_groups::this_grid().sync();\n"
             "    const int n = listed;\n")
MARK_LAUNCH = "  const cudaError_t err = cudaLaunchCooperativeKernel("
MARK_LAUNCH_END = "  // a refused launch's error is cleared"

# the brick blocks before every clear block
SEQUENTIAL = """\
  if ((int)blockIdx.x < s.brick_blocks)
    brick_item<BILINEAR>(q, s, blockIdx.x);
  else
    clear_rows(q, s.Y, s.v, (int)blockIdx.x - s.brick_blocks);
"""

# the listed bricks' rows copied into shared memory by 1-D bulk copies
# completing on an mbarrier a stage (a thread issues them; SENSOR_CHUNK
# sensors a stage): brick blocks first, each taking the items p, p + P, ...
# through a ring of STAGES stages (P = BRICK_BLOCKS_PER_SM an SM), or an
# item a block (P = the items)
RING = r"""constexpr int BRICK_BLOCKS_PER_SM = @BPS@;
constexpr int STAGES = @STAGES@;

struct IntegrateShape {
  Divisor Y, v;
  int brick_blocks, clear_blocks, chunks, items;
  int sensors;               // sensors a stage: min(N, SENSOR_CHUNK)
  int groups;                // stages an item: ceil(N / sensors), >= 1
};

// ---- mbarriers and bulk copies (PTX, sm_90) ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the phase's one arrival, which then also waits for ``bytes``
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// global [src, src + bytes) -> shared dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the brick blocks -------------------------------------------------------

// a brick block's place in its item sequence: item w (entry w / chunks,
// chunk w % chunks) of listed brick b, sensor group g
struct Cursor {
  int w, g, b, c;
};

// the first item at or after w (stepping by the brick blocks) whose entry
// lists a brick; w >= items when none is left
__device__ __forceinline__ void seek(const IntegrateParams& q,
                                     const IntegrateShape& s, Cursor& k) {
  const long long B = (long long)q.Bz * q.By * q.Bx;
  for (; k.w < s.items; k.w += s.brick_blocks) {
    const int j = k.w / s.chunks;
    const long long id = q.ids[j];
    if (id >= 0 && id < B) {
      k.b = (int)id;
      k.c = k.w - j * s.chunks;
      return;
    }
  }
}

__device__ __forceinline__ void step(const IntegrateParams& q,
                                     const IntegrateShape& s, Cursor& k) {
  if (++k.g < s.groups) return;
  k.g = 0;
  k.w += s.brick_blocks;
  seek(q, s, k);
}

// the copies of cursor k's rows into a stage: its group's sensors, each
// the item's voxels of its row run
__device__ __forceinline__ void issue(const IntegrateParams& q,
                                      const IntegrateShape& s,
                                      const Cursor& k, float4* stage,
                                      uint32_t bar) {
  const int n0 = k.g * s.sensors;
  const int ns = min(s.sensors, q.N - n0);
  const int nvox = min(INT_THREADS, q.V - k.c * INT_THREADS);
  mbar_expect(bar, (uint32_t)(max(ns, 0) * nvox * 16));
  const float4* rows = reinterpret_cast<const float4*>(q.proj) +
                       (long long)k.b * q.V + k.c * INT_THREADS;
  for (int i = 0; i < ns; ++i)
    bulk_load(smem_u32(stage + i * INT_THREADS),
              rows + (long long)(n0 + i) * q.proj_n, (uint32_t)nvox * 16,
              bar);
}

// block p's items: their rows through a ring of STAGES stages of shared
// memory (thread 0 copies, every thread waits on the stage's mbarrier),
// a thread a voxel folding its sensors a group at a time
template <bool BILINEAR>
__device__ __forceinline__ void brick_items(const IntegrateParams& q,
                                            const IntegrateShape& s,
                                            float4* ring,
                                            unsigned long long* bars) {
  const int tid = threadIdx.x;
  const int stage_rows = s.sensors * INT_THREADS;
  if (tid == 0)
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(bars + i));
  __syncthreads();
  Cursor cons{(int)blockIdx.x, 0, 0, 0};
  seek(q, s, cons);
  Cursor prod = cons;
  if (tid == 0)
    for (int i = 0; i < STAGES && prod.w < s.items; ++i) {
      issue(q, s, prod, ring + i * stage_rows, smem_u32(bars + i));
      step(q, s, prod);
    }
  const float limit = q.limit;
  float tsd = limit, total_w = 0.0f;
  for (int k = 0; cons.w < s.items; ++k) {
    const int st = k % STAGES;
    mbar_wait(smem_u32(bars + st), (uint32_t)((k / STAGES) & 1));
    const float4* rows = ring + st * stage_rows;
    const int lv = cons.c * INT_THREADS + tid;
    if (lv < q.V) {
      if (cons.g == 0) {
        tsd = limit;
        total_w = 0.0f;
      }
      const int n0 = cons.g * s.sensors;
      for (int i = 0; i < s.sensors && n0 + i < q.N; ++i) {
        const float4 r = rows[i * INT_THREADS + tid];
        fuse_sensor(tsd, total_w, r, sensor_taps<BILINEAR>(q, n0 + i, r),
                    limit, q.carve);
      }
      if (cons.g == s.groups - 1) {
        if (!q.phantom_hull && total_w <= 0.0f && tsd >= limit) tsd = -limit;
        const int v = q.v;
        const int bxi = cons.b % q.Bx, byz = cons.b / q.Bx;
        const int byi = byz % q.By, bzi = byz / q.By;
        const int lz = lv / (v * v), lyx = lv - lz * v * v;
        const int ly = lyx / v, lx = lyx - ly * v;
        const int z = bzi * v + lz, y = byi * v + ly, x = bxi * v + lx;
        if (z < q.Z && y < q.Y && x < q.X)
          q.out[((long long)z * q.Y + y) * q.X + x] = tsd;
      }
    }
    __syncthreads();  // every thread is done with the stage
    if (tid == 0 && prod.w < s.items) {
      issue(q, s, prod, ring + st * stage_rows, smem_u32(bars + st));
      step(q, s, prod);
    }
    step(q, s, cons);
  }
}

template <bool BILINEAR>
__global__ void __launch_bounds__(INT_THREADS)
    integrate_kernel(const IntegrateParams q, const IntegrateShape s) {
  extern __shared__ float4 ring[];
  __shared__ unsigned long long bars[STAGES];
  if ((int)blockIdx.x < s.brick_blocks)
    brick_items<BILINEAR>(q, s, ring, bars);
  else
    clear_rows(q, s.Y, s.v, (int)blockIdx.x - s.brick_blocks);
}

IntegrateShape integrate_shape(const IntegrateParams& q, int* shared) {
  IntegrateShape s;
  s.Y = divisor(q.Y);
  s.v = divisor(q.v);
  s.chunks = (q.V + INT_THREADS - 1) / INT_THREADS;
  s.items = (int)min((long long)q.capacity * s.chunks, (long long)(1 << 30));
  s.sensors = max(1, min(q.N, SENSOR_CHUNK));
  s.groups = max(1, (q.N + s.sensors - 1) / s.sensors);
  s.brick_blocks = @BLOCKS@;
  const long long rows = (long long)q.Z * q.Y;
  const int per_block = (INT_THREADS / 32) * CLEAR_ROWS;
  s.clear_blocks = (int)((rows + per_block - 1) / per_block);
  *shared = STAGES * s.sensors * INT_THREADS * 16;
  if (*shared + 1024 > 48 * 1024) {
    cudaFuncSetAttribute(integrate_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, *shared);
    cudaFuncSetAttribute(integrate_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, *shared);
  }
  return s;
}

"""


# the adds warp-aggregated into the histogram too
WARP_ADDS = """\
template <bool SMEM>
__device__ __forceinline__ void warp_add(int* dst, int key, int add,
                                         int* list, int* listed,
                                         int list_cap) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key < 0 || (int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const int old = atomicAdd(dst + key, __popc(peers) * add);
  if (SMEM && old == 0) {
    const int i = atomicAdd(listed, 1);
    if (i < list_cap) list[i] = key;
  }
}

"""

# an atomic a lane, no aggregation, to the counts too
LANE_ADDS = """\
template <bool SMEM>
__device__ __forceinline__ void warp_add(int* dst, int key, int add,
                                         int* list, int* listed,
                                         int list_cap) {
  if (key < 0) return;
  const int old = atomicAdd(dst + key, add);
  if (SMEM && old == 0) {
    const int i = atomicAdd(listed, 1);
    if (i < list_cap) list[i] = key;
  }
}

"""

# the histogram spread over a cluster of MARK_CS blocks: block rank r holds
# bins [r S, r S + S); a leader adds to the owner's slice through
# distributed shared memory; each block zeroes and flushes its slice
CLUSTER_KERNEL = """\
constexpr int MARK_CS = {cs};

template <bool SMEM>
__global__ void __launch_bounds__(MARK_THREADS)
    mark_kernel(const MarkParams q, const MarkShape s) {{
  namespace cg = cooperative_groups;
  extern __shared__ int4 mark_smem[];
  int* hist = reinterpret_cast<int*>(mark_smem);
  const int tid = threadIdx.x;
  const int slice = (s.bins + MARK_CS - 1) / MARK_CS;
  for (int k = blockIdx.x * MARK_THREADS + tid; k < s.bins;
       k += gridDim.x * MARK_THREADS)
    q.counts[k] = 0;
  if (SMEM) {{
    for (int k = tid; k < slice; k += MARK_THREADS) hist[k] = 0;
    cg::this_cluster().sync();
  }} else {{
    cg::this_grid().sync();
  }}
  const float bmin[3] = {{q.bbox_min[0], q.bbox_min[1], q.bbox_min[2]}};
  constexpr int WARP_PIXELS = 32 * MARK_UNROLL;
  const long long warps = (long long)gridDim.x * (MARK_THREADS / 32);
  for (long long w = (long long)blockIdx.x * (MARK_THREADS / 32) + (tid >> 5);
       w * WARP_PIXELS < s.pixels; w += warps) {{
    const int p0 = (int)(w * WARP_PIXELS) + (tid & 31);
    PixelIn in[MARK_UNROLL];
#pragma unroll
    for (int k = 0; k < MARK_UNROLL; ++k)
      if (p0 + 32 * k < s.pixels) pixel_loads(q, s, p0 + 32 * k, in[k]);
#pragma unroll
    for (int k = 0; k < MARK_UNROLL; ++k) {{
      int keys[2] = {{-1, -1}};
      if (p0 + 32 * k < s.pixels) pixel_keys(q, in[k], bmin, keys, keys + 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {{
        const int key = keys[e];
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key < 0 || (tid & 31) != __ffs(peers) - 1) continue;
        const int val = __popc(peers) * q.add;
        if (SMEM) {{
          const int owner = key / slice;
          int* h = cg::this_cluster().map_shared_rank(hist, owner);
          atomicAdd(h + (key - owner * slice), val);
        }} else {{
          atomicAdd(q.counts + key, val);
        }}
      }}
    }}
  }}
  if (SMEM) {{
    cg::this_cluster().sync();
    cg::this_grid().sync();
    const int base = (int)cg::this_cluster().block_rank() * slice;
    for (int k = tid; k < slice && base + k < s.bins; k += MARK_THREADS) {{
      const int c = hist[k];
      if (c != 0) atomicAdd(q.counts + base + k, c);
    }}
  }}
}}

"""
CLUSTER_LAUNCH = """\
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = MARK_CS;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[0]);
  cfg.blockDim = dim3(MARK_THREADS);
  cfg.dynamicSmemBytes = (size_t)plan[2];
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = plan[3] ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, plan[3] ? mark_kernel<true> : mark_kernel<false>, *q, s);
"""


def _const(name: str, value) -> tuple:
    line = f"constexpr int {name} = "
    return ((line, ";\n", f"{line}{value}"),)


def _cluster(cs: int) -> tuple:
    return ((MARK_KERNEL, MARK_KERNEL_END, CLUSTER_KERNEL.format(cs=cs)),
            (SMEM_RULE, LIST_CAP,
             "  const bool smem = bins * 4 <= MARK_SMEM_MAX * MARK_CS;\n"),
            (SHARED_MARK, "  int resident",
             "  const int shared = smem ? (int)((bins + MARK_CS - 1) / "
             "MARK_CS * 4) : 0;\n"),
            (MARK_BLOCKS, "  out[1]",
             "  out[0] = (int)((blocks + MARK_CS - 1) / MARK_CS * MARK_CS);\n"),
            (MARK_LAUNCH, MARK_LAUNCH_END, CLUSTER_LAUNCH))




def _ring(bps: int = 2, stages: int = 2, threads: int = 256,
          persistent: bool = True) -> tuple:
    blocks = ("(int)min((long long)s.items, (long long)sm_count() * "
              "BRICK_BLOCKS_PER_SM)" if persistent else "s.items")
    text = (RING.replace("@BPS@", str(bps)).replace("@STAGES@", str(stages))
            .replace("@BLOCKS@", blocks))
    return ((BRICKS, BRICKS_END, text), *_const("INT_THREADS", threads))


# name -> (the kernel it is a form of, its changes: (a region's start
# (found once), its end (the first after it, not replaced), the region's
# replacement))
VARIANTS = {
    "kept": (None, ()),
    "sequential": ("integrate", ((INTERLEAVE, INTERLEAVE_END, SEQUENTIAL),)),
    "one_instance": ("integrate", ((TAP_RULE, "    const float cx",
                                    "  if (q.bilinear) {\n"),)),
    "nearest_4_blocks": ("integrate", _const("INT_BLOCKS_NEAREST", 4)),
    "nearest_7_blocks": ("integrate", _const("INT_BLOCKS_NEAREST", 7)),
    "bilinear_5_blocks": ("integrate", _const("INT_BLOCKS_BILINEAR", 5)),
    "threads_512": ("integrate", _const("INT_THREADS", 512)),
    "ring_persistent_2": ("integrate", _ring(2)),
    "ring_persistent_4": ("integrate", _ring(4)),
    "ring_block_an_item": ("integrate", _ring(persistent=False)),
    "ring_block_a_brick": ("integrate", _ring(stages=1, threads=1024,
                                              persistent=False)),
    "clear_rows_2": ("integrate", _const("CLEAR_ROWS", 2)),
    "clear_rows_8": ("integrate", _const("CLEAR_ROWS", 8)),
    "no_clear": ("integrate", ((CLEAR_CALL, "}\n", "    return;\n"),)),
    "no_pixels": ("mark", ((PIXELS, "  s.bins", "  s.pixels = 0;\n"),)),
    "global_adds": ("mark", ((SMEM_RULE, LIST_CAP,
                              "  const bool smem = false;\n"),)),
    "warp_adds": ("mark", ((WARP_ADD, WARP_ADD_END, WARP_ADDS),)),
    "full_flush": ("mark", ((LIST_CAP, LIST_CAP_END,
                             "  const int list_cap = 0;\n"),)),
    "early_barrier": ("mark", (
        (EARLY_ZERO, "  int* dst",
         "    if (tid == 0) listed = 0;\n  }\n"
         "  cooperative_groups::this_grid().sync();\n"),
        (LATE_SYNC, "    if (n <=",
         "    __syncthreads();\n    const int n = listed;\n"))),
    "unroll_2": ("mark", _const("MARK_UNROLL", 2)),
    "unroll_4": ("mark", _const("MARK_UNROLL", 4)),
    "unroll_4_grid_by_pixels": ("mark", (
        *_const("MARK_UNROLL", 4),
        (GRID, "  out[0]", "      max(1ll, min(cap, want));\n"))),
    "blocks_2": ("mark", _const("MARK_BLOCKS_PER_SM", 2)),
    "blocks_5": ("mark", _const("MARK_BLOCKS_PER_SM", 5)),
    "global_lane_adds": ("mark", ((SMEM_RULE, LIST_CAP,
                                   "  const bool smem = false;\n"),
                                  (WARP_ADD, WARP_ADD_END, LANE_ADDS))),
    "cluster_4": ("mark", _cluster(4)),
    "cluster_8": ("mark", _cluster(8)),
}
# the variants that compute something else (timing probes)
STRIPPED = ("no_clear", "no_pixels")


def variant_source(text: str, name: str) -> str:
    """fuse.cu's text with a variant's changes."""
    for start, end, other in VARIANTS[name][1]:
        if text.count(start) != 1:
            raise ValueError(f"{name}: a region not found once in "
                             f"{SOURCE.name}: {start[:40]!r}")
        a = text.index(start)
        b = text.find(end, a + len(start))
        if b < 0:
            raise ValueError(f"{name}: a region has no end in {SOURCE.name}")
        text = text[:a] + other + text[b:]
    return text


def _build_variant(name: str):
    """(library path, ptxas report) of a variant."""
    src = OUT / f"{name}_{SOURCE.name}"
    src.write_text(variant_source(SOURCE.read_text(), name))
    lib = OUT / f"{name}.so"
    res = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS,
                          "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return lib, res.stderr


def _load(lib):
    cdll = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        fn = getattr(cdll, entry)
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return cdll


def record_calls(device) -> dict:
    """{path: {"mark": (args, kwargs), "integrate": (args, kwargs)}} of one
    fast and one parity fuse of the reference setup."""
    import dataclasses

    from ..ops import bricks, tsdf
    from ..recon.tsdf_pipeline import TsdfPipeline
    from .headline import load_cell, reference_setup

    pipe, frames, _ = reference_setup(device)
    parity = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **load_cell("tsdf_parity_4kinect2_1cm")["pipeline"]),
        pipe.bbox)
    out = {}
    for path, p in (("fast", pipe), ("parity", parity)):
        p.fuse(frames)                          # warm-up: fits the models
        calls = {}
        mark, integrate = bricks.mark_pixels, tsdf.integrate_compact

        def rec(name, fn):
            def record(*args, **kwargs):
                calls[name] = (args, kwargs)
                return fn(*args, **kwargs)
            return record

        bricks.mark_pixels = rec("mark", mark)
        tsdf.integrate_compact = rec("integrate", integrate)
        try:
            p.fuse(frames)
        finally:
            bricks.mark_pixels, tsdf.integrate_compact = mark, integrate
        out[path] = calls
    torch.cuda.synchronize()
    return out


def _sectors(t: torch.Tensor, offsets: torch.Tensor) -> int:
    """The distinct 32-byte sectors of ``t``'s elements at ``offsets``."""
    addr = t.data_ptr() + offsets.reshape(-1) * t.element_size()
    return int(torch.unique(addr // 32).numel())


def mark_sectors(args, kwargs) -> dict:
    """{input: bytes it moves in 32-byte sectors} of a marking: the sampled
    pixels' depth (a strided view: every sector a sampled row touches) and
    their world inputs (the two ray planes or the worlds), and the counts
    written once."""
    from ..kernels.fuse import sampled_size

    depth, _, _, res, s = args
    N, H, W = depth.shape
    dev = depth.device
    i = torch.arange(s // 2, H, s, device=dev)
    j = torch.arange(s // 2, W, s, device=dev)
    n = torch.arange(N, device=dev)
    grid = (n[:, None, None], i[None, :, None], j[None, None, :])

    def offs(t, sub):
        st = t.stride()
        o = sum(a * b for a, b in zip(sub, st))
        if t.dim() == 4:
            o = o[..., None] + torch.arange(3, device=dev) * st[3]
        return o

    out = {"depth": 32 * _sectors(depth, offs(depth, grid))}
    if kwargs.get("worlds") is not None:
        Hs, Ws = sampled_size(H, s), sampled_size(W, s)
        w = kwargs["worlds"]
        sub = (n[:, None, None], torch.arange(Hs, device=dev)[None, :, None],
               torch.arange(Ws, device=dev)[None, None, :])
        out["worlds"] = 32 * _sectors(w, offs(w, sub))
    else:
        for k in ("ray_a", "ray_b"):
            out[k] = 32 * _sectors(kwargs[k], offs(kwargs[k], grid))
    out["counts"] = 4 * res[0] * res[1] * res[2]
    return out


def listed_store_sectors(ids, vol_shape, brick_vox) -> dict:
    """The listed bricks' x-runs of the (Z, Y, X) f32 volume: their count,
    their bytes, and the 32-byte sectors they touch (a run of v voxels at
    a multiple of 4 v bytes into its row)."""
    Z, Y, X = vol_shape
    v = int(brick_vox)
    Bx, By = -(-X // v), -(-Y // v)
    B = -(-Z // v) * By * Bx
    b = ids[(ids >= 0) & (ids < B)]
    bx, byz = b % Bx, b // Bx
    by, bz = byz % By, byz // By
    l = torch.arange(v, device=ids.device)
    z = (bz[:, None, None] * v + l[None, :, None]).expand(-1, v, v)
    y = (by[:, None, None] * v + l[None, None, :]).expand(-1, v, v)
    x0 = (bx * v)[:, None, None].expand(-1, v, v)
    keep = (z < Z) & (y < Y)
    z, y, x0 = z[keep], y[keep], x0[keep]
    x1 = torch.clamp(x0 + v, max=X)
    first = ((z * Y + y) * X + x0) * 4
    last = ((z * Y + y) * X + x1) * 4 - 1
    return dict(runs=int(first.numel()), bytes=int((last - first + 1).sum()),
                sectors=int((last // 32 - first // 32 + 1).sum()))


def _events_ms(fn, flush, iters: int):
    """(cold, warm) ms a call of ``fn`` between CUDA events: each cold call
    after ``flush``, the warm ones back to back (the host's enqueue
    included where it is the slower)."""
    cold = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        cold.append(start.elapsed_time(end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return sum(cold) / iters, start.elapsed_time(end) / iters


def _run_cases(cases: dict, flush, iters: int) -> dict:
    """{case: (cold, warm, timer)} ms of each case's kernel: its own device
    time under torch.profiler, or between CUDA events where the profiler
    drops launches in every trace."""
    from .scan_variants import _device_ms

    out = {}
    for name, (fn, kernel) in cases.items():
        try:
            out[name] = (*_device_ms({name: fn}, flush, iters, kernel)[name],
                         "profiler")
        except RuntimeError:
            out[name] = (*_events_ms(fn, flush, iters), "events")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kept-only", action="store_true",
                    help="time the kept library alone, no variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fuse_split: no CUDA device", file=sys.stderr)
        return 1
    from ..kernels import fuse as kfuse
    from ..ops import bricks, tsdf
    from ..ops.compact import compact
    from .setup_refine_variants import ptxas_usage
    from .trace import card_line

    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    flush_w = torch.empty(64 * 2 ** 20, device=device)
    flush_r = torch.ones(64 * 2 ** 20, device=device)

    def flush():
        flush_w.fill_(1.0)
        flush_r.sum()

    names = ["kept"] + ([] if args.kept_only else
                        [n for n in VARIANTS if n != "kept"])
    OUT.mkdir(parents=True, exist_ok=True)
    def build(name):
        try:
            return _build_variant(name)
        except RuntimeError as e:
            if name == "kept":
                raise
            return None, str(e)

    with ThreadPoolExecutor(min(8, len(names))) as pool:
        built = dict(zip(names, pool.map(build, names)))
    recorded = record_calls(device)
    attrs = kfuse.kernel_attrs()
    print(f"kept library's registers, static shared and local bytes: "
          f"{attrs}", flush=True)
    # per path: the compaction's list and slot map, the twins' outputs
    inputs = {}
    for path, calls in recorded.items():
        margs, mkw = calls["mark"]
        iargs, ikw = calls["integrate"]
        proj, counts, min_voxels, capacity = iargs[:4]
        flags = (counts > min_voxels).reshape(-1).view(torch.uint8)
        n = torch.empty(1, dtype=torch.int32, device=device)
        ids, slot = compact(flags, 0, capacity, n, 0, want_slot=True)
        inputs[path] = dict(
            ids=ids, slot=slot,
            counts=bricks.mark_pixels_plain(*margs, **mkw),
            volume=tsdf.integrate_compact_plain(*iargs, **ikw))
        sec = mark_sectors(margs, mkw)
        runs = listed_store_sectors(ids, iargs[8], iargs[9])
        inputs[path].update(mark_sectors=sec, store_sectors=runs)
        print(f"{path}: the marking moves {sum(sec.values())} B in 32-byte "
              f"sectors {sec}; the listed bricks' x-runs {runs}", flush=True)
    rows = []
    saved = kfuse.library
    try:
        for name in [*names, *reversed(names)]:
            lib, report = built[name]
            if lib is None:
                rows.append(dict(variant=name, build_failed=report))
                print(f"{name}: not built ({report.splitlines()[0]})",
                      flush=True)
                continue
            cdll = _load(lib)
            kfuse.library = lambda cdll=cdll: cdll
            kfuse._size_checked[:] = [True]
            form = VARIANTS[name][0]
            checked = name not in STRIPPED
            for path, calls in recorded.items():
                margs, mkw = calls["mark"]
                iargs, ikw = calls["integrate"]
                proj = iargs[0]
                B = proj.shape[1]
                ids, slot = inputs[path]["ids"], inputs[path]["slot"]
                cases = {}
                if form in (None, "mark"):
                    try:
                        got = kfuse.brick_mark_cuda(*margs, **mkw)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        rows.append(dict(variant=name, path=path,
                                         case="brick_mark", refused=str(e)))
                        print(f"{name} {path} brick_mark: refused ({e}) on "
                              f"{card}", flush=True)
                        continue
                    if checked and not torch.equal(
                            got, inputs[path]["counts"]):
                        raise AssertionError(f"{name} {path}: brick_mark "
                                             "differs from its twin")
                    cases["brick_mark"] = (
                        lambda: kfuse.brick_mark_cuda(*margs, **mkw),
                        "mark_kernel", kfuse.mark_plan(*margs, **mkw), None)
                if form in (None, "integrate"):
                    got = kfuse.brick_integrate_cuda(proj, ids, slot,
                                                     *iargs[4:], **ikw)
                    if checked and not torch.equal(
                            got.view(torch.int32),
                            inputs[path]["volume"].view(torch.int32)):
                        raise AssertionError(f"{name} {path}: brick_integrate"
                                             " differs from its twin")
                    other = ("bilinear" if ikw.get("taps", "nearest")
                             == "nearest" else "nearest")
                    own = int((slot >= 0).sum())
                    lists = {
                        "own list": (ids, slot, ikw, own),
                        "empty list": (torch.full_like(ids, B),
                                       torch.full_like(slot, -1), ikw, 0),
                    }
                    if name == "kept":
                        lists["every brick"] = (
                            torch.arange(B, dtype=torch.int64, device=device),
                            torch.arange(B, dtype=torch.int32, device=device),
                            ikw, B)
                        lists[f"own list, {other} taps"] = (
                            ids, slot, dict(ikw, taps=other), own)
                    for case, (i, s, kw, listed) in lists.items():
                        cases[f"brick_integrate, {case}"] = (
                            lambda i=i, s=s, kw=kw: kfuse.brick_integrate_cuda(
                                proj, i, s, *iargs[4:], **kw),
                            "integrate_kernel",
                            kfuse.integrate_plan(iargs[8], iargs[9],
                                                 i.shape[0], proj.shape[0]),
                            listed)
                times = _run_cases({c: v[:2] for c, v in cases.items()},
                                   flush, args.iters)
                for case, (_, kernel, launch, listed) in cases.items():
                    cold, warm, timer = times[case]
                    usage = ptxas_usage(report, kernel)
                    rows.append(dict(variant=name, path=path, case=case,
                                     bit_equal=checked, device_ms=cold,
                                     device_ms_warm=warm, timer=timer,
                                     launch=launch,
                                     listed_bricks=listed,
                                     registers_shared_spills=usage))
                    print(f"{name} {path} {case}: "
                          + ("bit-equal to its twin" if checked
                             else "stripped, not the kernel's output")
                          + f"; {'device' if timer == 'profiler' else timer}"
                          f" {cold!r} ms cold L2, {warm!r} warm; "
                          f"launch {launch}, listed bricks {listed}; "
                          f"registers, shared bytes, spill bytes {usage}, on "
                          f"{card}", flush=True)
    finally:
        kfuse.library = saved
        kfuse._size_checked.clear()
    sectors = {p: dict(mark=v["mark_sectors"], stores=v["store_sectors"])
               for p, v in inputs.items()}
    print(json.dumps({"card": card, "kept_attrs": attrs,
                      "sectors": sectors, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
