"""The block set-up's and the hit refine's alternative designs measured on
the card.

``python -m rgbd_recon_tpu_torch.bench.setup_refine_variants [--iters 20]
[--parent DIR]`` builds csrc/render_stages.cu and csrc/hits.cu into one
library for each variant, under ``build/setup_refine_variants/``:

- ``kept``: the sources as they are (the set-up's tile: cells staged once,
  pools folded once, rows stored as whole lines; the refine's rounds of
  loads, the widened bracket 4 samples a chunk);
- ``setup_float4_stores``: each set-up thread's row as two float4 stores
  straight to blk;
- ``setup_writes_only`` (stripped): the set-up's outputs from constants,
  stored as the kept kernel stores them; no load, no pool;
- ``setup_loads_pools_only`` (stripped): the staging and the pools, each
  block reading its cell's five; nothing stored;
- ``refine_lanes``: the refine with REFINE_LANES lanes a hit, a widened
  sample a lane, the first rising pair by a ballot, the secant on the lane
  that holds it (the bracket's ends on one lane);
- ``refine_chunk_N``: the widened bracket N samples a chunk (8: K = 8 in
  one round); ``_6_blocks`` / ``_5_blocks``: under
  ``__launch_bounds__(128, 6)`` (at most 80 registers, so that the cells'
  792 blocks fit one wave) or ``(128, 5)``;
- ``refine_chunk_8_raw_rows`` / ``refine_chunk_8_shared_fractions``: 8
  samples a chunk with each sample's row kept as loaded (16 bf16 bytes)
  until its lerps, and, in the second, its three fractions kept in shared
  memory in place of registers;
- ``setup_dir_before_sync``: the set-up's centre ray computed before the
  staging's barrier;
- ``setup_grid_first``: the set-up's three constant grids stored before
  the staging's loads;
- ``parent`` (with ``--parent DIR``): the two sources of another checkout
  as they are, launched through this tree's wrappers (the parameter blocks
  differ only by fields appended at their ends).

It records the block_setup, hit_refine and hit_shade calls of one fast and
one parity frame of the cells' reference setup (``bench/headline.py
reference_setup``) and runs each variant's kernels on them through
``kernels/render_stages.py block_setup_cuda`` and ``kernels/hits.py
refine_cuda`` / ``shade_cuda``, every variant twice in turns (forward,
then backward): each output bit-equal to its twin (``block_setup_plain``,
``refine_hits_plain``, mode 0 of ``shade_hits_plain``) or the script fails,
the stripped forms' set-up excepted (they compute no set-up); the kernel's
own device time under torch.profiler with a cold L2 (a 256 MiB write and
read before each call) and warm (back to back), the launch, and ptxas'
registers, shared memory and spills. Prints the card line, a line a
variant, kernel and frame, and one JSON line. Exits 1 without a card,
before any work.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import hits as khits
from ..kernels import render_stages as kstages
from .scan_variants import _device_ms

SOURCES = (_build._PKG / "csrc" / "render_stages.cu",
           _build._PKG / "csrc" / "hits.cu")
OUT = _build.BUILD_DIR.parent / "setup_refine_variants"
ENTRIES = ("rgbd_render_block_setup", "rgbd_render_block_setup_plan",
           "rgbd_render_params_size", "rgbd_hit_refine",
           "rgbd_hit_refine_plan", "rgbd_hit_shade", "rgbd_hit_shade_plan",
           "rgbd_hit_params_sizes")
KERNELS = {"block_setup": "block_setup_kernel",
           "hit_refine": "refine_kernel", "hit_shade": "shade_kernel"}

SETUP_KERNEL = ("__global__ void __launch_bounds__(SETUP_THREADS)\n"
                "    block_setup_kernel(")
SETUP_END = "// ---- bracket "
# the set-up's rows as two float4 stores a thread
SETUP_STORES = """\
    float4* row = reinterpret_cast<float4*>(p.blk) + 2LL * b;
    row[0] = make_float4(pos[0], pos[1], pos[2], d[0]);
    row[1] = make_float4(d[1], d[2], length, s_start);
  }
}

"""
# stripped: the outputs from constants, stored as the kept kernel does
SETUP_WRITES = """\
__global__ void __launch_bounds__(SETUP_THREADS)
    block_setup_kernel(RenderParams p, Divisor q) {
  __shared__ float4 s_rows[SETUP_TY][2 * SETUP_TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx0 = blockIdx.x * SETUP_TX, by0 = blockIdx.y * SETUP_TY;
  const int bx = bx0 + tx, by = by0 + ty;
  if (bx < p.Wb && by < p.Hb) {
    const int b = by * p.Wb + bx;
    p.s_end[b] = 1.0f;
    p.bflags[b] = 3;
    p.grid[b] = 0.0f;
    p.grid[p.NB + b] = INFINITY;
    p.grid[2 * p.NB + b] = -INFINITY;
    s_rows[ty][2 * tx] = make_float4(0.5f, 0.5f, 0.5f, 0.0f);
    s_rows[ty][2 * tx + 1] = make_float4(0.0f, 1.0f, 0.1f, 0.2f);
  }
  __syncwarp();
  if (by < p.Hb) {
    const int words = 2 * min(SETUP_TX, p.Wb - bx0);
    float4* dst = reinterpret_cast<float4*>(p.blk) + 2LL * (by * p.Wb + bx0);
    for (int w = tx; w < words; w += SETUP_TX) dst[w] = s_rows[ty][w];
  }
}

"""
# stripped: from step 3 on, each block reads its cell's pools and stores
# nothing (a store under a test no input passes keeps the reads)
SETUP_STEP3 = "  // 3. a thread a block\n"
# the centre ray before the staging's barrier, not after the pools
SETUP_SYNC1 = "  __syncthreads();\n  // 2. a thread a (cell, plane)"
SETUP_DIR = """\
  float d[3];
  if (active) ray_dir(p, rot, by * p.ds + p.ds / 2, bx * p.ds + p.ds / 2, d);
  __syncthreads();
"""
SETUP_DIR_LATE = "    float d[3];\n    ray_dir(p, rot, by * p.ds"
# the constant grids first, their stores in flight with the staging's loads
SETUP_ACTIVE = "  const bool active = bx < p.Wb && by < p.Hb;\n"
SETUP_GRID = """\
  const bool active = bx < p.Wb && by < p.Hb;
  if (active) {
    const int b = by * p.Wb + bx;
    p.grid[b] = 0.0f;
    p.grid[p.NB + b] = INFINITY;
    p.grid[2 * p.NB + b] = -INFINITY;
  }
"""
SETUP_POOLS = """\
  if (active) {
    const int r = div_by(by, q) - i0, c = div_by(bx, q) - j0;
    float v = s_pool[0][r][c];
#pragma unroll
    for (int k = 1; k < 5; ++k) v = __fadd_rn(v, s_pool[k][r][c]);
    if (__float_as_int(v) == 0x7f800001) p.s_end[by * p.Wb + bx] = v;
  }
}

"""

REFINE_KERNEL = ("template <typename T>\n__global__ void "
                 "__launch_bounds__(THREADS)\n    refine_kernel(")
REFINE_END = "// ---- hit_shade: the normal "
REFINE_BOUND = "__launch_bounds__(THREADS)\n    refine_kernel("
OCT_SAMPLES = ("template <typename T, int N>\n__device__ __forceinline__ "
               "void oct_samples(")
OCT_SAMPLES_END = "\n// ---- hit_refine"
# oct_samples with each row kept as loaded until its lerps; with SHARED,
# each sample's fractions in shared memory (a word a thread a fraction)
OCT_SAMPLES_RAW = """\
template <typename T>
struct RawRow;
template <>
struct RawRow<unsigned short> {
  uint4 w;
};
template <>
struct RawRow<float> {
  float4 lo, hi;
};

__device__ __forceinline__ RawRow<unsigned short> load_raw(
    const unsigned short* rows, long long row) {
  return {__ldg(reinterpret_cast<const uint4*>(rows) + row)};
}

__device__ __forceinline__ RawRow<float> load_raw(const float* rows,
                                                  long long row) {
  const float4* r = reinterpret_cast<const float4*>(rows) + 2 * row;
  return {__ldg(r), __ldg(r + 1)};
}

__device__ __forceinline__ void unpack(const RawRow<unsigned short>& r,
                                       float c[8]) {
  const unsigned int u[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[2 * k] = __uint_as_float(u[k] << 16);
    c[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const RawRow<float>& r, float c[8]) {
  c[0] = r.lo.x;
  c[1] = r.lo.y;
  c[2] = r.lo.z;
  c[3] = r.lo.w;
  c[4] = r.hi.x;
  c[5] = r.hi.y;
  c[6] = r.hi.z;
  c[7] = r.hi.w;
}

template <typename T, int N>
__device__ __forceinline__ void oct_samples(const T* rows, const int* slots,
                                            const float px[N],
                                            const float py[N],
                                            const float pz[N], int n, int D,
                                            int H, int W, int v,
                                            const Divisor& q, float fill,
                                            float out[N]) {
#if SHARED
  __shared__ float s_f[3 * N][THREADS];
#endif
  float f[N][3];
  int bid[N], local[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      const CellAt at = oct_locate(px[k], py[k], pz[k], D, H, W, v, q);
      bid[k] = at.bid;
      local[k] = at.local;
#if SHARED
      s_f[3 * k][threadIdx.x] = at.fx;
      s_f[3 * k + 1][threadIdx.x] = at.fy;
      s_f[3 * k + 2][threadIdx.x] = at.fz;
#else
      f[k][0] = at.fx;
      f[k][1] = at.fy;
      f[k][2] = at.fz;
#endif
    }
  }
  int slot[N];
#pragma unroll
  for (int k = 0; k < N; ++k) slot[k] = k < n ? __ldg(slots + bid[k]) : -1;
  RawRow<T> raw[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (slot[k] >= 0)
      raw[k] = load_raw(rows, (long long)slot[k] * (v * v * v) + local[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (slot[k] < 0) {
      out[k] = fill;
      continue;
    }
#if SHARED
    f[k][0] = s_f[3 * k][threadIdx.x];
    f[k][1] = s_f[3 * k + 1][threadIdx.x];
    f[k][2] = s_f[3 * k + 2][threadIdx.x];
#endif
    float c[8];
    unpack(raw[k], c);
    out[k] = cell_value(c, f[k][0], f[k][1], f[k][2]);
  }
}
"""
REFINE_CHUNK = "constexpr int REFINE_CHUNK = 4;"


def _chunk(n: int, blocks: int = 0):
    """The changes of a refine of n samples a chunk, under a bound of
    ``blocks`` blocks an SM where given."""
    out = ((1, REFINE_CHUNK, "\n", f"constexpr int REFINE_CHUNK = {n};"),)
    if blocks:
        out += ((1, REFINE_BOUND, "refine_kernel(",
                 f"__launch_bounds__(THREADS, {blocks})\n    "),)
    return out
REFINE_LAUNCH = "  if (p->table_f32)\n    refine_kernel<float>"
REFINE_LAUNCH_END = "  return (int)cudaGetLastError();\n}\n\n// The shade's"
# REFINE_LANES lanes a hit, a widened sample a lane
REFINE_LANES = """\
constexpr int REFINE_LANES = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    refine_kernel(const RefineParams a, const Divisor q) {
  constexpr int L = REFINE_LANES;
  const int lane = threadIdx.x % L;
  const int base = (threadIdx.x & 31) & ~(L - 1);
  const unsigned group = ((1u << L) - 1u) << base;
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) / L;
  if (r >= a.n) return;
  float* out = a.out + r * 3;
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
    if (lane == 0) keep_march_pos(a, r, out);
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
    const float span_lo = sub(lo, a.widen_lo);
    const float span = add(sub(hi, lo), a.widen_span);
    float prev = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
    int kstar = -1, holder = 0;
    for (int k0 = 0; k0 < a.widen_k; k0 += L) {
      const int k = k0 + lane;
      float d = 0.0f;
      if (k < a.widen_k) {
        const float t[1] = {add(span_lo, mul(mul((float)k, a.inv_km1),
                                             span))};
        float o[1];
        oct_ray_samples<T, 1>(a, q, table, p0, dir, t, 1, o);
        d = o[0];
      }
      float before = __shfl_up_sync(group, d, 1, L);
      if (lane == 0) before = prev;
      const bool rising =
          k < a.widen_k && k > 0 && d > 0.0f && before <= 0.0f;
      const unsigned ballot = (__ballot_sync(group, rising) >> base) &
                              ((1u << L) - 1u);
      if (ballot) {
        holder = __ffs(ballot) - 1;
        kstar = k0 + holder - 1;
        d_lo = before;
        d_hi = d;
        break;
      }
      prev = __shfl_sync(group, d, L - 1, L);
    }
    if (lane != holder) return;
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
    if (lane != 0) return;
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

"""
REFINE_LANES_LAUNCH = """\
  const int blocks = blocks_for((long long)p->n * REFINE_LANES);
  if (p->table_f32)
    refine_kernel<float><<<blocks, THREADS, 0, s>>>(*p, q);
  else
    refine_kernel<unsigned short><<<blocks, THREADS, 0, s>>>(*p, q);
"""
# name -> (source index, the region's start, its end (not replaced), the
# region's replacement) of each change
VARIANTS = {
    "kept": (),
    "setup_float4_stores": (
        (0, "    s_rows[ty][2 * tx] = make_float4(", SETUP_END,
         SETUP_STORES),),
    "setup_writes_only": ((0, SETUP_KERNEL, SETUP_END, SETUP_WRITES),),
    "setup_loads_pools_only": ((0, SETUP_STEP3, SETUP_END, SETUP_POOLS),),
    "refine_lanes": ((1, REFINE_KERNEL, REFINE_END, REFINE_LANES),
                     (1, REFINE_LAUNCH, REFINE_LAUNCH_END,
                      REFINE_LANES_LAUNCH)),
    "refine_chunk_8": _chunk(8),
    "refine_chunk_8_6_blocks": _chunk(8, 6),
    "refine_chunk_8_5_blocks": _chunk(8, 5),
    "refine_chunk_3": _chunk(3),
    "refine_chunk_5_6_blocks": _chunk(5, 6),
    "refine_chunk_6_6_blocks": _chunk(6, 6),
    "refine_chunk_8_raw_rows": _chunk(8) + (
        (1, OCT_SAMPLES, OCT_SAMPLES_END,
         "#define SHARED 0\n" + OCT_SAMPLES_RAW),),
    "refine_chunk_8_shared_fractions": _chunk(8) + (
        (1, OCT_SAMPLES, OCT_SAMPLES_END,
         "#define SHARED 1\n" + OCT_SAMPLES_RAW),),
    "setup_grid_first": (
        (0, "    p.grid[b] = 0.0f;\n", "    s_rows[ty][2 * tx] =", ""),
        (0, SETUP_ACTIVE, "  // the tile's cells", SETUP_GRID)),
    "setup_dir_before_sync": ((0, SETUP_SYNC1, "  // 2. a thread", SETUP_DIR),
                              (0, SETUP_DIR_LATE, "    float pos[3];", "")),
}
# the variants whose set-up computes no set-up (timing probes)
STRIPPED = ("setup_writes_only", "setup_loads_pools_only")


def variant_sources(texts, changes):
    """(render_stages.cu, hits.cu) texts with a variant's changes: each
    region from its start (found once) up to its end (the first after it)
    replaced."""
    texts = list(texts)
    for k, start, end, other in changes:
        text = texts[k]
        if text.count(start) != 1:
            raise ValueError(f"a variant's region not found once in "
                             f"{SOURCES[k].name}")
        a = text.index(start)
        b = text.find(end, a)
        if b < 0:
            raise ValueError(f"a variant's region has no end in "
                             f"{SOURCES[k].name}")
        texts[k] = text[:a] + other + text[b:]
    return tuple(texts)


def _build_variant(name: str, parent=None):
    """(library path, ptxas report) of a variant; ``parent`` (a checkout's
    root): the variant "parent", that checkout's two sources as they are."""
    if parent is not None:
        texts = tuple((Path(parent) / s.relative_to(_build._PKG.parent))
                      .read_text() for s in SOURCES)
    else:
        texts = variant_sources(tuple(s.read_text() for s in SOURCES),
                                VARIANTS[name])
    srcs = []
    for src, text in zip(SOURCES, texts):
        path = OUT / f"{name}_{src.name}"
        path.write_text(text)
        srcs.append(str(path))
    lib = OUT / f"{name}.so"
    res = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS,
                          "-shared", "-o", str(lib), *srcs],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return lib, res.stderr


def ptxas_usage(report: str, kernel: str) -> dict:
    """{instance: (registers, shared bytes, spill store bytes)} of the
    entry functions of ``kernel`` in a ptxas -v report, an instance named
    by its template argument (f32 ``IfE``, bf16 ``ItE``, true ``ILb1E``,
    false ``ILb0E``) or "kernel"."""
    out, name, spills = {}, None, 0
    entry = re.compile(rf"Compiling entry function '(\S*{kernel}\S*)'")
    for line in report.splitlines():
        m = entry.search(line)
        if m:
            mangled = m.group(1)
            args = {"IfE": "f32", "ItE": "bf16", "ILb1E": "true",
                    "ILb0E": "false"}
            name = next((v for k, v in args.items()
                         if f"{kernel}{k}" in mangled), "kernel")
            spills = 0
        elif name and "spill stores" in line:
            spills = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (int(re.search(r"Used (\d+) registers", line)[1]),
                         int(smem[1]) if smem else 0, spills)
            name = None
    return out


def _load(lib):
    """The library with ENTRIES bound (a parent's may lack the plans)."""
    cdll = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        fn = getattr(cdll, entry, None)
        if fn is None and entry.endswith("_plan"):
            continue
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return cdll


def record_calls(device):
    """{frame: {kernel: (args, kwargs)}} of one fast and one parity frame
    of the reference setup: the block_setup, hit_refine and hit_shade
    calls of one render_from_baked."""
    from ..ops import hits, stage_calls
    from ..recon.tsdf_pipeline import TsdfPipeline
    from .headline import load_cell, reference_setup

    pipe, frames, camera = reference_setup(device)
    parity = load_cell("tsdf_parity_4kinect2_1cm")["pipeline"]
    out = {}
    for name, p in (("fast", pipe), ("parity", TsdfPipeline(
            pipe.calib, dataclasses.replace(pipe.config, **parity),
            pipe.bbox))):
        render, cam = p.make_render_fn(camera)
        volume, maps, counts = p.fuse(frames)
        args = (render.bake(volume, counts), maps, cam,
                p._get_projection_models(), p._limit)
        got = {}
        fns = {"hit_refine": hits.refine_hits, "hit_shade": hits.shade_hits}

        def recorder(key):
            def record(*a, **kw):
                got[key] = (a, kw)
                return fns[key](*a, **kw)
            return record

        hits.refine_hits = recorder("hit_refine")
        hits.shade_hits = recorder("hit_shade")
        try:
            calls = stage_calls.record_stages(
                lambda: render.render_from_baked(*args))
        finally:
            hits.refine_hits = fns["hit_refine"]
            hits.shade_hits = fns["hit_shade"]
        (setup,) = [c for c in calls if c[0] == "block_setup"]
        got["block_setup"] = (setup[1], {})
        out[name] = got
    return out


def bracket_rises(args, kwargs) -> dict:
    """{k*: live hits} of a recorded refine call with the widened bracket:
    where each live hit's first rising pair d_k* <= 0 < d_k*+1 lies among
    its K samples (-1: none), from the twin's samples (oct.sample_p at
    every t_k); {} without the widened bracket. The loop the kernel
    replaced took k* + 2 samples, one after the other."""
    import numpy as np

    oct = kwargs.get("oct")
    K = int(kwargs.get("widen_samples", 0))
    ws = float(kwargs.get("widen_steps", 0.0))
    if oct is None or ws <= 0.0 or K < 3:
        return {}
    pos0, dn, lo_t, hi_t, hit, _, limit = args
    sd = float(np.float32(limit) * np.float32(0.5))
    span_lo = lo_t - ws * sd
    span = (hi_t - lo_t) + 2.0 * ws * sd
    ks = torch.arange(K, dtype=torch.float32, device=lo_t.device) / (K - 1)
    tk = span_lo[..., None] + ks * span[..., None]
    d = oct.sample_p(*[p[..., None] + v[..., None] * tk
                       for p, v in zip(pos0, dn)], -limit)
    rising = (d[..., 1:] > 0.0) & (d[..., :-1] <= 0.0)
    k = torch.where(rising.any(dim=-1),
                    rising.to(torch.float32).argmax(dim=-1), -1)[hit]
    vals, counts = torch.unique(k, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}


def _kernel_fns(frame_calls):
    """{kernel: its call on a frame's recorded inputs} (the shade's rgba)."""
    from ..ops import hits

    (sa, _), (ra, rkw), (ha, hkw) = (frame_calls[k] for k in KERNELS)
    skernel = hits.shade_kernel_args(*ha, **hkw)
    return {"block_setup": lambda: kstages.block_setup_cuda(*sa),
            "hit_refine": lambda: khits.refine_cuda(*ra, **rkw),
            "hit_shade": lambda: khits.shade_cuda(**skernel)[0]}


def _twins(frame_calls):
    """{kernel: its twin's result on a frame's recorded inputs}."""
    from ..ops import hits
    from ..ops.render_stages import block_setup_plain

    (sa, _), (ra, rkw), (ha, hkw) = (frame_calls[k] for k in KERNELS)
    return {"block_setup": block_setup_plain(*sa),
            "hit_refine": hits.refine_hits_plain(*ra, **rkw),
            "hit_shade": hits.shade_hits_plain(*ha, **hkw)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="a checkout (e.g. the parent commit unpacked) whose "
                         "two sources run as one more variant, 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("setup_refine_variants: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import stage_calls
    from .trace import card_line

    card = card_line()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    names = [*VARIANTS, *(["parent"] if args.parent else [])]
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build_variant(n, args.parent if n == "parent"
                                     else None), names)))
    device = torch.device("cuda")
    flush_w = torch.empty(64 * 2 ** 20, device=device)
    flush_r = torch.ones(64 * 2 ** 20, device=device)

    def flush():
        flush_w.fill_(1.0)
        flush_r.sum()

    recorded = record_calls(device)
    wants = {frame: _twins(fc) for frame, fc in recorded.items()}
    rises = {frame: bracket_rises(*fc["hit_refine"])
             for frame, fc in recorded.items()}
    print(f"live hits by the widened bracket's first rising pair k* (-1 "
          f"none): {rises}", flush=True)
    rows = []
    saved = kstages.library, khits.library
    try:
        for name in [*names, *reversed(names)]:
            lib, report = built[name]
            cdll = _load(lib)
            kstages.library = khits.library = lambda cdll=cdll: cdll
            kstages._size_checked[:] = [True]
            khits._sizes_checked[:] = [True]
            times = {}
            for kernel, kname in KERNELS.items():
                calls = {}
                for frame, fc in recorded.items():
                    kern, want = _kernel_fns(fc)[kernel], wants[frame][kernel]
                    got = kern()
                    torch.cuda.synchronize()
                    checked = not (kernel == "block_setup"
                                   and name in STRIPPED)
                    if checked and not stage_calls.all_bits_equal(got,
                                                                  want):
                        raise AssertionError(f"{name} {frame}: {kernel} "
                                             "differs from its twin")
                    calls[frame] = kern
                for frame, t in _device_ms(calls, flush, args.iters,
                                           kname).items():
                    times[(kernel, frame)] = t
            usage = {k: ptxas_usage(report, kn) for k, kn in KERNELS.items()}
            plans = hasattr(cdll, "rgbd_hit_refine_plan")
            for (kernel, frame), (cold, warm) in times.items():
                fc = recorded[frame]
                launch = None   # a parent's library has no such plans
                if plans and kernel == "block_setup":
                    launch = kstages.block_setup_plan(fc[kernel][0][0])
                elif plans and kernel == "hit_refine":
                    launch = khits.refine_plan(fc[kernel][0][4].numel())
                    if name == "refine_lanes":
                        launch = dict(launch, lanes=8, chunk=8,
                                      blocks=8 * launch["blocks"])
                    elif name.startswith("refine_chunk_"):
                        launch = dict(launch, chunk=int(name.split("_")[2]))
                elif kernel == "hit_shade":
                    launch = khits.shade_plan(fc[kernel][0][3].numel())
                checked = not (kernel == "block_setup" and name in STRIPPED)
                row = dict(variant=name, kernel=kernel, frame=frame,
                           bit_equal=checked, device_ms=cold,
                           device_ms_warm=warm, launch=launch,
                           registers_shared_spills=usage[kernel])
                rows.append(row)
                print(f"{kernel} {name} {frame}: "
                      + ("bit-equal to its twin" if checked
                         else "stripped, not a set-up")
                      + f"; device {cold!r} ms cold L2, {warm!r} warm; "
                      f"launch {launch}; registers, shared bytes, spill "
                      f"bytes {usage[kernel]}, on {card}", flush=True)
    finally:
        kstages.library, khits.library = saved
        kstages._size_checked.clear()
        khits._sizes_checked.clear()
    print(json.dumps({"card": card, "rises": rises,
                      "setup_refine_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
