"""The render's hit gather in its alternative designs, measured on the card.

``python -m rgbd_recon_tpu_torch.bench.hit_gather_variants [--iters 20]
[--parent DIR]`` builds csrc/render_stages.cu into one library for each
variant, under ``build/hit_gather_variants/``:

- ``kept``: the source as it is (a slot a thread, 128 a thread block; its
  two rows in one round of 16-byte loads; its row as two float4 stores, its
  position as three stores, its live byte as one);
- ``staged_lines`` (at 128 threads) and ``staged_lines_256``: the thread
  block's rows, positions and live bytes staged in shared memory and stored
  as 16-byte words by consecutive threads after one barrier;
- ``threads_128``, ``threads_256``, ``threads_512``: the kept kernel at
  that many slots a thread block;
- ``warp_lines``: a warp's rows, positions and live bytes staged and
  stored as 16-byte words after a ``__syncwarp`` (no block barrier);
  ``warp_lines_rows_direct``: its rows as two float4 stores a thread, only
  the positions and live bytes staged;
- ``four_slots_64``, ``four_slots_128``: four consecutive slots a thread
  (16 row loads in one round; positions and live bytes as whole words), at
  64 or 128 threads a block;
- ``writes_only`` (stripped): the kept kernel's stores from constants; no
  load;
- ``loads_only`` (stripped): its loads and positions; nothing stored (a
  store under a test no input passes keeps the loads);
- ``parent`` (with ``--parent DIR``): another checkout's source as it is,
  launched through this tree's wrapper.

It records the hit_gather call of one fast and one parity frame of the
cells' reference setup (``bench/headline.py reference_setup``) and runs
each variant on them through ``kernels/render_stages.py hit_gather_cuda``,
every variant twice in turns (forward, then backward): its outputs
bit-equal to ``hit_gather_plain`` or the script fails, the stripped forms
excepted; the kernel's own device time under torch.profiler with a cold L2
(a 256 MiB write and read before each call), warm (back to back) and in
the whole render (its inputs as the marches and the compaction leave them;
not for the stripped forms, whose outputs the render cannot use), the
launch, and ptxas' registers, shared memory and spills. Prints the card
line, a line a variant and frame, and one JSON line. Exits 1 without a
card, before any work.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import render_stages as kstages
from .scan_variants import _device_ms
from .setup_refine_variants import ptxas_usage

SOURCE = _build._PKG / "csrc" / "render_stages.cu"
OUT = _build.BUILD_DIR.parent / "hit_gather_variants"
# every entry of the source: the variant's library also serves the render's
# other stages when the whole render runs on it
ENTRIES = tuple(k for k in _build._SIGNATURES if k.startswith("rgbd_render_"))
KERNEL = "hit_gather_kernel"

BODY = ("  const long long h = (long long)blockIdx.x * GATHER_THREADS + "
        "threadIdx.x;\n")
BODY_END = "}\n\n// ---- compose "
LOADS = "  const long long id = __ldg(p.hit_idx + h);\n"
STORES = "  float4* row = reinterpret_cast<float4*>(p.hrows) + 2 * h;\n"
THREADS_LINE = "constexpr int GATHER_THREADS = "
PLAN_BLOCKS = "  out[0] = (int)(((long long)p.capH + GATHER_THREADS - 1) /"
PLAN_BLOCKS_END = "  out[1] = GATHER_THREADS;"
# a slot a thread, the thread block's rows, positions and live bytes staged
# in shared memory and stored as 16-byte words by consecutive threads after
# one barrier (a ragged block's tails element by element)
STAGED_LINES = """\
  __shared__ float4 s_rows[2 * GATHER_THREADS];
  __shared__ __align__(16) float s_pos[3 * GATHER_THREADS];
  __shared__ __align__(16) unsigned char s_live[GATHER_THREADS];
  const int tid = threadIdx.x;
  const long long h0 = (long long)blockIdx.x * GATHER_THREADS;
  const int n = (int)min((long long)GATHER_THREADS, p.capH - h0);
  if (tid < n) {
    const long long id = __ldg(p.hit_idx + h0 + tid);
    const bool live = id < p.R;
    const long long r = live ? id : p.R - 1;
    const float4* ray = reinterpret_cast<const float4*>(p.ray8) + 2 * r;
    const float4 a = __ldg(ray), b = __ldg(ray + 1);
    const float4 s = __ldg(reinterpret_cast<const float4*>(p.st8) + 2 * r);
    const float2 t = __ldg(reinterpret_cast<const float2*>(p.st8 + 8 * r + 4));
    s_rows[2 * tid] = a;
    s_rows[2 * tid + 1] = make_float4(b.x, b.y, s.w, t.x);
    s_pos[3 * tid] = __fadd_rn(a.x, __fmul_rn(a.w, t.y));
    s_pos[3 * tid + 1] = __fadd_rn(a.y, __fmul_rn(b.x, t.y));
    s_pos[3 * tid + 2] = __fadd_rn(a.z, __fmul_rn(b.y, t.y));
    s_live[tid] = live;
  }
  __syncthreads();
  float4* rows = reinterpret_cast<float4*>(p.hrows) + 2 * h0;
  for (int w = tid; w < 2 * n; w += GATHER_THREADS) rows[w] = s_rows[w];
  float* pos = p.hpos + 3 * h0;
  const int pos_words = 3 * n / 4;
  for (int w = tid; w < pos_words; w += GATHER_THREADS)
    reinterpret_cast<float4*>(pos)[w] =
        reinterpret_cast<const float4*>(s_pos)[w];
  for (int i = 4 * pos_words + tid; i < 3 * n; i += GATHER_THREADS)
    pos[i] = s_pos[i];
  unsigned char* live = p.live + h0;
  const int live_words = n / 16;
  for (int w = tid; w < live_words; w += GATHER_THREADS)
    reinterpret_cast<uint4*>(live)[w] =
        reinterpret_cast<const uint4*>(s_live)[w];
  for (int i = 16 * live_words + tid; i < n; i += GATHER_THREADS)
    live[i] = s_live[i];
"""
# a warp's slots staged and stored as whole lines after a __syncwarp, no
# block barrier; with ROWS_DIRECT, each row as two float4 stores from its
# thread and only the positions and live bytes staged
WARP_LINES = """\
  __shared__ float4 s_rows[2 * GATHER_THREADS];
  __shared__ __align__(16) float s_pos[3 * GATHER_THREADS];
  __shared__ __align__(16) unsigned char s_live[GATHER_THREADS];
  const int tid = threadIdx.x, lane = tid & 31, w0 = tid & ~31;
  const long long h0 = (long long)blockIdx.x * GATHER_THREADS + w0;
  if (h0 >= p.capH) return;
  const int n = (int)min(32LL, p.capH - h0);
  if (lane < n) {
    const long long id = __ldg(p.hit_idx + h0 + lane);
    const bool live = id < p.R;
    const long long r = live ? id : p.R - 1;
    const float4* ray = reinterpret_cast<const float4*>(p.ray8) + 2 * r;
    const float4 a = __ldg(ray), b = __ldg(ray + 1);
    const float4 s = __ldg(reinterpret_cast<const float4*>(p.st8) + 2 * r);
    const float2 t = __ldg(reinterpret_cast<const float2*>(p.st8 + 8 * r + 4));
#if ROWS_DIRECT
    float4* row = reinterpret_cast<float4*>(p.hrows) + 2 * (h0 + lane);
    row[0] = a;
    row[1] = make_float4(b.x, b.y, s.w, t.x);
#else
    s_rows[2 * tid] = a;
    s_rows[2 * tid + 1] = make_float4(b.x, b.y, s.w, t.x);
#endif
    s_pos[3 * tid] = __fadd_rn(a.x, __fmul_rn(a.w, t.y));
    s_pos[3 * tid + 1] = __fadd_rn(a.y, __fmul_rn(b.x, t.y));
    s_pos[3 * tid + 2] = __fadd_rn(a.z, __fmul_rn(b.y, t.y));
    s_live[tid] = live;
  }
  __syncwarp();
#if !ROWS_DIRECT
  float4* rows = reinterpret_cast<float4*>(p.hrows) + 2 * h0;
  for (int w = lane; w < 2 * n; w += 32) rows[w] = s_rows[2 * w0 + w];
#endif
  float* pos = p.hpos + 3 * h0;
  const float* spos = s_pos + 3 * w0;
  const int pos_words = 3 * n / 4;
  for (int w = lane; w < pos_words; w += 32)
    reinterpret_cast<float4*>(pos)[w] =
        reinterpret_cast<const float4*>(spos)[w];
  for (int i = 4 * pos_words + lane; i < 3 * n; i += 32) pos[i] = spos[i];
  unsigned char* live = p.live + h0;
  const int live_words = n / 16;
  for (int w = lane; w < live_words; w += 32)
    reinterpret_cast<uint4*>(live)[w] =
        reinterpret_cast<const uint4*>(s_live + w0)[w];
  for (int i = 16 * live_words + lane; i < n; i += 32)
    live[i] = s_live[w0 + i];
"""
# four consecutive slots a thread: 16 row loads in one round, the rows as
# 8 float4 stores, the positions as 3 float4, the live bytes as one word
FOUR_SLOTS = """\
  const long long h =
      4 * ((long long)blockIdx.x * GATHER_THREADS + threadIdx.x);
  if (h >= p.capH) return;
  const int m = (int)min(4LL, p.capH - h);
  float4 a[4], b[4], s[4];
  float2 t[4];
  bool lv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long id = k < m ? __ldg(p.hit_idx + h + k) : p.R;
    lv[k] = id < p.R;
    const long long r = lv[k] ? id : p.R - 1;
    const float4* ray = reinterpret_cast<const float4*>(p.ray8) + 2 * r;
    a[k] = __ldg(ray);
    b[k] = __ldg(ray + 1);
    s[k] = __ldg(reinterpret_cast<const float4*>(p.st8) + 2 * r);
    t[k] = __ldg(reinterpret_cast<const float2*>(p.st8 + 8 * r + 4));
  }
  float pos[12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pos[3 * k] = __fadd_rn(a[k].x, __fmul_rn(a[k].w, t[k].y));
    pos[3 * k + 1] = __fadd_rn(a[k].y, __fmul_rn(b[k].x, t[k].y));
    pos[3 * k + 2] = __fadd_rn(a[k].z, __fmul_rn(b[k].y, t[k].y));
  }
  float4* row = reinterpret_cast<float4*>(p.hrows) + 2 * h;
  if (m == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[2 * k] = a[k];
      row[2 * k + 1] = make_float4(b[k].x, b[k].y, s[k].w, t[k].x);
    }
    float4* hp = reinterpret_cast<float4*>(p.hpos + 3 * h);
    hp[0] = make_float4(pos[0], pos[1], pos[2], pos[3]);
    hp[1] = make_float4(pos[4], pos[5], pos[6], pos[7]);
    hp[2] = make_float4(pos[8], pos[9], pos[10], pos[11]);
    *reinterpret_cast<uchar4*>(p.live + h) =
        make_uchar4(lv[0], lv[1], lv[2], lv[3]);
    return;
  }
  for (int k = 0; k < m; ++k) {
    row[2 * k] = a[k];
    row[2 * k + 1] = make_float4(b[k].x, b[k].y, s[k].w, t[k].x);
    for (int c = 0; c < 3; ++c) p.hpos[3 * (h + k) + c] = pos[3 * k + c];
    p.live[h + k] = lv[k];
  }
"""
FOUR_SLOTS_PLAN = """\
  const long long quads = ((long long)p.capH + 3) / 4;
  out[0] = (int)((quads + GATHER_THREADS - 1) / GATHER_THREADS);
"""
# stripped: the stores from constants, no load
WRITES_ONLY = """\
  float4* row = reinterpret_cast<float4*>(p.hrows) + 2 * h;
  row[0] = make_float4(0.5f, 0.5f, 0.5f, 0.0f);
  row[1] = make_float4(0.0f, 1.0f, 0.1f, 0.2f);
  float* pos = p.hpos + 3 * h;
  pos[0] = 0.5f;
  pos[1] = 0.6f;
  pos[2] = 0.7f;
  p.live[h] = 1;
"""
# stripped: the loads and the positions, stored only under a test no input
# passes (so the loads stay)
LOADS_ONLY = """\
  float v = __fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w));
  v = __fadd_rn(__fadd_rn(v, b.x), __fadd_rn(b.y, s.w));
  v = __fadd_rn(__fadd_rn(v, t.x), __fadd_rn(a.x, __fmul_rn(a.w, t.y)));
  v = __fadd_rn(__fadd_rn(v, __fadd_rn(a.y, __fmul_rn(b.x, t.y))),
                __fadd_rn(a.z, __fmul_rn(b.y, t.y)));
  v = __fadd_rn(v, (float)live);
  if (__float_as_int(v) == 0x7f800001) p.hpos[3 * h] = v;
"""


def _threads(n: int):
    return ((THREADS_LINE, ";\n", f"{THREADS_LINE}{n}"),)


def _body(text: str):
    return ((BODY, BODY_END, text),)


def _four_slots(n: int):
    return (*_body(FOUR_SLOTS), *_threads(n),
            (PLAN_BLOCKS, PLAN_BLOCKS_END, FOUR_SLOTS_PLAN))


# name -> the changes: (a region's start (found once), its end (the first
# after it, not replaced), the region's replacement)
VARIANTS = {
    "kept": (),
    "staged_lines": _body(STAGED_LINES),
    "staged_lines_256": (*_body(STAGED_LINES), *_threads(256)),
    "threads_128": _threads(128),
    "threads_256": _threads(256),
    "threads_512": _threads(512),
    "warp_lines": _body("#define ROWS_DIRECT 0\n" + WARP_LINES),
    "warp_lines_rows_direct": _body("#define ROWS_DIRECT 1\n" + WARP_LINES),
    "four_slots_64": _four_slots(64),
    "four_slots_128": _four_slots(128),
    "writes_only": ((LOADS, STORES, ""), (STORES, BODY_END, WRITES_ONLY)),
    "loads_only": ((STORES, BODY_END, LOADS_ONLY),),
}
# the variants that compute no gather (timing probes)
STRIPPED = ("writes_only", "loads_only")


def variant_source(text: str, name: str) -> str:
    """render_stages.cu's text with a variant's changes."""
    for start, end, other in VARIANTS[name]:
        if text.count(start) != 1:
            raise ValueError(f"{name}: a region not found once in "
                             f"{SOURCE.name}")
        a = text.index(start)
        b = text.find(end, a + len(start))
        if b < 0:
            raise ValueError(f"{name}: a region has no end in {SOURCE.name}")
        text = text[:a] + other + text[b:]
    return text


def _build_variant(name: str, parent=None):
    """(library path, ptxas report) of a variant; ``parent`` (a checkout's
    root): the variant "parent", that checkout's source as it is."""
    if parent is not None:
        text = (Path(parent) / SOURCE.relative_to(_build._PKG.parent)
                ).read_text()
    else:
        text = variant_source(SOURCE.read_text(), name)
    src = OUT / f"{name}_{SOURCE.name}"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    res = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS,
                          "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return lib, res.stderr


def _load(lib):
    """The library with ENTRIES bound (a parent's lacks the plan)."""
    cdll = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        fn = getattr(cdll, entry, None)
        if fn is None:
            continue
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return cdll


def record_calls(device):
    """{frame: (the recorded hit_gather call's arguments, a function that
    renders the frame from its bake)} of one fast and one parity frame of
    the reference setup."""
    from ..ops import stage_calls
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
        calls = stage_calls.record_stages(
            lambda: render.render_from_baked(*args))
        (gather,) = [c for c in calls if c[0] == "hit_gather"]
        out[name] = (gather[1],
                     lambda r=render, a=args: r.render_from_baked(*a))
    return out


def in_render_ms(renders: dict, iters: int) -> dict:
    """{frame: mean device ms of the gather within ``iters`` whole renders}
    (its inputs as the render leaves them: the list just compacted, the
    rows written by the marches), from one torch.profiler trace (taken
    again, at most TRACE_TRIES times, when it lacks a launch)."""
    from torch.profiler import ProfilerActivity, profile

    from .trace import TRACE_TRIES, device_us, on_device

    out = {}
    for frame, render in renders.items():
        render()
        for _ in range(TRACE_TRIES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    render()
                torch.cuda.synchronize()
            ms = [device_us(e) / 1e3 for e in prof.events()
                  if on_device(e) and KERNEL in e.name]
            if len(ms) == iters:
                break
        else:
            raise RuntimeError(f"the profiler recorded {len(ms)} {KERNEL} "
                               f"launches of {iters} renders")
        out[frame] = sum(ms) / iters
    return out


def sector_bytes(ray8, st8, hit_idx, outs) -> int:
    """The bytes a gather moves counted in 32-byte sectors: its list and
    outputs once, a live slot's two rows one sector each, and row R - 1 for
    the padding."""
    live = int((hit_idx < ray8.shape[0]).sum())
    dead = hit_idx.numel() - live
    nb = sum(t.numel() * t.element_size() for t in (hit_idx, *outs))
    return nb + 64 * live + 64 * (dead > 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="a checkout (e.g. the parent commit unpacked) whose "
                         "source runs as one more variant, 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hit_gather_variants: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import stage_calls
    from ..ops.render_stages import hit_gather_plain
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
    renders = {f: r for f, (_, r) in recorded.items()}
    recorded = {f: a for f, (a, _) in recorded.items()}
    wants = {f: hit_gather_plain(*a) for f, a in recorded.items()}
    for f, a in recorded.items():
        live = int((a[2] < a[0].shape[0]).sum())
        print(f"hit_gather {f}: {a[2].numel()} slots, {live} live, "
              f"{a[0].shape[0]} rays; "
              f"{sector_bytes(*a, wants[f])} B in 32-byte sectors",
              flush=True)
    rows = []
    saved = kstages.library
    try:
        for name in [*names, *reversed(names)]:
            lib, report = built[name]
            cdll = _load(lib)
            kstages.library = lambda cdll=cdll: cdll
            kstages._size_checked[:] = [True]
            checked = name not in STRIPPED
            calls = {}
            for frame, a in recorded.items():
                got = kstages.hit_gather_cuda(*a)
                torch.cuda.synchronize()
                if checked and not stage_calls.all_bits_equal(got,
                                                              wants[frame]):
                    raise AssertionError(f"{name} {frame}: hit_gather "
                                         "differs from its twin")
                calls[frame] = lambda a=a: kstages.hit_gather_cuda(*a)
            times = _device_ms(calls, flush, args.iters, KERNEL)
            rendered = (in_render_ms(renders, args.iters) if checked
                        else dict.fromkeys(renders))
            usage = ptxas_usage(report, KERNEL)
            launch = (kstages.hit_gather_plan(recorded["fast"][2].numel())
                      if hasattr(cdll, "rgbd_render_hit_gather_plan")
                      else None)
            if name.startswith("four_slots") and launch is not None:
                launch = dict(launch, slots_a_thread=4)
            for frame, (cold, warm) in times.items():
                rows.append(dict(variant=name, frame=frame,
                                 bit_equal=checked, device_ms=cold,
                                 device_ms_warm=warm,
                                 device_ms_in_render=rendered[frame],
                                 launch=launch,
                                 registers_shared_spills=usage))
                print(f"hit_gather {name} {frame}: "
                      + ("bit-equal to its twin" if checked
                         else "stripped, not a gather")
                      + f"; device {cold!r} ms cold L2, {warm!r} warm, "
                      f"{rendered[frame]!r} in the render; "
                      f"launch {launch}; registers, shared bytes, spill "
                      f"bytes {usage}, on {card}", flush=True)
    finally:
        kstages.library = saved
        kstages._size_checked.clear()
    print(json.dumps({"card": card, "hit_gather_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
