"""The bracket's and the morph's alternative designs measured on the card.

``python -m rgbd_recon_tpu_torch.bench.bracket_morph_variants [--iters 20]``
builds csrc/render_stages.cu and csrc/preprocess.cu into one library for
each variant, under ``build/bracket_morph_variants/``:

- ``kept``: the sources as they are (the bracket's rows staged in shared
  memory and stored by the thread block as whole lines; the morph's window
  from registers, the neighbour columns by shuffle);
- ``bracket_float4_stores``: each bracket thread's row as two float4
  stores straight to ray8 (``BRACKET_STORES``);
- ``morph_staged_tile``: the morph's tile staged in shared memory with its
  halo, the window read from there (``MORPH_TILE``);
- ``morph_8_blocks_an_sm``: the morph under ``__launch_bounds__(256, 8)``
  (at most 32 registers, so its 848 blocks fit one wave);
- ``parent`` (with ``--parent DIR``): the two sources of another checkout
  as they are, its kernels launched through this tree's wrappers (the
  parameter block and the entry points are the same).

It records the bracket call of one fast and one parity frame of the cells'
reference setup (``bench/headline.py reference_setup``) and the morph call
of one fast fuse, and runs both kernels of each library on those inputs
through ``kernels/render_stages.py bracket_cuda`` and
``kernels/preprocess.py morph_cuda``, every variant twice in turns
(forward, then backward): bit-equal to ``bracket_plain`` /
``morph_dilate_plain`` or the script fails; the kernel's own device time
under torch.profiler with a cold L2 (a 256 MiB write and read before each
call) and warm (back to back), the launch, and ptxas' registers and
spills. Also the fuse's pixels by the morph's exit. Prints the card line,
a line a variant, kernel and frame, and one JSON line. Exits 1 without a
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
from ..kernels import preprocess as kpre
from ..kernels import render_stages as kstages
from .scan_variants import _device_ms, _registers

SOURCES = (_build._PKG / "csrc" / "render_stages.cu",
           _build._PKG / "csrc" / "preprocess.cu")
OUT = _build.BUILD_DIR.parent / "bracket_morph_variants"
ENTRIES = ("rgbd_render_bracket", "rgbd_render_bracket_plan",
           "rgbd_render_params_size", "rgbd_pre_morph",
           "rgbd_pre_morph_plan")

# the bracket's step 4 as kept (the thread block's rows staged, stored
# as whole lines) and each thread's two float4 stores to its row
BRACKET_LINES = """\
  // 4. a thread a ray, its row staged; the thread block's rows (contiguous
  //    in ray8) stored as whole lines
  const int s = threadIdx.z, slot = slot0 + s;
  if (slot < p.capB) {
    float d[3];
    ray_dir(p, s_blk[s][1] * p.ds + threadIdx.y,
            s_blk[s][2] * p.ds + threadIdx.x, d);
    const float start = s_ray[s][0];
    float pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      pos[a] = __fadd_rn(__ldg(p.eye + a), __fmul_rn(d[a], start));
    s_rows[2 * tid] = make_float4(pos[0], pos[1], pos[2], d[0]);
    s_rows[2 * tid + 1] = make_float4(d[1], d[2], s_ray[s][1], s_ray[s][2]);
  }
  __syncthreads();
  const int words = 2 * min(slots, p.capB - slot0) * p.B2;
  float4* rows = reinterpret_cast<float4*>(p.ray8) + 2LL * slot0 * p.B2;
  for (int i = tid; i < words; i += nthreads) rows[i] = s_rows[i];
}
"""
BRACKET_STORES = """\
  // 4. a thread a ray, its row as two float4 stores
  const int s = threadIdx.z, slot = slot0 + s;
  if (slot >= p.capB) return;
  float d[3];
  ray_dir(p, s_blk[s][1] * p.ds + threadIdx.y,
          s_blk[s][2] * p.ds + threadIdx.x, d);
  const float start = s_ray[s][0];
  float pos[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    pos[a] = __fadd_rn(__ldg(p.eye + a), __fmul_rn(d[a], start));
  const long long r =
      (long long)slot * p.B2 + threadIdx.y * p.ds + threadIdx.x;
  float4* row = reinterpret_cast<float4*>(p.ray8) + 2 * r;
  row[0] = make_float4(pos[0], pos[1], pos[2], d[0]);
  row[1] = make_float4(d[1], d[2], s_ray[s][1], s_ray[s][2]);
}
"""
# the morph's window as kept (registers, the neighbour columns by
# shuffle) and the tile staged in shared memory with its halo
MORPH_SHUFFLE = """\
template <bool VEC>
__device__ __forceinline__ void morph_window(const float* __restrict__ d,
                                             int H, int W, int x0, int y0,
                                             float v[3][6]) {
  const int x = x0 + 4 * threadIdx.x, y = y0 + threadIdx.y;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* row = d + (long long)clamp_idx(y - 1 + r, H) * W;
    if (VEC) {
      float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (x < W) m = __ldg(reinterpret_cast<const float4*>(row + x));
      v[r][1] = m.x;
      v[r][2] = m.y;
      v[r][3] = m.z;
      v[r][4] = m.w;
      float left = __shfl_up_sync(0xffffffffu, m.w, 1);
      float right = __shfl_down_sync(0xffffffffu, m.x, 1);
      if (threadIdx.x == 0) left = __ldg(row + clamp_idx(x - 1, W));
      if (threadIdx.x == BLOCK_X - 1 || x + 4 >= W)
        right = __ldg(row + clamp_idx(x + 4, W));
      v[r][0] = left;
      v[r][5] = right;
    } else {
#pragma unroll
      for (int j = 0; j < 6; ++j)
        v[r][j] = __ldg(row + clamp_idx(x - 1 + j, W));
    }
  }
}
"""
MORPH_TILE = """\
constexpr int MS_H = MT_H + 2;  // staged rows
// staged columns: the tile at 4 (16-byte aligned), its halo at 3 and
// MT_W + 4
constexpr int MS_W = MT_W + 8;

template <bool VEC>
__device__ __forceinline__ void morph_window(const float* __restrict__ d,
                                             int H, int W, int x0, int y0,
                                             float v[3][6]) {
  __shared__ __align__(16) float s_d[MS_H][MS_W];
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  constexpr int WORDS = MT_W / 4;
  if (VEC) {
    // the tile's columns inside the map (W % 4 == 0: whole words)
    for (int i = tid; i < MS_H * WORDS; i += BLOCK_X * BLOCK_Y) {
      const int r = i / WORDS, q = i - r * WORDS;
      const int gx = x0 + 4 * q;
      if (gx >= W) continue;
      const long long row = (long long)clamp_idx(y0 - 1 + r, H) * W;
      *reinterpret_cast<float4*>(&s_d[r][4 + 4 * q]) =
          __ldg(reinterpret_cast<const float4*>(d + row + gx));
    }
    // the halo columns inside the map
    if (tid < 2 * MS_H) {
      const int r = tid >> 1;
      const int gx = (tid & 1) ? x0 + MT_W : x0 - 1;
      if (gx >= 0 && gx < W)
        s_d[r][gx - x0 + 4] =
            __ldg(d + (long long)clamp_idx(y0 - 1 + r, H) * W + gx);
    }
  } else {
    for (int i = tid; i < MS_H * (MT_W + 2); i += BLOCK_X * BLOCK_Y) {
      const int r = i / (MT_W + 2), c = i - r * (MT_W + 2);
      const int gx = x0 - 1 + c;
      if (gx < 0 || gx >= W) continue;
      s_d[r][gx - x0 + 4] =
          __ldg(d + (long long)clamp_idx(y0 - 1 + r, H) * W + gx);
    }
  }
  __syncthreads();
  const int x = x0 + 4 * threadIdx.x;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* row = s_d[threadIdx.y + r];
    if (VEC) {
      const float4 m = *reinterpret_cast<const float4*>(row + x - x0 + 4);
      v[r][1] = m.x;
      v[r][2] = m.y;
      v[r][3] = m.z;
      v[r][4] = m.w;
    } else {
#pragma unroll
      for (int j = 1; j <= 4; ++j)
        v[r][j] = row[clamp_idx(x - 1 + j, W) - x0 + 4];
    }
    v[r][0] = row[clamp_idx(x - 1, W) - x0 + 4];
    v[r][5] = row[clamp_idx(x + 4, W) - x0 + 4];
  }
}
"""
# the morph under a bound of 8 blocks an SM (at most 32 registers)
MORPH_BOUND = ("__launch_bounds__(BLOCK_X * BLOCK_Y)\n    morph_kernel",
               "__launch_bounds__(BLOCK_X * BLOCK_Y, 8)\n    morph_kernel")
# name -> (source index, kept text, its replacement) of each change
VARIANTS = {
    "kept": (),
    "bracket_float4_stores": ((0, BRACKET_LINES, BRACKET_STORES),),
    "morph_staged_tile": ((1, MORPH_SHUFFLE, MORPH_TILE),),
    "morph_8_blocks_an_sm": ((1, *MORPH_BOUND),),
}


def variant_sources(texts, changes):
    """(render_stages.cu, preprocess.cu) texts with a variant's changes,
    each kept text found once."""
    texts = list(texts)
    for k, kept, other in changes:
        if texts[k].count(kept) != 1:
            raise ValueError(f"a variant's text not found once in "
                             f"{SOURCES[k].name}")
        texts[k] = texts[k].replace(kept, other)
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
    """({frame: the recorded bracket call's arguments} of one fast and one
    parity frame of the reference setup, the fast fuse's morph input)."""
    from ..ops import preprocess as pre
    from ..ops import stage_calls
    from ..recon.tsdf_pipeline import TsdfPipeline
    from .headline import load_cell, reference_setup

    pipe, frames, camera = reference_setup(device)
    morph_in = []
    dispatch = pre.morph_dilate

    def record(depth):
        morph_in.append(depth.clone())
        return dispatch(depth)

    pre.morph_dilate = record
    try:
        pipe.fuse(frames)
    finally:
        pre.morph_dilate = dispatch
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
        (bracket,) = [c for c in calls if c[0] == "bracket"]
        out[name] = bracket[1]
    return out, morph_in[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="a checkout (e.g. the parent commit unpacked) whose "
                         "two sources run as one more variant, 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bracket_morph_variants: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import stage_calls
    from ..ops.preprocess import morph_dilate_plain
    from .kernel_inputs import morph_exits
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

    brackets, depth = record_calls(device)
    exits = morph_exits(torch, depth)
    print(f"morph exits on the fast fuse's {tuple(depth.shape)} depth: "
          f"{exits}", flush=True)
    want_morph = morph_dilate_plain(depth)
    rows = []
    saved = kstages.library, kpre.library
    try:
        for name in [*names, *reversed(names)]:
            lib, report = built[name]
            cdll = _load(lib)
            kstages.library = kpre.library = lambda cdll=cdll: cdll
            kstages._size_checked.clear()
            calls = {}
            for frame, call in brackets.items():
                a = stage_calls.copy(call)
                got = kstages.bracket_cuda(*a)
                want = stage_calls.stage_fn("bracket", True)(
                    *stage_calls.copy(call))
                torch.cuda.synchronize()
                if not stage_calls.all_bits_equal(got, want):
                    raise AssertionError(f"{name} {frame}: the bracket "
                                         "differs from bracket_plain")
                calls[frame] = lambda a=a: kstages.bracket_cuda(*a)
            times = _device_ms(calls, flush, args.iters, "bracket_kernel")
            if not stage_calls.bits_equal(kpre.morph_cuda(depth), want_morph):
                raise AssertionError(f"{name}: the morph differs from "
                                     "morph_dilate_plain")
            times.update(_device_ms({"fast_fuse": lambda: kpre.morph_cuda(
                depth)}, flush, args.iters, "morph_kernel"))
            regs = {"bracket": _registers(report, "bracket_kernel",
                                          ("kernel", "kernel")),
                    "morph": _registers(report, "morph_kernel",
                                        ("scalar", "vector"))}
            for frame, (cold, warm) in times.items():
                kernel = "morph" if frame == "fast_fuse" else "bracket"
                call = brackets.get(frame)
                launch = None   # a parent's library may have no plans
                if hasattr(cdll, "rgbd_pre_morph_plan"):
                    launch = (kpre.morph_plan(depth) if kernel == "morph"
                              else kstages.bracket_plan(call[0],
                                                        call[5].shape[0]))
                row = dict(variant=name, kernel=kernel, frame=frame,
                           bit_equal=True, device_ms=cold,
                           device_ms_warm=warm, launch=launch,
                           registers_spills=regs[kernel])
                rows.append(row)
                print(f"{kernel} {name} {frame}: bit-equal to its twin; "
                      f"device {cold!r} ms cold L2, {warm!r} warm; launch "
                      f"{launch}; registers, spill bytes {regs[kernel]}, on "
                      f"{card}", flush=True)
    finally:
        kstages.library, kpre.library = saved
        kstages._size_checked.clear()
    print(json.dumps({"card": card, "morph_exits": exits,
                      "bracket_morph_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
