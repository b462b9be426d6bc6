"""The interval scan's launch constants measured on the card.

``python -m rgbd_recon_tpu_torch.bench.scan_variants [--iters 20]`` builds
csrc/render_stages.cu once for each variant of its scan (the lanes a ray,
SCAN_LANES; the blocks an SM, SCAN_BLOCKS_PER_SM; and the sample's brick
index by the integer floor division in place of the magic product), each
into its own library under ``build/scan_variants/``, records the scan call
of one fast and one parity frame of the cells' reference setup
(``bench/headline.py reference_setup``), and runs each variant's kernel on
those inputs through ``kernels/render_stages.py scan_cuda``: bit-equal to
``scan_plain`` or the script fails; its own device time under
torch.profiler with a cold L2 (a 256 MiB write and read before each call)
and warm (back to back), the launch plan, and ptxas' registers and spills.
Prints the card line, a line a variant and frame, and one JSON line.
Exits 1 without a card, before any work.
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

import torch

from ..kernels import _build
from ..kernels import render_stages as kstages

SOURCE = _build._PKG / "csrc" / "render_stages.cu"
OUT = _build.BUILD_DIR.parent / "scan_variants"

# the sample's brick index: the kernel's magic product, and the integer
# floor division it replaced (the same bits)
MAGIC_INDEX = """\
          const unsigned long long v = (unsigned long long)max((int)c, 0);
          bi[a] = min((int)((v * magic) >> shift), nb_dim[a] - 1);"""
FLOOR_INDEX = """\
          const int vi = (int)c, q = vi / p.brick_vox;
          const int fd = (vi % p.brick_vox != 0 && vi < 0) ? q - 1 : q;
          bi[a] = clampi(fd, 0, nb_dim[a] - 1);"""

# name -> (SCAN_LANES, SCAN_BLOCKS_PER_SM, floor division)
VARIANTS = {
    "L4_B2": (4, 2, False),
    "L8_B1": (8, 1, False),
    "L8_B2": (8, 2, False),
    "L8_B4": (8, 4, False),
    "L16_B2": (16, 2, False),
    "L8_B2_floor_division": (8, 2, True),
}


def variant_source(text: str, lanes: int, blocks_per_sm: int,
                   floor_division: bool) -> str:
    """csrc/render_stages.cu's text with the scan's constants set (and the
    brick index by floor division)."""
    for name, value in (("SCAN_LANES", lanes),
                        ("SCAN_BLOCKS_PER_SM", blocks_per_sm)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} not found once in {SOURCE.name}")
    if floor_division:
        if MAGIC_INDEX not in text:
            raise ValueError(f"the brick index not found in {SOURCE.name}")
        text = text.replace(MAGIC_INDEX, FLOOR_INDEX)
    return text


def _build_variant(name: str):
    """(library path, ptxas report) of a variant."""
    src = OUT / f"{name}.cu"
    src.write_text(variant_source(SOURCE.read_text(), *VARIANTS[name]))
    lib = OUT / f"{name}.so"
    res = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS,
                          "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return lib, res.stderr


def _load(lib):
    cdll = ctypes.CDLL(str(lib))
    for entry in ("rgbd_render_scan", "rgbd_render_scan_plan",
                  "rgbd_render_params_size"):
        fn = getattr(cdll, entry)
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return cdll


def _registers(report: str, kernel: str = "scan_kernel",
               instances=("global", "staged")) -> dict:
    """{kernel instance: (registers, spill bytes)} of ``kernel`` in a ptxas
    -v report, a template instance named by ``instances`` (its bool
    parameter false, true)."""
    out, name, spills = {}, None, 0
    entry = re.compile(rf"Compiling entry function '(\S*{kernel}\S*)'")
    for line in report.splitlines():
        m = entry.search(line)
        if m:
            name, spills = (instances[1] if "ILb1E" in m.group(1)
                            else instances[0]), 0
        elif name and "spill stores" in line:
            spills = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line)[1]),
                         spills)
            name = None
    return out


def _device_ms(calls: dict, flush, iters: int,
               kernel: str = "scan_kernel") -> dict:
    """{frame: (cold, warm)} device ms a call of ``kernel``, from one
    torch.profiler trace of every frame's ``iters`` calls after ``flush``
    and then ``iters`` back to back, in that order (the trace taken again,
    at most TRACE_TRIES times, when it lacks a launch: the profiler can
    hand back a trace with no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    from .trace import TRACE_TRIES, device_us, on_device

    want = 2 * iters * len(calls)
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                for cold in (True, False):
                    for _ in range(iters):
                        if cold:
                            flush()
                        fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if on_device(e) and kernel in e.name),
                        key=lambda e: e.time_range.start)
        if len(events) == want:
            break
    else:
        raise RuntimeError(f"the profiler recorded {len(events)} {kernel} "
                           f"launches of {want} in {TRACE_TRIES} traces")
    ms = [device_us(e) / 1e3 for e in events]
    out = {}
    for k, frame in enumerate(calls):
        run = ms[2 * k * iters: 2 * (k + 1) * iters]
        out[frame] = (sum(run[:iters]) / iters, sum(run[iters:]) / iters)
    return out


def _scan_calls(device):
    """{frame: the recorded scan call's arguments} of one fast and one
    parity frame of the reference setup."""
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
        (scan,) = [c for c in calls if c[0] == "scan"]
        out[name] = scan[1]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import stage_calls
    from .trace import card_line

    card = card_line()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    device = torch.device("cuda")
    flush_w = torch.empty(64 * 2 ** 20, device=device)
    flush_r = torch.ones(64 * 2 ** 20, device=device)

    def flush():
        flush_w.fill_(1.0)
        flush_r.sum()

    calls = _scan_calls(device)
    rows = []
    library = kstages.library
    try:
        # each variant twice, in turns (forward, then backward)
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            lib, report = built[name]
            cdll = _load(lib)
            kstages.library = lambda cdll=cdll: cdll
            kstages._size_checked.clear()
            inputs = {}
            for frame, call in calls.items():
                a = stage_calls.copy(call)
                got = kstages.scan_cuda(*a)
                want = stage_calls.stage_fn("scan", True)(
                    *stage_calls.copy(call))
                torch.cuda.synchronize()
                if not stage_calls.all_bits_equal(got, want):
                    raise AssertionError(f"{name} {frame}: the scan differs "
                                         "from scan_plain")
                inputs[frame] = lambda a=a: kstages.scan_cuda(*a)
            times = _device_ms(inputs, flush, args.iters)
            for frame, call in calls.items():
                cold, warm = times[frame]
                row = dict(variant=name, frame=frame, bit_equal=True,
                           device_ms=cold, device_ms_warm=warm,
                           launch=kstages.scan_plan(call[0], call[1].shape,
                                                    device),
                           registers_spills=_registers(report))
                rows.append(row)
                print(f"scan {name} {frame}: bit-equal to scan_plain; device "
                      f"{cold!r} ms cold L2, {warm!r} warm; launch "
                      f"{row['launch']}; registers, spill bytes "
                      f"{row['registers_spills']}, on {card}", flush=True)
    finally:
        kstages.library = library
        kstages._size_checked.clear()
    print(json.dumps({"card": card, "scan_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
