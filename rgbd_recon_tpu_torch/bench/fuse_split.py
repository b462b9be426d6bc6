"""The fuse kernels' device time split by the work they do, on the card.

``python -m rgbd_recon_tpu_torch.bench.fuse_split [--iters 20]`` records
the marking (``ops/bricks.py mark_pixels``) and the brick-compact
integrate (``ops/tsdf.py integrate_compact``) calls of one fast and one
parity fuse of the cells' reference setup (``bench/headline.py
reference_setup``) and runs csrc/fuse.cu's kernels on them:

- ``brick_mark``: the recorded marking;
- ``brick_integrate`` on the fuse's own list of occupied bricks (the
  path's call), on an empty list (every voxel cleared: the clear blocks'
  part alone), and on a list of every brick (8,800 listed bricks: the
  brick blocks' rate when they hold nearly all the work);
- ``brick_integrate`` with the other taps (nearest on the parity fuse's
  maps and list, bilinear on the fast fuse's).

Each is the kernel's own device time under torch.profiler with a cold L2
(a 256 MiB write and read before each call) and warm (back to back), its
launch, and the registers the loaded library reports; the integrate's
output on the fuse's list is bit-equal to ``integrate_compact_plain`` or
the script fails. Prints the card line, a line a case and one JSON line.
Exits 1 without a card, before any work.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fuse_split: no CUDA device", file=sys.stderr)
        return 1
    from ..kernels import fuse as kfuse
    from ..ops import tsdf
    from ..ops.compact import compact
    from .scan_variants import _device_ms
    from .trace import card_line

    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    flush_w = torch.empty(64 * 2 ** 20, device=device)
    flush_r = torch.ones(64 * 2 ** 20, device=device)

    def flush():
        flush_w.fill_(1.0)
        flush_r.sum()

    recorded = record_calls(device)
    attrs = kfuse.kernel_attrs()
    rows = []
    for path, calls in recorded.items():
        margs, mkw = calls["mark"]
        iargs, ikw = calls["integrate"]
        proj, counts, min_voxels, capacity = iargs[:4]
        B = proj.shape[1]
        flags = (counts > min_voxels).reshape(-1).view(torch.uint8)
        n = torch.empty(1, dtype=torch.int32, device=device)
        ids, slot = compact(flags, 0, capacity, n, 0, want_slot=True)
        got = kfuse.brick_integrate_cuda(proj, ids, slot, *iargs[4:], **ikw)
        want = tsdf.integrate_compact_plain(*iargs, **ikw)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{path}: brick_integrate differs from "
                                 "integrate_compact_plain")
        other = ("bilinear" if ikw.get("taps", "nearest") == "nearest"
                 else "nearest")
        own = int((slot >= 0).sum())
        every = (torch.arange(B, dtype=torch.int64, device=device),
                 torch.arange(B, dtype=torch.int32, device=device))
        # case -> (list, slot map, keyword arguments, listed bricks)
        lists = {
            "own list": (ids, slot, ikw, own),
            "empty list": (torch.full_like(ids, B), torch.full_like(slot, -1),
                           ikw, 0),
            "every brick": (*every, ikw, B),
            f"own list, {other} taps": (ids, slot, dict(ikw, taps=other),
                                        own),
        }
        launch = kfuse.mark_plan(*margs, **mkw)
        cases = {"brick_mark": (
            lambda: kfuse.brick_mark_cuda(*margs, **mkw), "mark_kernel",
            launch, attrs["mark_kernel<true>" if launch["shared_histogram"]
                          else "mark_kernel<false>"], None)}
        for name, (i, s, kw, listed) in lists.items():
            cases[f"brick_integrate, {name}"] = (
                lambda i=i, s=s, kw=kw: kfuse.brick_integrate_cuda(
                    proj, i, s, *iargs[4:], **kw), "integrate_kernel",
                kfuse.integrate_plan(iargs[8], iargs[9], i.shape[0]),
                attrs["integrate_kernel"], listed)
        for name, (fn, kernel, launch, regs, listed) in cases.items():
            cold, warm = _device_ms({name: fn}, flush, args.iters,
                                    kernel)[name]
            rows.append(dict(path=path, case=name, device_ms=cold,
                             device_ms_warm=warm, launch=launch,
                             listed_bricks=listed, **regs))
            print(f"{path} {name}: device {cold!r} ms cold L2, {warm!r} warm;"
                  f" launch {launch}, listed bricks {listed}, {regs} on "
                  f"{card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
