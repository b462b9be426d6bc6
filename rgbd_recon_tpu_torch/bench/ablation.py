"""The fast-mode ablation on the card: each fast knob of the default
``PipelineConfig`` set to its reference-exact value on its own, then all of
them, on bench.py's scene (the port of scripts/ablate_fast_modes.py, whose
table in ABLATION.md was measured on a TPU).

    python -m rgbd_recon_tpu_torch.bench.ablation [--iters N] [--out PATH]

The scene, calibration, frames and camera are ``headline.reference_setup``'s
(ablate_fast_modes.py:41-63): one 0.55 m sphere at (0, 1.1, 0), 4 sensors
at 512x424 depth / 1280x1080 colour, 200x220x200 voxels, a 1280x720
camera. The calibration and the frames are baked once. One pipeline and one
renderer handle go through the variants: ``TsdfPipeline.reconfigure(**kw)``
into each, back to the fast defaults after it; the handle rebuilds on the
pipeline's new generation.

A row a variant: the surface RMSE and the hit pixels of the analytic-sphere
oracle (``bench/oracle.py``), the fused step (``fuse``) and the render, each
the mean of ``iters`` calls after one untimed warm-up call, on the host
clock read after ``torch.cuda.synchronize()``; on the card the CUDA-event
mean of ``iters`` more calls beside each (``trace.event_ms``).

Writes the table in ABLATION.md's form to ``--out`` (by default
``build/ablation_torch.md``), prints the card's name and power limit, then
one JSON line with every row. Exits non-zero before any work when the
process has no card (a caller of :func:`run` may pass ``device="cpu"``, as
the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from .. import kernels
from ..device import DEFAULT, resolve
from .headline import BUILD, reference_setup
from .oracle import surface_rmse_mm
from .trace import card_line, event_ms

ITERS = 10
OUT = BUILD / "ablation_torch.md"
# scripts/ablate_fast_modes.py:77-90, verbatim: each fast knob at its
# reference-exact setting alone, then all of them (bench.py's parity_cfg,
# the parity cell's pipeline)
VARIANTS = [
    ("fast defaults", {}),
    ("march trilinear+nolskip",
     dict(march_mode="trilinear", march_empty_skip=False)),
    ("integrate_taps bilinear", dict(integrate_taps="bilinear")),
    ("mark_stride 1", dict(mark_stride=1)),
    ("march_dtype f32", dict(march_dtype="float32")),
    ("projection_model off", dict(projection_model=False)),
    ("oct_hit_table off", dict(oct_hit_table=False)),
    ("reference-exact (all)",
     dict(march_mode="trilinear", march_empty_skip=False,
          integrate_taps="bilinear", mark_stride=1,
          projection_model=False, march_dtype="float32")),
]
# ablate_fast_modes.py:125-126
TABLE_HEADER = [
    "| variant | surface RMSE (mm) | fused step (ms) | render (ms) |",
    "|---|---|---|---|",
]


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@contextlib.contextmanager
def reconfigured(pipe, **changes):
    """``pipe`` reconfigured with ``changes`` inside the block; the fields
    it changed are set back to their former values after it."""
    before = {k: getattr(pipe.config, k) for k in changes}
    pipe.reconfigure(**changes)
    try:
        yield pipe
    finally:
        pipe.reconfigure(**before)


def timed_ms(fn, iters: int, on_card: bool):
    """(the warm-up call's result, host ms, CUDA-event ms or None): one
    untimed warm-up call of ``fn``, then the mean of ``iters`` calls on the
    host clock, read after ``torch.cuda.synchronize()`` on the card; there
    the CUDA-event mean of ``iters`` more calls too."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    result = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    return result, host_ms, event_ms(fn, iters, warmup=0) if on_card else None


def device_info(device: torch.device) -> dict:
    """The card a run measured (its name, the device count, and its name
    and power limit as nvidia-smi reports them), or the device type off
    the card."""
    if device.type != "cuda":
        return {"platform": device.type}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "card": card_line()}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``kernels.launch_counts()`` read
    ``before``, with their launches."""
    return {k: n - before[k] for k, n in kernels.launch_counts().items()
            if n != before[k]}


def markdown(rows, pipe, frames, camera, device: str) -> str:
    """The rows in ABLATION.md's form (ablate_fast_modes.py:117-135)."""
    n, h, w = frames.depths.shape[:3]
    lines = [
        "# Fast-mode accuracy/performance ablation",
        "",
        f"{n} sensors at {w}x{h}, {pipe.config.voxel_size * 100:g} cm voxels "
        f"{tuple(pipe.volume_grid.shape)}, a {camera.width}x{camera.height} "
        "render;",
        "analytic-sphere surface RMSE (bench/oracle.py). Each row toggles ONE",
        "fast knob to its reference-exact setting from the fast defaults; the",
        "last row is the full reference-exact parity mode.",
        "",
        *TABLE_HEADER,
    ]
    lines += [f"| {r['variant']} | {r['surface_rmse_mm']:.2f} | "
              f"{r['fuse_ms']:.1f} | {r['render_ms']:.1f} |" for r in rows]
    lines += ["", f"Device: {device}."]
    return "\n".join(lines) + "\n"


def run(*, iters: int = ITERS, device=DEFAULT, setup=None,
        out=None) -> dict:
    """The ablation on ``device`` (the card unless the caller names
    another; raises without one). ``setup`` is ``reference_setup``'s
    (pipeline, frames, camera), built here when not given; the pipeline
    comes back at its config. Returns the rows, the kernels launched and
    the device; writes the Markdown table to ``out`` when given."""
    device = resolve(device)
    on_card = device.type == "cuda"
    pipe, frames, camera = setup or reference_setup(device)
    renderer = pipe.make_renderer(camera)
    before = kernels.launch_counts()
    rows = []
    for name, changes in VARIANTS:
        with reconfigured(pipe, **changes):
            (volume, maps, counts), fuse_ms, fuse_ev = timed_ms(
                lambda: pipe.fuse(frames), iters, on_card)
            res, render_ms, render_ev = timed_ms(
                lambda: renderer(volume, maps, counts), iters, on_card)
        rmse, hits = surface_rmse_mm(res, camera)
        rows.append(dict(
            variant=name, changes=changes, surface_rmse_mm=rmse,
            surface_hits=hits, overflow=res.overflow.tolist(),
            fuse_ms=fuse_ms, fuse_event_ms=fuse_ev, render_ms=render_ms,
            render_event_ms=render_ev))
        log(f"{name:28s} rmse {rmse!r} mm over {hits} hits  fuse "
            f"{fuse_ms:7.2f} ms  render {render_ms:7.2f} ms")
    info = device_info(device)
    if out is not None:
        Path(out).write_text(markdown(rows, pipe, frames, camera,
                                      info.get("card", device.type)))
        log(f"wrote {out}")
    return {"rows": rows, "iters": iters, "launches": launches_since(before),
            "table": None if out is None else str(out), "device": info}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="timed calls a fuse and a render row")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="where the Markdown table is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablation: torch.cuda.is_available() is false; it "
                         "runs only on the card")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    result = run(iters=args.iters, out=args.out)
    print(result["device"]["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
