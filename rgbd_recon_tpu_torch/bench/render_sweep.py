"""The render-lever sweep on the card: what each march lever costs and
changes at reference scale (the port of scripts/bench_render_sweep.py).

    python -m rgbd_recon_tpu_torch.bench.render_sweep [--iters N]

The scene is the script's two spheres (bench_render_sweep.py:36) seen by
the rig of :31-32, the 4 sensors of ``headline.reference_setup`` at
512x424 depth / 1280x1080 colour, through that setup's calibration,
200x220x200 voxels and 1280x720 camera. The frames are fused once
(:40-41). One pipeline and one renderer handle go through the six
variants (:46-53): ``TsdfPipeline.reconfigure(**kw)`` into each, back to
the fast defaults after it; the handle rebuilds on the pipeline's new
generation, in place of the script's copy of the pipeline's ``__dict__``.

A row a variant: the render, the mean of ``iters`` calls after one untimed
warm-up call on the host clock read after ``torch.cuda.synchronize()``
(:62-69), with the CUDA-event mean of ``iters`` more calls beside it on the
card; the hit pixels and the overflow counters (:70-71) and
``pipe.diagnostics(counts, out)``.

Prints the card's name and power limit, then one JSON line with every row.
Exits non-zero before any work when the process has no card (a caller of
:func:`run` may pass ``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import kernels
from ..device import DEFAULT, resolve
from ..sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)
from .ablation import device_info, launches_since, log, reconfigured, timed_ms
from .headline import REFERENCE, reference_setup

ITERS = 5
# bench_render_sweep.py:36 (and bench_preprocess.py / bench_render.py's)
TWO_SPHERES = [((0.0, 1.1, 0.0), 0.55), ((0.4, 0.6, 0.3), 0.25)]
# bench_render_sweep.py:46-53, verbatim
VARIANTS = [
    ("baseline", {}),
    ("ray_compaction 0.25", {"ray_compaction": 0.25}),
    ("phase1 16", {"march_phase1_steps": 16}),
    ("step_frac 0.125", {"interval_step_frac": 0.125}),
    ("colorfill off", {"colorfill": False}),
    ("hit_compaction 0.35", {"hit_compaction": 0.35}),
]


def two_sphere_frames(device, scene=REFERENCE, bbox=None):
    """The frames of the two-sphere scene, from the rig that
    ``reference_setup(device, scene)`` calibrates (bbox: that setup's
    pipeline's)."""
    rig = default_test_rig(num_sensors=4, depth_size=scene.depth_size,
                           color_size=scene.color_size, bbox=bbox)
    return render_rig_frames(SyntheticScene(spheres=TWO_SPHERES), rig,
                             device=device)


def run(*, iters: int = ITERS, device=DEFAULT, setup=None) -> dict:
    """The sweep on ``device`` (the card unless the caller names another;
    raises without one). ``setup`` is (pipeline, two-sphere frames,
    camera), built here from ``reference_setup`` and
    :func:`two_sphere_frames` when not given; the pipeline comes back at
    its config. Returns the rows, the kernels launched and the device."""
    device = resolve(device)
    on_card = device.type == "cuda"
    if setup is None:
        pipe, _, camera = reference_setup(device)
        setup = pipe, two_sphere_frames(device, bbox=pipe.bbox), camera
    pipe, frames, camera = setup
    volume, maps, counts = pipe.fuse(frames)
    renderer = pipe.make_renderer(camera)
    before = kernels.launch_counts()
    rows = []
    for name, changes in VARIANTS:
        with reconfigured(pipe, **changes):
            out, ms, ev = timed_ms(lambda: renderer(volume, maps, counts),
                                   iters, on_card)
            diagnostics = pipe.diagnostics(counts, out)
        hits = int(out.hit.sum())
        rows.append(dict(variant=name, changes=changes, render_ms=ms,
                         render_event_ms=ev, hits=hits,
                         overflow=out.overflow.tolist(),
                         diagnostics=diagnostics))
        log(f"{name:28s} {ms:8.2f} ms  hits {hits:6d}  overflow "
            f"{out.overflow.tolist()}  {diagnostics}")
    return {"rows": rows, "iters": iters, "launches": launches_since(before),
            "device": device_info(device)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="timed renders a variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_sweep: torch.cuda.is_available() is false; "
                         "it runs only on the card")
    result = run(iters=args.iters)
    print(result["device"]["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
