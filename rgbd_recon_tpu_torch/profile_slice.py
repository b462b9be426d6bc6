"""Stage profile of the port's main path on one CUDA device.

    python -m rgbd_recon_tpu_torch.profile_slice

Sets up the reference-scale scene of :func:`reference_setup` (also the one
chip_smoke.py drives), then:

1. times each stage with CUDA events, mean over ITERS calls after 2
   warm-up calls: preprocess (with brick marking), integrate, fuse, the
   render's bake, render_from_baked, and the whole render;
2. times fuse + render per frame on the host clock (synchronized), the
   frame's wall time;
3. runs torch.profiler (CPU + CUDA) over FRAMES frames of fuse + render
   and reports the device time, the device activity count and the busy
   share = device time per frame / wall time per frame of step 2, with
   the TOP device kernels by time.

Prints each figure, the card's name and power limit, and one JSON line
with all of them last.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .core import BoundingBox, PipelineConfig
from .calib.sensors import build_synthetic_calibration
from .ops.raymarch import ViewCamera
from .recon.tsdf_pipeline import TsdfPipeline
from .sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

ITERS = 10     # timed calls per stage and wall-time frames
FRAMES = 3     # profiled frames
TOP = 15       # device kernels listed

SPHERE_C = (0.0, 1.1, 0.0)
SPHERE_R = 0.55


def reference_setup(device):
    """bench.py's scene at reference scale on ``device``: 4 synthetic
    sensors at 512x424 depth / 1280x1080 color around a 2 x 2.2 x 2 m box,
    1 cm voxels (200x220x200) in 10 cm bricks, one sphere, the default fast
    config, a 1280x720 camera. Returns (pipeline, frames, camera)."""
    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=4, depth_size=(512, 424),
                           color_size=(1280, 1080), bbox=bbox)
    calib = build_synthetic_calibration(
        rig, bbox, cv_res=(128, 256, 128), inv_res=(200, 220, 200),
        device=device)
    frames = render_rig_frames(SyntheticScene(spheres=[(SPHERE_C, SPHERE_R)]),
                               rig, device=device)
    pipe = TsdfPipeline(calib, PipelineConfig(
        voxel_size=0.01, brick_size=0.1, tsdf_limit=0.01, num_lods=7), bbox)
    camera = ViewCamera(width=1280, height=720, eye=(0.0, 1.3, 2.6),
                        target=(0.0, 1.1, 0.0))
    return pipe, frames, camera


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    # the attribute was renamed from self_cuda_time_total in torch 2.4
    t = getattr(evt, "self_device_time_total", None)
    return float(evt.self_cuda_time_total if t is None else t)


def _on_device(evt) -> bool:
    """A device activity (kernel, copy, memset), not a host op or a user
    annotation: the events whose times torch's own table sums."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false")
    card = card_line()
    pipe, frames, camera = reference_setup(torch.device("cuda"))
    render, cam = pipe.make_render_fn(camera)
    proj, limit = pipe._get_projection_models(), pipe._limit

    volume, maps, counts = pipe.fuse(frames)       # fits the models
    baked = render.bake(volume, counts)
    stages = {
        "preprocess+mark": lambda: pipe.preprocess(frames),
        "integrate": lambda: pipe.integrate(maps, counts),
        "fuse": lambda: pipe.fuse(frames),
        "bake": lambda: render.bake(volume, counts),
        "render_from_baked": lambda: render.render_from_baked(
            baked, maps, cam, proj, limit),
        "render": lambda: render(volume, maps, counts, cam, proj, limit),
    }
    stage_ms = {}
    for name, fn in stages.items():
        stage_ms[name] = event_ms(fn, ITERS)
        print(f"{name}: {stage_ms[name]!r} ms (CUDA events, mean of "
              f"{ITERS})", flush=True)

    def frame():
        v, m, c = pipe.fuse(frames)
        return render(v, m, c, cam, proj, limit)

    frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        frame()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    print(f"fuse + render wall: {wall_ms!r} ms per frame (host clock, mean "
          f"of {ITERS})", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(FRAMES):
            frame()
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if _on_device(e)]
    device_ms = sum(_device_us(e) for e in device_events) / 1e3
    n_device = len(device_events)
    per_frame = device_ms / FRAMES
    busy = per_frame / wall_ms
    print(f"profiler over {FRAMES} frames: device time {device_ms!r} ms "
          f"({per_frame!r} ms a frame), {n_device} device activities; busy "
          f"share {busy!r} of the {wall_ms!r} ms wall time", flush=True)
    top = sorted((e for e in prof.key_averages() if _on_device(e)),
                 key=_device_us, reverse=True)[:TOP]
    top_rows = [dict(name=e.key[:80], calls=int(e.count),
                     device_ms=_device_us(e) / 1e3) for e in top]
    for r in top_rows:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:7d}x  {r['name']}")

    print(card)
    print(json.dumps(dict(
        card=card, stage_ms=stage_ms, wall_ms_per_frame=wall_ms,
        profiled_frames=FRAMES, device_ms=device_ms,
        device_ms_per_frame=per_frame, device_activities=n_device,
        busy_share=busy, top=top_rows)))


if __name__ == "__main__":
    main()
