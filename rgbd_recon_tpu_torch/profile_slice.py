"""Stage profile of the port's main path on one CUDA device.

    python -m rgbd_recon_tpu_torch.profile_slice [--cell fast|parity]

Sets up bench.py's reference-scale scene (``bench/headline.py
reference_setup``, also the one chip_smoke.py drives) with the pipeline of
the cell's file (``bench/cells``; the fast cell by default), then:

1. times each stage with CUDA events, mean over ITERS calls after 2
   warm-up calls: preprocess (with brick marking), integrate, fuse, the
   render's bake, render_from_baked, and the whole render;
2. times fuse + render per frame on the host clock (synchronized), the
   frame's wall time;
3. runs the traced window of ``bench/trace.py`` over FRAMES frames of
   fuse + render: the device time, the device activity count, the busy
   share = device time per frame / wall time per frame of step 2, the
   top device kernels by time and the longest idle gaps;
4. counts the host syncs of one render_from_baked (after the bake, the
   fill included) under ``torch.cuda.set_sync_debug_mode("warn")``: the
   warnings PyTorch raises for its synchronizing operations (nonzero,
   item, blocking copies), and the same traced window over FRAMES calls
   of render_from_baked alone (its device activities a call);
5. the same for the render's bake (``render.bake``): its host syncs, its
   traced window over FRAMES bakes (device activities and device ms a
   bake, its top device kernels) and its wall time a call on the host
   clock; and the host syncs of one whole frame (fuse + render).

Prints each figure, the card's name and power limit, and one JSON line
with all of them last. Copied into another checkout's
``rgbd_recon_tpu_torch/`` and run there with ``-m``, it measures that
checkout: two trees compared in one call.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import torch

from .bench.headline import load_cell, reference_setup
from .bench.trace import card_line, event_ms, profile_frames

ITERS = 10     # timed calls per stage and wall-time frames
FRAMES = 3     # profiled frames
CELLS = {"fast": "tsdf_fast_4kinect2_1cm",
         "parity": "tsdf_parity_4kinect2_1cm"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="fast")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false")
    card = card_line()
    pipe, frames, camera = reference_setup(
        torch.device("cuda"), **load_cell(CELLS[args.cell])["pipeline"])
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

    wall_ms = host_wall_ms(frame)
    print(f"fuse + render wall: {wall_ms!r} ms per frame (host clock, mean "
          f"of {ITERS})", flush=True)

    trace = profile_frames(frame, FRAMES, wall_ms)
    if trace is None:
        raise SystemExit(f"torch.profiler recorded no device activity over "
                         f"{FRAMES} frames: the busy share is not measured")
    print(f"profiler over {FRAMES} frames: device time "
          f"{trace['device_ms']!r} ms ({trace['device_ms_per_frame']!r} ms a "
          f"frame), {trace['device_activities']} device activities; busy "
          f"share {trace['busy_share']!r} of the {wall_ms!r} ms wall time",
          flush=True)
    for r in trace["top"]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:7d}x  {r['name']}")
    for g in trace["idle_gaps"]:
        print(f"  idle {g['ms']:10.3f} ms at {g['at_ms']:10.3f} ms")

    syncs = render_syncs(lambda: render.render_from_baked(
        baked, maps, cam, proj, limit))
    print(f"render_from_baked: {syncs} host syncs a call "
          "(set_sync_debug_mode warnings)", flush=True)
    rfb = profile_frames(lambda: render.render_from_baked(
        baked, maps, cam, proj, limit), FRAMES, stage_ms["render_from_baked"])
    rfb_acts = None if rfb is None else rfb["device_activities"] // FRAMES
    print(f"render_from_baked: {rfb_acts} device activities a call",
          flush=True)

    def bake():
        return render.bake(volume, counts)

    bake_wall = host_wall_ms(bake)
    bake_trace = profile_frames(bake, FRAMES, bake_wall)
    bake_fig = dict(syncs=render_syncs(bake), wall_ms=bake_wall,
                    activities=None, device_ms=None, top=None)
    if bake_trace is not None:
        bake_fig.update(activities=bake_trace["activities_per_frame"],
                        device_ms=bake_trace["device_ms_per_frame"],
                        top=bake_trace["top"])
    frame_syncs = render_syncs(frame)
    print(f"bake: {bake_fig['syncs']} host syncs a call, {bake_wall!r} ms "
          f"a call (host clock, mean of {ITERS}), "
          f"{bake_fig['activities']} device activities and "
          f"{bake_fig['device_ms']!r} device ms a call; fuse + render: "
          f"{frame_syncs} host syncs a frame", flush=True)
    for r in bake_fig["top"] or ():
        print(f"  {r['device_ms'] / FRAMES:10.5f} ms  "
              f"{r['calls'] / FRAMES:5.1f}x  {r['name']}")

    print(card)
    print(json.dumps(dict(card=card, cell=args.cell, stage_ms=stage_ms,
                          wall_ms_per_frame=wall_ms,
                          render_from_baked_syncs=syncs,
                          render_from_baked_activities=rfb_acts,
                          bake=bake_fig, frame_syncs=frame_syncs, **trace)))


def host_wall_ms(fn, iters: int = ITERS) -> float:
    """The mean host-clock ms of ``iters`` calls of ``fn`` run back to back
    and ended by ``torch.cuda.synchronize()``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def render_syncs(fn) -> int:
    """The host syncs of one call of ``fn``: the warnings PyTorch's sync
    debug mode raises for its synchronizing operations."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) and "prototype" not in str(
        w.message) for w in caught)


if __name__ == "__main__":
    main()
