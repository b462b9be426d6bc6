#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``rgbd_recon_tpu_torch/csrc``
(nvcc, sm_90a), holds each kernel against its plain PyTorch twin at the
shapes the main path gives it, then drives three paths at reference scale
through the entry points a user calls: 4 synthetic sensors at 512x424
depth / 1280x1080 color, a 2 x 2.2 x 2 m box at 1 cm voxels (200x220x200),
``TsdfPipeline.fuse`` then ``make_renderer(camera)`` at 1280x720:

- ``fast``: the default fast config (the main path);
- ``parity``: bench.py's reference-exact parity config (bilinear integrate
  taps, one trilinear march of the raw volume, calibration-volume blend);
- ``parity_dense``: the parity config without bricking or space skipping
  (dense integrate, full-screen render), scripts/make_golden.py's form.

For each path it checks which kernels launched (launch counts set to 0
just before the path's fuse + render and read just after), that the output
is finite, and the surface RMSE against the analytic sphere (the accuracy
oracle of bench.py). Timings (CUDA events) are printed for information.

Then, at the same scale:

- phase 7 renders the fast path's maps and volume through the four other
  reconstruction modes (points, trigrid, MVT, calib-vis) with launch
  counts, holds the splat modes to the analytic sphere (coverage inside
  its silhouette dilated by 3 px, median view-depth error), and checks
  that a second render repeats depth and coverage exactly (the colors are
  atomic float sums: their run-to-run spread is printed);
- phase 8 drives the application shell, ``rgbd_recon_tpu_torch.app``:
  ``record`` 2 frames, then ``run`` in each mode 0-4 and once in mode 1
  with anaglyph stereo and checkpoints, from calibration volumes written
  under ``build/``; it checks the PNGs, ``timings.csv``, the checkpoint's
  frame index and each run's kernel launch counts.

Output: the card's name and power limit (nvidia-smi), one JSON line with the
per-kernel results (launches on the fast path, and per path), and as the
last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

# accuracy oracle at reference scale (fast path): surface RMSE <= 7.0 mm
# with the hit-pixel count within 2% of 85,975 (bench.py's sphere); the
# parity paths hold the same RMSE limit with hits within 2% of the fast
# path's count in the same run
RMSE_LIMIT_MM = 7.0
HITS_REF = 85975
HITS_REL_TOL = 0.02
# BENCH_r05.json: the JAX reference-exact path's RMSE, measured on a TPU
TPU_EXACT_RMSE_MM = 5.55
# bench.py's reference-exact parity config (bench.py:227-236)
PARITY = dict(march_mode="trilinear", march_empty_skip=False,
              integrate_taps="bilinear", mark_stride=1,
              projection_model=False, march_dtype="float32")
PARITY_PATHS = {
    "parity": PARITY,
    "parity_dense": dict(PARITY, bricking=False, skip_space=False),
}
# kernels each parity path must and must not launch
PARITY_LAUNCHES = {
    "parity": (("bilateral13", "quality13", "surface_occ"),
               ("sentinel_bake",)),
    "parity_dense": (("bilateral13", "quality13"), ("sentinel_bake",)),
}
# kernels 1-2 against the plain fold: |kernel - plain| <= 1e-5 * max|plain|
# (the library is built without FMA contraction or fast math, and folds in
# the plain version's order, so the expected difference is 0)
STENCIL_REL_BOUND = 1e-5
# splat modes (phase 7) against the analytic sphere: at most 1% of the
# covered pixels outside its silhouette dilated by 3 px (2 px of maximum
# splat radius plus rounding), median |view depth - sphere depth| over the
# covered pixels <= 10 mm (a pixel is ~2.7 mm at the sphere's 2.05 m in
# this camera: the 2 px footprint adds ~5 mm, the calibration volumes a
# few mm). Splats have no hole fill, so coverage has no lower bound but 0.
SPLAT_DILATE_PX = 3
SPLAT_OUTSIDE_FRAC = 0.01
SPLAT_MEDIAN_MM = 10.0
# phase 8: frames per app run, and the kernel launches each run must make
# (a mode's per-frame counts: all four kernels in mode 1, twice the bake
# kernels with stereo, the two stencils elsewhere, bilateral13 a second
# time in the MVT render)
APP_FRAMES = 2
APP_RUNS = {
    "app_mode0": (["--mode", "0"], dict(bilateral13=1, quality13=1)),
    "app_mode1": (["--mode", "1"], dict(bilateral13=1, quality13=1,
                                        surface_occ=1, sentinel_bake=1)),
    "app_mode2": (["--mode", "2"], dict(bilateral13=1, quality13=1)),
    "app_mode3": (["--mode", "3"], dict(bilateral13=2, quality13=1)),
    "app_mode4": (["--mode", "4"], dict(bilateral13=1, quality13=1)),
    "app_mode1_anaglyph": (["--mode", "1", "--stereo", "anaglyph"],
                           dict(bilateral13=1, quality13=1, surface_occ=2,
                                sentinel_bake=2)),
}


def _max_abs_err(torch, got, want) -> float:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(float((g.to(torch.float32) - w.to(torch.float32)).abs().max())
               for g, w in zip(got, want))


def _surface_rmse_mm(np, out, cam, center, radius):
    """Hit-depth RMSE against the analytic sphere (center, radius), as
    bench.py computes it. Returns (rmse_mm, hit pixels used)."""
    hit = out.hit.cpu().numpy()
    depth_win = out.depth.cpu().numpy()
    n, f = cam.near, cam.far
    view_z = 1.0 / (1.0 / n - depth_win * (1.0 / n - 1.0 / f))
    dirs = cam.ray_directions_world()
    eye = np.asarray(cam.eye, np.float32)
    oc = eye - np.asarray(center, np.float32)
    b = np.sum(dirs * oc, axis=-1)
    a = np.sum(dirs * dirs, axis=-1)
    disc = b * b - a * (np.dot(oc, oc) - radius ** 2)
    ok = hit & (disc > 0.0)
    t_true = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    err = (view_z - t_true)[ok] * np.linalg.norm(dirs[ok], axis=-1)
    err = err[np.isfinite(err)]
    return float(np.sqrt(np.mean(err ** 2)) * 1000.0), int(ok.sum())


def _check_render(np, torch, label, volume, out, counts, cfg, camera,
                  hits_ref):
    """Finite volume, color and depth, a 1280x720 image, the surface RMSE
    within RMSE_LIMIT_MM and the hit count within HITS_REL_TOL of
    ``hits_ref``. Returns (rmse_mm, hit pixels)."""
    from rgbd_recon_tpu_torch import profile_slice

    for name in ("color", "depth"):
        t = getattr(out, name)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite RenderOutput.{name}")
    if not bool(torch.isfinite(volume).all()):
        raise AssertionError(f"{label}: non-finite values in the volume")
    if tuple(out.color.shape) != (720, 1280, 3):
        raise AssertionError(f"{label}: color shape "
                             f"{tuple(out.color.shape)}")
    n_occ = int((counts > cfg.min_voxels_per_brick).sum())
    print(f"{label}: occupied bricks {n_occ}, overflow "
          f"{out.overflow.tolist()}", flush=True)
    rmse, n_hit = _surface_rmse_mm(np, out, camera, profile_slice.SPHERE_C,
                                   profile_slice.SPHERE_R)
    print(f"{label}: surface RMSE {rmse!r} mm over {n_hit} hit pixels "
          f"(limit {RMSE_LIMIT_MM} mm, {hits_ref} +- {HITS_REL_TOL:.0%})",
          flush=True)
    if not rmse <= RMSE_LIMIT_MM:
        raise AssertionError(f"{label}: surface RMSE {rmse} mm > "
                             f"{RMSE_LIMIT_MM}")
    if abs(n_hit - hits_ref) > HITS_REL_TOL * hits_ref:
        raise AssertionError(f"{label}: hit pixels {n_hit} not within "
                             f"{HITS_REL_TOL:.0%} of {hits_ref}")
    return rmse, n_hit


def _sphere_truth(np, cam, center, radius):
    """Per pixel of ``cam``: (inside the analytic sphere's silhouette, the
    sphere's view depth there). The camera-space ray directions have z = -1,
    so the ray parameter is the view depth."""
    dirs = cam.ray_directions_world()
    oc = np.asarray(cam.eye, np.float32) - np.asarray(center, np.float32)
    b = np.sum(dirs * oc, axis=-1)
    a = np.sum(dirs * dirs, axis=-1)
    disc = b * b - a * (np.dot(oc, oc) - radius ** 2)
    return disc > 0.0, (-b - np.sqrt(np.maximum(disc, 0.0))) / a


def _dilate(np, mask, r):
    """Chebyshev dilation of an (H, W) bool mask by r pixels."""
    H, W = mask.shape
    p = np.pad(mask, r)
    out = np.zeros_like(mask)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out |= p[dy: dy + H, dx: dx + W]
    return out


def _check_mode(np, torch, label, out, cam, fast_hits, splat):
    """A mode renderer's (image, window depth, covered): finite, the
    camera's size, some pixels covered. For a splat mode also the coverage against the
    analytic sphere's dilated silhouette and the median view-depth error
    over the covered pixels. Returns a dict of the figures."""
    from rgbd_recon_tpu_torch import profile_slice

    img, depth, covered = out
    for name, t in (("image", img), ("depth", depth)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if tuple(img.shape) != (cam.height, cam.width, 3):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    cov = covered.cpu().numpy()
    n_cov = int(cov.sum())
    print(f"{label}: {n_cov} covered pixels (the fast path hit {fast_hits})",
          flush=True)
    if n_cov <= 0:
        raise AssertionError(f"{label}: no pixel covered")
    figures = {"covered": n_cov}
    if not splat:
        return figures
    sil, t_true = _sphere_truth(np, cam, profile_slice.SPHERE_C,
                                profile_slice.SPHERE_R)
    outside = int((cov & ~_dilate(np, sil, SPLAT_DILATE_PX)).sum())
    n, f = cam.near, cam.far
    view_z = 1.0 / (1.0 / n - depth.cpu().numpy().astype(np.float64)
                    * (1.0 / n - 1.0 / f))
    err_mm = np.abs(view_z - t_true)[cov & sil] * 1000.0
    median = float(np.median(err_mm)) if err_mm.size else float("nan")
    rmse = float(np.sqrt(np.mean(err_mm ** 2))) if err_mm.size else 0.0
    print(f"{label}: {outside} covered pixels outside the silhouette dilated "
          f"by {SPLAT_DILATE_PX} px (limit {SPLAT_OUTSIDE_FRAC:.0%} of "
          f"{n_cov}); view-depth error median {median!r} mm (limit "
          f"{SPLAT_MEDIAN_MM}), RMSE {rmse!r} mm over {err_mm.size} pixels",
          flush=True)
    if outside > SPLAT_OUTSIDE_FRAC * n_cov:
        raise AssertionError(f"{label}: {outside} of {n_cov} covered pixels "
                             "outside the dilated silhouette")
    if not median <= SPLAT_MEDIAN_MM:
        raise AssertionError(f"{label}: median view-depth error {median} mm")
    figures.update(outside=outside, median_mm=median, rmse_mm=rmse)
    return figures


def _phase7_modes(np, torch, pipe, frames, camera, card, fast_hits, by_path):
    """Points, trigrid, MVT and calib-vis renders of the fast path's maps
    and volume: launch counts (reset just before each render: only the MVT
    render launches a kernel, bilateral13), the mode checks, CUDA-event
    render times. Adds each render's launches to ``by_path``."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.profile_slice import event_ms
    from rgbd_recon_tpu_torch.recon import (
        CalibVisPipeline,
        MvtPipeline,
        PointsPipeline,
        TrigridPipeline,
    )

    calib, cfg = pipe.calib, pipe.config
    volume, maps, _ = pipe.fuse(frames)
    modes = {
        "points": (PointsPipeline(calib, cfg), maps, True, {}),
        "trigrid": (TrigridPipeline(calib, cfg), maps, True, {}),
        "mvt": (MvtPipeline(calib, cfg), maps, True, {"bilateral13": 1}),
        "calibvis": (CalibVisPipeline(pipe.volume_grid, cfg.tsdf_limit),
                     volume, False, {}),
    }
    for name, (mode_pipe, state, splat, must) in modes.items():
        render = mode_pipe.make_renderer(camera)
        first = render(state)                           # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = render(state)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        print(f"launches in the {name} render: {launched}", flush=True)
        want = {k: must.get(k, 0) for k in launched}
        if launched != want:
            raise AssertionError(f"{name} render launched {launched}, "
                                 f"expected {want}")
        by_path[name] = launched
        _check_mode(np, torch, name, out, camera, fast_hits, splat)
        # run to run: the z-buffer (a min) and the coverage repeat exactly;
        # the colors are atomic float sums in a varying order
        if not (torch.equal(first[1], out[1]) and torch.equal(first[2],
                                                               out[2])):
            raise AssertionError(f"{name}: depth or coverage changed "
                                 "between two renders of the same state")
        spread = (first[0] - out[0]).abs()
        print(f"{name}: run-to-run color spread max {float(spread.max())!r} "
              f"over {int((spread.amax(-1) > 0).sum())} pixels", flush=True)
        if name == "calibvis":
            img = out[0][out[2]]
            blue = (img == img.new_tensor([0.0, 0.0, 1.0])).all(-1)
            cls = img.argmax(-1)
            print(f"calibvis: red {int(((cls == 0) & ~blue).sum())}, green "
                  f"{int(((cls == 1) & ~blue).sum())}, blue "
                  f"{int(blue.sum())} pixels", flush=True)
        ms = event_ms(lambda: render(state), iters=5, warmup=0)
        print(f"{name}: render {ms!r} ms (CUDA events, mean of 5) on {card}",
              flush=True)


def _phase8_app(torch, pipe, frames, card, by_path):
    """The application shell at the reference setup's scale: the setup's
    calibration volumes written under build/ with a .ks and a .conf,
    ``app record`` at the frames' sizes, then ``app run`` for each entry
    of APP_RUNS from the recording. Checks each run's launch counts, PNGs,
    timings.csv and (with stereo) the checkpoint's frame index; prints
    each run's stage means. Adds each run's launches to ``by_path``."""
    import shutil
    from pathlib import Path

    from rgbd_recon_tpu.io.checkpoint import CheckpointManager
    from rgbd_recon_tpu_torch import app, kernels
    from rgbd_recon_tpu_torch.calib.volume_io import write_calibration_volume

    calib, cfg = pipe.calib, pipe.config
    t0 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_app"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the reference setup's calibration volumes: the app loads them instead
    # of baking them again
    sensors = []
    for i in range(calib.num_sensors):
        lim = tuple(calib.depth_limits[i].tolist())
        for ext in ("cv_xyz", "cv_uv", "cv_xyz_inv"):
            write_calibration_volume(work / f"s{i}.{ext}",
                                     getattr(calib, ext)[i].cpu().numpy(),
                                     lim)
        sensors.append(f"kinect s{i}.yml")
    box = " ".join(str(v) for v in (*pipe.bbox.min, *pipe.bbox.max))
    (work / "scene.ks").write_text("\n".join(sensors) + f"\nbbx {box}\n")
    (work / "scene.conf").write_text(
        f"voxel_size: {cfg.voxel_size}\nbrick_size: {cfg.brick_size}\n"
        f"tsdf_limit: {cfg.tsdf_limit}\n")
    (H, W), (Hc, Wc) = frames.depths.shape[1:3], frames.colors.shape[1:3]
    sizes = ["--depth-size", str(W), str(H), "--color-size", str(Wc),
             str(Hc)]
    app.main(["record", "--out", str(work / "rec"), "--frames",
              str(APP_FRAMES), "--sensors", str(calib.num_sensors), *sizes])
    print(f"app: volumes written, {APP_FRAMES} frames recorded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (extra, per_frame) in APP_RUNS.items():
        out_dir, ck = work / name, work / f"{name}_ckpt"
        argv = ["run", str(work / "scene.ks"), "--conf",
                str(work / "scene.conf"), "--streams", str(work / "rec"),
                "--no-native-ingest", "--frames", str(APP_FRAMES),
                "--out", str(out_dir), "--width", "1280", "--height", "720",
                *sizes, *extra]
        stereo = "--stereo" in extra
        if stereo:
            argv += ["--checkpoint-dir", str(ck), "--checkpoint-every", "1"]
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        app.main(argv)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        print(f"{name}: launches {launched}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        want = {k: per_frame.get(k, 0) * APP_FRAMES for k in launched}
        if launched != want:
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"{want}")
        by_path[name] = launched
        pngs = sorted(out_dir.glob("frame_*.png"))
        if (len(pngs) != APP_FRAMES or any(
                p.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n" for p in pngs)):
            raise AssertionError(f"{name}: PNGs {pngs}")
        rows = (out_dir / "timings.csv").read_text().split()[1:]
        means = {r.split(",")[0]: float(r.split(",")[1]) for r in rows}
        if set(means) != {"1preprocess+2integrate", "3recon"}:
            raise AssertionError(f"{name}: timings.csv stages {means}")
        print(f"{name}: stage means in ms (host clock, device synchronized; "
              f"{APP_FRAMES} frames) {means} on {card}", flush=True)
        if stereo:
            latest = CheckpointManager(ck).latest()
            if latest is None or latest.frame_index != APP_FRAMES:
                raise AssertionError(f"{name}: checkpoint {latest}")
            print(f"{name}: checkpoint at frame {latest.frame_index}, "
                  f"volume {latest.volume.shape}", flush=True)


def main() -> int:
    # imports first: in a directory without the repo this fails before any
    # result is printed
    import numpy as np
    import torch

    from rgbd_recon_tpu_torch import kernels, profile_slice
    from rgbd_recon_tpu_torch.kernels import _build
    from rgbd_recon_tpu_torch.ops import bake, stencil13
    from rgbd_recon_tpu_torch.profile_slice import event_ms
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = profile_slice.card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 1. build the kernels --------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)

    # ---- 2. reference-scale setup ------------------------------------------
    t0 = time.perf_counter()
    pipe, frames, camera = profile_slice.reference_setup(dev)
    calib, cfg = pipe.calib, pipe.config
    renderer = pipe.make_renderer(camera)
    volume, maps, counts = pipe.fuse(frames)     # warm-up, fits the models
    renderer(volume, maps, counts)
    torch.cuda.synchronize()
    print(f"setup (bake, frames, fits, first fuse+render): "
          f"{time.perf_counter() - t0:.1f} s; volume {tuple(volume.shape)}",
          flush=True)

    # ---- 3. each kernel against its plain twin, main-path shapes -----------
    d_m = maps.raw_depth.contiguous()
    limits = calib.depth_limits.contiguous()
    d_norm = maps.depth[..., 0].contiguous()
    vol = volume.contiguous()
    bv = pipe.brick_vox
    occ = bake.surface_occ_plain(vol, bv)
    bs_scaled = (bake.fine_safe_field(occ, cfg.skip_brick_rounds)
                 * float(bv)).contiguous()
    K = cfg.skip_fine_rounds
    from rgbd_recon_tpu_torch.kernels.bake import (
        sentinel_bake_cuda,
        surface_occ_cuda,
    )
    from rgbd_recon_tpu_torch.kernels.stencil13 import (
        bilateral13_cuda,
        quality13_cuda,
    )

    cases = [
        ("bilateral13", "rgbd_recon_tpu_torch/csrc/stencil13.cu",
         "rgbd_recon_tpu/ops/stencil_pallas.py:153",
         lambda: bilateral13_cuda(d_m, limits),
         lambda: stencil13.bilateral13_plain(d_m, limits)),
        ("quality13", "rgbd_recon_tpu_torch/csrc/stencil13.cu",
         "rgbd_recon_tpu/ops/stencil_pallas.py:186",
         lambda: quality13_cuda(d_norm),
         lambda: stencil13.quality13_plain(d_norm)),
        ("surface_occ", "rgbd_recon_tpu_torch/csrc/bake.cu",
         "rgbd_recon_tpu/ops/bake_pallas.py:58",
         lambda: surface_occ_cuda(vol, bv),
         lambda: bake.surface_occ_plain(vol, bv)),
        ("sentinel_bake", "rgbd_recon_tpu_torch/csrc/bake.cu",
         "rgbd_recon_tpu/ops/bake_pallas.py:112",
         lambda: sentinel_bake_cuda(vol, bs_scaled, bv, K),
         lambda: bake.sentinel_bake_plain(vol, bs_scaled, bv, K)),
    ]
    results = []
    for name, source, replaces, kern, plain in cases:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if name in ("bilateral13", "quality13"):
            scale = max(float(w.abs().max()) for w in want)
            bound = STENCIL_REL_BOUND * scale
        else:
            bound = 0.0       # bit-exact
        print(f"{name}: max|kernel - plain| = {err!r} (bound {bound!r})",
              flush=True)
        if not err <= bound:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{err} > {bound}")
        ms = event_ms(kern, iters=20, warmup=3)
        plain_ms = event_ms(plain, iters=5, warmup=1)
        results.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))

    # ---- 4. the main path, counted -----------------------------------------
    kernels.reset_launch_counts()
    volume, maps, counts = pipe.fuse(frames)
    out = renderer(volume, maps, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    print(f"launches on the fast path: {launched}", flush=True)
    missing = [k for k, n in launched.items() if n <= 0]
    if missing:
        raise AssertionError(f"fast path did not launch: {missing}")
    by_path = {"fast": launched}
    _, fast_hits = _check_render(np, torch, "fast", volume, out, counts, cfg,
                                 camera, HITS_REF)

    # ---- 5. timings (informative) ------------------------------------------
    def timed(fn, samples=3, iters=10):
        return [event_ms(fn, iters=iters, warmup=2 if i == 0 else 0)
                for i in range(samples)]

    def frame_fn(p, r):
        def full():
            v, m, c = p.fuse(frames)
            return r(v, m, c)
        return full

    fuse_ms = timed(lambda: pipe.fuse(frames))
    frame_ms = timed(frame_fn(pipe, renderer))
    print(f"fast: fuse ms {fuse_ms}, fuse+render ms {frame_ms} on {card}",
          flush=True)
    del volume, maps, counts, out

    # ---- 6. the parity paths, counted and checked --------------------------
    for name, overrides in PARITY_PATHS.items():
        t0 = time.perf_counter()
        ppipe = TsdfPipeline(calib, dataclasses.replace(cfg, **overrides),
                             pipe.bbox)
        prender = ppipe.make_renderer(camera)
        frame_fn(ppipe, prender)()           # warm-up: fits the models
        torch.cuda.synchronize()
        print(f"{name}: setup + first fuse+render "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        kernels.reset_launch_counts()
        volume, maps, counts = ppipe.fuse(frames)
        out = prender(volume, maps, counts)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        print(f"launches on the {name} path: {launched}", flush=True)
        must, must_not = PARITY_LAUNCHES[name]
        missing = [k for k in must if launched[k] <= 0]
        extra = [k for k in must_not if launched[k] > 0]
        if missing or extra:
            raise AssertionError(f"{name} path: not launched {missing}, "
                                 f"launched {extra}")
        by_path[name] = launched
        rmse, _ = _check_render(np, torch, name, volume, out, counts,
                                ppipe.config, camera, fast_hits)
        print(f"{name}: surface RMSE {rmse!r} mm; BENCH_r05.json records "
              f"{TPU_EXACT_RMSE_MM} mm for the JAX reference-exact path, "
              "measured on a TPU", flush=True)
        fuse_ms = timed(lambda: ppipe.fuse(frames), samples=2, iters=3)
        frame_ms = timed(frame_fn(ppipe, prender), samples=2, iters=3)
        print(f"{name}: fuse ms {fuse_ms}, fuse+render ms {frame_ms} on "
              f"{card}", flush=True)
        del ppipe, prender, volume, maps, counts, out
        torch.cuda.empty_cache()

    # ---- 7. the other reconstruction modes on the fast path's state -------
    _phase7_modes(np, torch, pipe, frames, camera, card, fast_hits, by_path)

    # ---- 8. the application shell, every mode -----------------------------
    _phase8_app(torch, pipe, frames, card, by_path)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    for r in results:
        r["launches"] = by_path["fast"][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()}

    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
