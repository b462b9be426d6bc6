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
