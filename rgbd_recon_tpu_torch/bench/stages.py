"""Stage breakdowns of the fused update and the render on the card (the
port of scripts/bench_preprocess.py, bench_fuse_stages.py, bench_render.py
and bench_render_stages.py).

    python -m rgbd_recon_tpu_torch.bench.stages
        [--part preprocess|fuse|render|all] [--small] [--iters N]

The scene is those scripts' two spheres seen by the 4 sensors of
``headline.reference_setup`` at 512x424 depth / 1280x1080 colour, through
that setup's calibration, 200x220x200 voxels (10 cm bricks, 7 LODs) and
1280x720 camera; ``--small`` takes bench_render.py:52-60's scene instead
(64x56 / 80x64 sensors, 5 cm voxels in 25 cm bricks, a 128x96 camera).
Each row times one call at the port's own stage boundaries: one untimed
warm-up call, then the mean of ``iters`` calls (10 for preprocess, 5 for
the rest) on the host clock read after ``torch.cuda.synchronize()``; on
the card the CUDA-event mean of ``iters`` more calls beside it. Each stage
runs on the output of the stage before, as the scripts chain them.

- ``preprocess`` (bench_preprocess.py:57-114): ``pipe.preprocess``
  whole; ``morph_dilate``; the ``bilateral13`` and ``quality13`` kernels
  through ``ops/stencil13.py`` on the morph output and on the
  preprocessed depth; then ``lab_colors`` and ``bilateral_lab`` (the port
  splits the JAX package's bilateral + LAB pass in two), ``boundary``,
  ``normals`` and the ``quality`` combine; ``mark_bricks``; the colour
  bilinear fetch alone.
- ``fuse`` (bench_fuse_stages.py): ``preprocess+mark``, ``mark_bricks``,
  ``integrate``, then ``tsdf.integrate_compact`` alone (the code the
  pipeline's integrate runs: on the card the flags, one compaction and one
  ``brick_integrate`` launch), the plain form's two calls
  ``tsdf.occupied_brick_ids`` and ``tsdf.integrate_bricks`` alone (rows
  ``occupied_brick_ids_plain``, ``integrate_bricks_plain``), and the
  occupied-brick count. The
  script's rows of the TPU layouts (:78-133: the projection block gather,
  the packed maps, the 4x corner gathers, the block scatter, the unbrick
  transpose) have no counterpart: the port indexes the maps and scatters
  the bricks directly, without those layouts.
- ``render`` (bench_render.py, bench_render_stages.py): ``fuse``; the full
  render, with its hits, overflow and ``pipe.diagnostics``;
  ``render.bake``, ``ops/bake.surface_occ``, ``ops/bake.brick_clearance``
  and ``ops/bake.sentinel_bake`` on the fused volume (the bake's parts, as
  the pipeline calls them); ``render.render_from_baked``;
  ``holefill.fill_colors_planar`` on a zero frame of the camera's size;
  then one render from a moved camera (bench_render_stages.py:99-106),
  which must not rebuild the renderer.

Prints the card's name and power limit, then one JSON line with every row.
Exits non-zero before any work when the process has no card (a caller of
:func:`run` may pass ``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from .. import kernels
from ..device import DEFAULT, resolve
from ..ops import bake, holefill, preprocess, stencil13, tsdf
from ..ops.sampling import pair_bilinear
from .ablation import device_info, launches_since, log, timed_ms
from .headline import REFERENCE, Scene, reference_setup
from .render_sweep import two_sphere_frames

PARTS = ("preprocess", "fuse", "render")
ITERS = {"preprocess": 10, "fuse": 5, "render": 5}
# bench_render.py:52-60
SMALL = Scene(depth_size=(64, 56), color_size=(80, 64), cv_res=(24, 32, 24),
              inv_res=(40, 44, 40), voxel_size=0.05, brick_size=0.25,
              tsdf_limit=0.02, num_lods=5, camera_size=(128, 96))
# bench_render_stages.py:99-100: the moved camera's pose
MOVED_EYE, MOVED_TARGET = (0.6, 1.5, 2.4), (0.0, 1.0, 0.0)


class _Rows:
    """Times the stages of one part into ``rows``."""

    def __init__(self, iters: int, on_card: bool):
        self.iters, self.on_card = iters, on_card
        self.rows = {}

    def __call__(self, name, fn):
        """The row ``name``; returns the warm-up call's result."""
        out, ms, ev = timed_ms(fn, self.iters, self.on_card)
        self.rows[name] = {"ms": ms, "event_ms": ev}
        log(f"{name:45s} {ms:10.3f} ms")
        return out


def preprocess_rows(pipe, frames, row: _Rows) -> dict:
    calib = pipe.calib
    pm = pipe._get_pixel_models(frames.depths.shape[1:3])
    if pm is None:
        raise ValueError("the preprocess rows time the pixel-model chain")
    maps, _ = row("preprocess", lambda: pipe.preprocess(frames))
    d_m = row("morph_dilate",
              lambda: preprocess.morph_dilate(frames.depths)).contiguous()
    limits = calib.depth_limits.contiguous()
    bf_sums = row("bilateral13", lambda: stencil13.bilateral13(d_m, limits))
    depth_pre = maps.depth[..., 0].contiguous()
    row("quality13", lambda: stencil13.quality13(depth_pre))
    n = d_m.shape[0]
    near, far = limits[:, 0].view(n, 1, 1), limits[:, 1].view(n, 1, 1)
    depth_norm = (d_m - near) / (far - near)
    lab = row("lab_colors", lambda: preprocess.lab_colors(
        frames.colors, depth_norm, pm, calib.cv_uv))
    depth2 = row("bilateral_lab", lambda: preprocess.bilateral_lab(
        d_m, calib.bbox_min, calib.bbox_max, limits, bf_sums,
        pixel_models=pm, cv_xyz=calib.cv_xyz))
    depth2, _ = row("boundary", lambda: preprocess.boundary(
        depth2, lab, pipe.config.refine))
    nrm = row("normals", lambda: preprocess.normals(depth2, pm,
                                                    calib.cv_xyz))
    q_sums = stencil13.quality13(depth2[..., 0].contiguous())
    row("quality", lambda: preprocess.quality(
        depth2, nrm, calib.camera_positions, q_sums, pm, calib.cv_xyz))
    row("mark_bricks", lambda: pipe._mark_bricks(pm, maps))
    # the LAB table's bilinear fetch alone, at lab_colors' coordinates
    table = frames.colors.to(torch.bfloat16)
    z_far = 1.0 - 0.5 / calib.cv_uv.shape[1]

    def color_fetch():
        z = torch.where((depth_norm <= 0.0) | (depth_norm >= 1.0), z_far,
                        depth_norm)[..., None]
        uv = (pm.uv_p + pm.uv_q * z) / (1.0 + pm.uv_r * z)
        return [pair_bilinear(table[i], uv[i, ..., 0], uv[i, ..., 1])
                for i in range(n)]

    row("color_fetch", color_fetch)
    return {}


def fuse_rows(pipe, frames, row: _Rows) -> dict:
    if not pipe.compact:
        raise ValueError("the fuse rows time the brick-compact integration")
    c = pipe.config
    pm = pipe._get_pixel_models(frames.depths.shape[1:3])
    maps, counts = row("preprocess+mark", lambda: pipe.preprocess(frames))
    row("mark_bricks", lambda: pipe._mark_bricks(pm, maps))
    row("integrate", lambda: pipe.integrate(maps, counts))
    integrate_args = (maps.depth[..., 0], maps.quality, maps.silhouette,
                      pipe._limit, pipe.volume_grid.shape, pipe.brick_vox)
    integrate_kw = dict(carve_sil_threshold=c.carve_sil_threshold,
                        phantom_hull=c.phantom_hull, taps=c.integrate_taps)
    row("integrate_compact", lambda: tsdf.integrate_compact(
        pipe.projections, counts, c.min_voxels_per_brick, c.brick_capacity,
        *integrate_args, **integrate_kw))
    ids = row("occupied_brick_ids_plain", lambda: tsdf.occupied_brick_ids(
        counts, c.min_voxels_per_brick, c.brick_capacity))
    row("integrate_bricks_plain", lambda: tsdf.integrate_bricks(
        pipe.projections, ids, *integrate_args, **integrate_kw))
    return {"occupied_bricks": int((counts > c.min_voxels_per_brick).sum())}


@contextlib.contextmanager
def _counting_builds(pipe):
    """Counts the render functions ``pipe`` builds inside the block
    (a renderer handle builds one when made and on a new generation)."""
    builds = []
    make = pipe.make_render_fn

    def counted(*args, **kwargs):
        builds.append(1)
        return make(*args, **kwargs)

    pipe.make_render_fn = counted
    try:
        yield builds
    finally:
        del pipe.make_render_fn


def render_rows(pipe, frames, camera, row: _Rows) -> dict:
    c = pipe.config
    volume, maps, counts = row("fuse", lambda: pipe.fuse(frames))
    volume = volume.contiguous()
    with _counting_builds(pipe) as builds:
        renderer = pipe.make_renderer(camera)
        out = row("render", lambda: renderer(volume, maps, counts))
        render_fn, cam0 = pipe.make_render_fn(camera)
        if render_fn.render_from_baked is None:
            raise ValueError("the render rows time the block path")
        baked = row("bake", lambda: render_fn.bake(volume, counts))
        bv = pipe.brick_vox
        occ = row("surface_occ", lambda: bake.surface_occ(volume, bv))
        _, bs = row("brick_clearance", lambda: bake.brick_clearance(
            occ, c.skip_brick_rounds, bv))
        dtype = (torch.bfloat16 if c.march_dtype == "bfloat16"
                 else torch.float32)
        row("sentinel_bake", lambda: bake.sentinel_bake(
            volume, bs, bv, c.skip_fine_rounds, dtype))
        row("render_from_baked", lambda: render_fn.render_from_baked(
            baked, maps, cam0, pipe._get_projection_models(), pipe._limit))
        h, w = camera.height, camera.width
        planes = [torch.zeros((h, w), device=volume.device)
                  for _ in range(4)]
        depth = torch.ones((h, w), device=volume.device)
        row("fill_colors_planar", lambda: holefill.fill_colors_planar(
            planes, depth, c.num_lods))
        # the moved camera: the same handle, a new pose, no rebuild
        moved = dataclasses.replace(camera, eye=MOVED_EYE,
                                    target=MOVED_TARGET)
        built, generation = len(builds), pipe._generation
        t0 = time.perf_counter()
        renderer(volume, maps, counts, camera_pose=moved)
        if row.on_card:
            torch.cuda.synchronize()
        moved_ms = (time.perf_counter() - t0) * 1e3
        rebuilt = len(builds) != built or pipe._generation != generation
    log(f"moved-camera render {moved_ms:.3f} ms, rebuilt {rebuilt}")
    return {"hits": int(out.hit.sum()), "overflow": out.overflow.tolist(),
            "diagnostics": pipe.diagnostics(counts, out),
            "moved_camera": {"ms": moved_ms, "rebuilt": rebuilt}}


def run(part: str = "all", *, small: bool = False, iters=None,
        device=DEFAULT, setup=None) -> dict:
    """The stage rows of ``part`` (one of PARTS, or "all") on ``device``
    (the card unless the caller names another; raises without one), each
    part at ITERS[part] timed calls a row unless ``iters`` is given.
    ``setup`` is (pipeline, two-sphere frames, camera), built here from
    ``reference_setup`` (at SMALL with ``small``) when not given. Returns
    each part's rows and facts, the kernels launched and the device."""
    device = resolve(device)
    on_card = device.type == "cuda"
    parts = PARTS if part == "all" else (part,)
    if setup is None:
        scene = SMALL if small else REFERENCE
        pipe, _, camera = reference_setup(device, scene)
        setup = pipe, two_sphere_frames(device, scene, pipe.bbox), camera
    pipe, frames, camera = setup
    before = kernels.launch_counts()
    result = {}
    for p in parts:
        row = _Rows(ITERS[p] if iters is None else iters, on_card)
        log(f"-- {p}")
        if p == "preprocess":
            facts = preprocess_rows(pipe, frames, row)
        elif p == "fuse":
            facts = fuse_rows(pipe, frames, row)
        else:
            facts = render_rows(pipe, frames, camera, row)
        result[p] = {"iters": row.iters, "rows": row.rows, **facts}
    return {"parts": result, "launches": launches_since(before),
            "device": device_info(device)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=PARTS + ("all",), default="all")
    ap.add_argument("--small", action="store_true",
                    help="bench_render.py's small scene")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls a row (default: 10 for preprocess, "
                    "5 for the rest)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stages: torch.cuda.is_available() is false; it "
                         "runs only on the card")
    result = run(args.part, small=args.small, iters=args.iters)
    print(result["device"]["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
