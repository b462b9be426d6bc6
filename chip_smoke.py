#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``rgbd_recon_tpu_torch/csrc``
(nvcc, sm_90a, one process per source), holds each kernel against its plain
PyTorch twin at the shapes the main path gives it, bit for bit, times each
kernel (CUDA events around the wrapper, and its own device time under
``torch.profiler`` with the L2 flushed before each call and without;
between CUDA events once the profiler records no device activity)
beside its bound (bytes or operations of this run's inputs at the H100's
peak rates) and, where one PyTorch call computes the same function, that
call. The render bake's chain kernels (``csrc/bake.cu`` ``brick_clearance``
and ``oct_table``) are held and timed on the inputs one fast and one
parity frame's bake hands them (the clearance also at 0, 1, 6 and 16
rounds, on an empty, a full and a 30 x 30 x 30 grid; the oct table at
half the surface bricks' capacity and in f32), and the whole
bake on the kernels bit for bit against it on the twins, with no host sync
under ``torch.cuda.set_sync_debug_mode("error")``, its launches, device
activities and host ms printed. The render's stage kernels (``csrc/compact.cu``,
``csrc/render_stages.cu`` and ``csrc/march.cu``'s row march) are held and
timed on the recorded inputs of every stage call of one fast frame (the
scan, the block set-up, four compactions, the coarse march, the bracket,
phase 1, two tail stages, the hit gather, the compose) and one parity
frame (the coarse and the full march, two compactions): every output and
every array a stage updates in place bit-equal to its plain twin's, each
march stage's rays, samples and longest ray, the scan's, the block
set-up's and the bracket's launch shapes printed; then the whole
``render_from_baked`` on the kernels against it on the twins (hit mask,
window depth, march steps, overflow, pre-fill planes, colour, bit for
bit), once under ``torch.cuda.set_sync_debug_mode("error")`` (no host
sync after the bake), and its host ms split by part. The fill kernels
(``csrc/holefill.cu``) are held and timed on the recorded pre-fill planes
(contiguous, as the render passes them) of one fast and one parity
frame: each pull level bit-equal to ``_pull_planar`` along the kernel's
own chain and from each of the twin's levels, the push's level bit-equal
and its colours within 1e-6 of ``_push_planar`` (which resamples by cuBLAS
products), the pull chain (and each of its launches), the push and the
whole fill timed beside their bounds by bytes and the plain versions; the
same planes a float off 16 bytes and as an (H, W, 4) image's strided
views (the dense render's) bit-equal to the contiguous run, the pull
timed on each layout. The hit kernels
(``csrc/hits.cu``) are held and timed on the hit sets one fast and one
parity frame hand to ``ops.hits.refine_hits`` and ``shade_hits``: the
refined positions and shade mode 0's rgba bit-equal to the twins, the
window depth and modes 1 and 2 within HIT_ATOL (bit-equal flags
printed), each kernel's bound by the bytes its data needs and its launch
shape (the refine's with its samples a chunk and whether its per-hit
inputs took the row path). The
preprocess kernels (``csrc/preprocess.cu``) are held and timed on the
arguments one fast fuse hands each pass (the morph's launch shape and its
pixels by exit printed). The fuse kernels (``csrc/fuse.cu``) are held and
timed on the arguments one fast and one parity fuse hand
``ops.bricks.mark_pixels`` and ``ops.tsdf.integrate_compact``: the
marking's counts equal to ``mark_pixels_plain``'s, the volume bit-equal
to ``integrate_compact_plain``'s (also at a capacity of half the occupied
bricks), their launches and registers printed; the pipeline's marking and
integrate run under ``torch.cuda.set_sync_debug_mode("error")`` and the
whole fuse under ``"warn"``, its remaining syncs printed by site. Then it
drives
four paths
at reference scale through the entry points a user calls: 4 synthetic
sensors at 512x424 depth / 1280x1080 color, a 2 x 2.2 x 2 m box at 1 cm
voxels (200x220x200), ``TsdfPipeline.fuse`` then ``make_renderer(camera)``
at 1280x720:

- ``fast``: the default fast config (the main path);
- ``parity``: bench.py's reference-exact parity config (bilinear integrate
  taps, one trilinear march of the raw volume, calibration-volume blend);
- ``parity_dense``: the parity config without bricking or space skipping
  (dense integrate, full-screen render), scripts/make_golden.py's form;
- ``fast_f32``: the fast config with ``march_dtype="float32"``: f32
  sentinel and oct tables (the sentinel bake's f32 output).

For each path it checks which kernels launched (launch counts set to 0
just before the path's fuse + render and read just after; the march once a
stepwise march: ``PATH_MARCHES``; the fill's pull 3 times (two levels a
launch) and its push once: ``FILL_LAUNCHES``; the hit kernels once a render, no refine in the
trilinear full-screen render: ``PATH_HITS``; the block stages once a
render of the block path, the compaction once a list:
``PATH_STAGES``; the fuse's marking once, its compaction and integrate
once on the brick-compact paths: ``PATH_FUSE``; the bake's clearance once
a bake, its compaction and oct table once where the render builds the oct
table: ``PATH_BAKE``), that the output
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
  frame index and each run's kernel launch counts; one more mode-1 run
  refines the sensor poses after every frame (``--refine-every 1``) and
  must print its corrections;
- phase 9 drives the fast config's variants (the camera-influence view,
  the two normal-weighted blends, the profiling switches, per-block
  brackets, the chunked march alone and with per-block brackets, 16
  dilation rounds in 10-voxel bricks, 20 in 20-voxel bricks, the render
  without the fill): launch counts (no fill kernel without colorfill),
  the color variants' and the unfilled render's hit mask and depth
  bit-equal to the fast path's, the others held to the sphere, fuse +
  render times;
- phase 10 reconfigures one pipeline under one renderer handle: limit
  0.02 and back, 2 cm voxels (100x110x100) and back, the flip-backs
  bit-equal to the first render;
- phase 11 reproduces scripts/validate_pose_ba.py: sensor 1 of a 4-sensor
  512x424 rig drifted by 1 degree about y plus (18, 0, 8) mm, four
  refine -> apply -> re-fuse rounds of 24 LM iterations, the mean lookup
  error of each sensor's cv_xyz against the true rig's before and after
  (sensor 1 at most half its start, the others moved by at most 0.5 mm),
  each round's gates, ms per round and per LM iteration, and the device's
  busy share over one round;
- phase 12 drives the multi-device layer (``rgbd_recon_tpu_torch.dist``)
  with all its shards on this one card: ``shard_compact_step`` over 8 and 4
  shards (volume, hit mask and depth bit-equal to the single-device fast
  path, ``surface_occ`` and ``sentinel_bake`` launched once per shard, the
  slab bake's tables bit-equal to the single-device bake's, and each
  shard's two bake kernels bit-equal to their plain twins on its slab grown
  by one brick), ``_shard_dense_step`` over 4 shards at the
  ``parity_dense`` config,
  ``shard_preprocess`` of the 4 sensors over 4 and 2 shards, the mesh form
  of ``refine_poses`` on phase 11's drifted rig, and
  ``invert_calibration_bruteforce`` on the card against the kd-tree
  inverter; with two cards or more also the compact step over them. On one
  card its CUDA-event times measure the shards' extra launches and copies,
  not scaling;
- phase 13 (run right after phase 3, while torch.profiler still records)
  runs the gather-rate probe (``rgbd_recon_tpu_torch.bench.gather_probe``)
  at the TPU probe's shapes: the four gather kernels of ``csrc/gather.cu``
  against their plain twins bit for bit, timed like the kernels of phase 3
  beside their bound and the PyTorch call that computes the same gather;
  the shared-memory gather's table load is timed on its own (a launch with
  no lookups). ``gather_flat`` and ``gather_cols`` are also held against
  their plain versions at an odd shape and on an index view at a storage
  offset (``gather_probe.edge_cases``). ``gather_rows_cluster``, the
  probe's measure of lookups from a thread-block cluster's shared memory
  (each row held in 4 or 8 blocks; not behind ``gather_rows``, which reads
  the row from L2), runs at ``gather_rows``' shapes in the same way and
  goes into ``gather_rows``' record; it is held to its plain version at odd
  shapes, at the longest rows clusters of 4 and 8 blocks hold, and on a
  table view at a storage offset, and must refuse a longer row;
  ``gather_flat_smem`` on table views at storage offsets 1-3, at its
  largest table and at 1, 3 and 5 lookups. Each kernel must have launched
  once at the probe's shapes; ``gather_rows_cluster`` and
  ``gather_flat_smem`` print their launch configuration (blocks a cluster,
  clusters a row or the grid, the table bytes read from L2, reckoned); the
  three gathers from L2 print their G lookups/s and the L2 sector rate that
  implies (lookups x 32 B over the device time: reckoned, not a counter).
  They are on no path: launched 0 times in every path's run;
- phase 14 runs ``python -m rgbd_recon_tpu_torch.dist.worker`` as 2
  processes of 4 shards each on the worker's scene: gloo, both processes
  on the first card, bit-equal to the single device and to the 8-shard
  step of one process; NCCL with the two processes on one card must be
  refused; with two cards or more, NCCL with a card a process, bit-equal
  too; with four cards or more, the same again with 4 processes of 2
  shards. A worker that fails or outlives its limit fails the phase; all
  are killed;
- phase 15 runs the app for 2 frames with ``--preview-port`` on a free
  port, fetches ``/frame`` after each frame the app publishes (a baseline
  JPEG with SOI, EOI and the frame's size), times what ``update()`` costs
  the app's frame loop, and times ``viz/jpeg.py`` on the fast path's
  1280x720 render on this machine's host.

- phase 16 runs the three measurement scripts of
  ``rgbd_recon_tpu_torch.bench`` at reference scale, MEASURE_ITERS timed
  calls a row, on one setup: the fast-mode ablation (``ablation.run``;
  its "fast defaults" and "reference-exact (all)" rows must read the
  fast and parity paths' RMSE and hits bit for bit, and it must launch
  every path kernel), the render-lever sweep (``render_sweep.run``; its
  baseline's hits and overflow must equal a fresh pipeline's render of
  the two-sphere frames) and the stage rows of preprocess, fuse and render
  (``stages.run``; the moved-camera render must not rebuild the renderer);
  every RMSE finite, every time positive, each module's launches printed.

``python3 chip_smoke.py --multiprocess`` builds the kernels and runs phase
14 alone (on a machine of four cards: gloo and NCCL at 2 x 4 and 4 x 2).

Output: the card's name and power limit (nvidia-smi), one JSON line with the
per-kernel results, the probe's four gathers too (launches on the fast
path, and per path; max |kernel -
plain|; kernel, plain and library ms; device ms with a cold and a warm L2
and its split by device activity; the bound, what sets it and the share of
it the kernel's cold device time reaches), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys
import time

# the accuracy oracle at reference scale is rgbd_recon_tpu_torch/bench/
# oracle.py's: the fast and parity paths hold their benchmark cells' gates
# (bench/cells/*.json); fast_f32 holds the fast cell's; the paths that are
# no cell (parity_dense, the variants of phase 9) hold the fast cell's hit
# count and the broad SIDE_RMSE_LIMIT_MM
FAST_CELL = "tsdf_fast_4kinect2_1cm"
PARITY_CELL = "tsdf_parity_4kinect2_1cm"
SIDE_RMSE_LIMIT_MM = 7.0
# BENCH_r05.json: the JAX reference-exact path's RMSE, measured on a TPU
TPU_EXACT_RMSE_MM = 5.55
# the preprocess chain's kernels (csrc/preprocess.cu): each once a fuse on
# the pixel models; the four that read the calibration launch 0 times
# through the calibration volumes (ops/preprocess.py kernel_passes)
PRE_LAUNCHES = {"morph": 1, "lab": 1, "depth2": 1, "boundary": 1,
                "normals": 1, "quality": 1}
PRE_CALIB = ("lab", "depth2", "normals", "quality")
# the render's block stages (csrc/compact.cu, csrc/render_stages.cu): each
# once a render of the block path but the compaction, which makes the
# block list, a list a tail stage (the fast config: two) and the hit list
STAGE_KERNELS = ("compact", "scan", "block_setup", "bracket", "hit_gather",
                 "compose")
FAST_STAGES = dict(compact=4, scan=1, block_setup=1, bracket=1,
                   hit_gather=1, compose=1)
PATH_STAGES = {"fast": FAST_STAGES, "parity": dict(FAST_STAGES, compact=2),
               "parity_dense": {k: 0 for k in STAGE_KERNELS},
               "fast_f32": FAST_STAGES}
# the fuse's marking and brick-compact integration (csrc/fuse.cu): a
# brick_mark launch a fuse (a shard of the sensor-sharded preprocess);
# with the brick-compact integrate also one compaction (the occupied
# bricks' slot map) and one brick_integrate (a slab of the sharded step);
# the dense integrate (parity_dense) launches neither
FUSE_KERNELS = ("brick_mark", "brick_integrate")
COMPACT_FUSE = dict(brick_mark=1, compact=1, brick_integrate=1)
PATH_FUSE = {"fast": COMPACT_FUSE, "parity": COMPACT_FUSE,
             "parity_dense": dict(brick_mark=1, compact=0,
                                  brick_integrate=0),
             "fast_f32": COMPACT_FUSE}
# the render bake's chain (csrc/bake.cu): one brick_clearance launch a
# bake (also without the sentinel table), and where the render builds its
# oct table one compaction of the surface bricks and one oct_table launch
BAKE_KERNELS = ("brick_clearance", "oct_table")
FAST_BAKE = dict(brick_clearance=1, compact=1, oct_table=1)
PATH_BAKE = {"fast": FAST_BAKE,
             "parity": dict(brick_clearance=1, compact=0, oct_table=0),
             "parity_dense": dict(brick_clearance=0, compact=0, oct_table=0),
             "fast_f32": FAST_BAKE}
# a whole bake's launches (the phase 3 bake section)
BAKE_LAUNCHES = {"fast": dict(surface_occ=1, sentinel_bake=1, **FAST_BAKE),
                 "parity": dict(surface_occ=1, brick_clearance=1)}
FRAME_KERNELS = (*STAGE_KERNELS, *FUSE_KERNELS, *BAKE_KERNELS)


def _plus(*counts):
    """Launch counts added kernel by kernel."""
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


# the stage, fuse and bake-chain kernels' launches of one fuse + render a
# path
PATH_FRAME = {p: _plus(PATH_STAGES[p], PATH_FUSE[p], PATH_BAKE[p])
              for p in PATH_STAGES}
# the kernels of the paths (the gather probe's four run on none)
PATH_KERNELS = ("bilateral13", "quality13", "surface_occ", "sentinel_bake",
                "march", "holefill_pull", "holefill_push", "hit_refine",
                "hit_shade", *PRE_LAUNCHES, *STAGE_KERNELS, *FUSE_KERNELS,
                *BAKE_KERNELS)
# the fill kernels' launches a render with colorfill: a pull launch for
# every two levels past LOD 0 (a 1280x720 frame at 7 LODs: 3) and one push
FILL_LAUNCHES = {"holefill_pull": 3, "holefill_push": 1}
# the fill kernels' device activities (csrc/holefill.cu)
FILL_ACTIVITIES = {"pull_tile_kernel", "push_tile_kernel"}
NO_FILL = {k: 0 for k in FILL_LAUNCHES}
# the fill's colours against its plain twin (which resamples by cuBLAS
# products; tests/test_torch_kernels.py); pull and level are bit-equal
FILL_COLOR_ATOL = 1e-6
# the march kernel's launches a frame (one a stepwise march): the fast
# config's coarse march, phase 1 and two tail stages; the parity config's
# coarse and full march; the full-screen march without blocks
PATH_MARCHES = {"fast": 4, "parity": 2, "parity_dense": 1, "fast_f32": 4}
# the hit kernels' launches a render: one refine (none in the full-screen
# render of a trilinear march, whose secant needs none) and one shade
HIT_LAUNCHES = {"hit_refine": 1, "hit_shade": 1}
PATH_HITS = {"fast": HIT_LAUNCHES, "parity": HIT_LAUNCHES,
             "parity_dense": {"hit_refine": 0, "hit_shade": 1},
             "fast_f32": HIT_LAUNCHES}
# the hit kernels against their twins: the window depth and shade modes 1
# and 2 within HIT_ATOL (tests/test_torch_kernels.py); the refined
# positions and mode 0's rgba bit-equal
HIT_ATOL = 1e-6
# the hit kernels' bounds count bytes alone: a live hit's arithmetic
# (about 100-400 f32 operations a refine, 500 a fast and 1,400 a parity
# shade of 4 sensors, counted by hand from csrc/hits.cu) takes at most
# about half its bytes' time at the card's f32 rate on either cell's hits
# the stages of the marches phase 3 records, in the order the render runs
# them
MARCH_STAGES = {"fast": ("coarse", "phase1", "tail1", "tail2"),
                "parity": ("coarse", "full")}
# f32 operations of one march step: the position (3 products, 3 sums), the
# texel index (3 products; trilinear: 3 more subtractions, 3 floors, 3
# weights, the 7 blends of 2 products and a sum), the clamp, the test, the
# sentinel advance (3) and the step (1); the secant on the hit step
# (4 and a division) is left out
MARCH_STEP_OPS = {"nearest": 15, "trilinear": 15 + 3 + 3 + 3 + 7 * 3}


def _side_paths():
    """The paths driven after the fast path, with the config changes of
    each: bench.py's reference-exact parity config (the parity cell's),
    it without bricking or space skipping, the f32 march."""
    from rgbd_recon_tpu_torch.bench.headline import load_cell

    parity = load_cell(PARITY_CELL)["pipeline"]
    return {
        "parity": parity,
        "parity_dense": dict(parity, bricking=False, skip_space=False),
        "fast_f32": dict(march_dtype="float32"),
    }


def _gate(path):
    """The oracle gate a path holds (see FAST_CELL)."""
    from rgbd_recon_tpu_torch.bench.headline import load_cell

    fast = load_cell(FAST_CELL)["gate"]
    if path in ("fast", "fast_f32"):
        return fast
    if path == "parity":
        return load_cell(PARITY_CELL)["gate"]
    return dict(fast, rmse_limit_mm=SIDE_RMSE_LIMIT_MM)


# kernels each side path must and must not launch (the march: as
# PATH_MARCHES says)
SIDE_LAUNCHES = {
    "parity": (("bilateral13", "quality13", "surface_occ",
                "brick_clearance"), ("sentinel_bake", "oct_table")),
    "parity_dense": (("bilateral13", "quality13", "brick_mark"),
                     ("sentinel_bake", "brick_integrate", "brick_clearance",
                      "oct_table")),
    "fast_f32": (("bilateral13", "quality13", "surface_occ",
                  "sentinel_bake", "brick_clearance", "oct_table"), ()),
}  # the hit kernels as PATH_HITS says, the preprocess's as PRE_LAUNCHES
# device time of a kernel (phase 3): torch.profiler over DEVICE_ITERS calls,
# each after a write of FLUSH_BYTES that evicts the 50 MB L2 and a read of
# FLUSH_BYTES more that evicts the written lines (cold: the call's inputs
# come from HBM, and it pays no write-back of the flush's dirty lines), and
# back to back (warm)
DEVICE_ITERS = 20
FLUSH_BYTES = 128 * 2 ** 20
TRACE_TRIES = 3
# the card's spin before a call timed between CUDA events: ~1 ms at the
# H100's clocks, longer than the host takes to queue a call and its flush
SPIN_CYCLES = 2_000_000
# the device split of a time taken between CUDA events
EVENTS_SPLIT = "all activities (CUDA events)"
# the H100 SXM's published peaks (NVIDIA H100 datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores, at the 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
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
# (a mode's per-frame counts: every path kernel in mode 1, the march four
# times and the fill's pull three, twice the bake (its chain too), march,
# fill and hit kernels with stereo, the two stencils and the preprocess's six
# elsewhere, bilateral13 a second time in the MVT render, whose depth
# pass reads the calibration volumes and runs its twin; every mode fuses,
# so the fuse's marking, compaction and integration run once a frame)
APP_FRAMES = 2
MODE1_FRAME = dict(bilateral13=1, quality13=1, surface_occ=1,
                   sentinel_bake=1, march=PATH_MARCHES["fast"],
                   **FILL_LAUNCHES, **HIT_LAUNCHES, **PRE_LAUNCHES,
                   **PATH_FRAME["fast"])
APP_RUNS = {
    "app_mode0": (["--mode", "0"], dict(bilateral13=1, quality13=1,
                                        **PRE_LAUNCHES, **COMPACT_FUSE)),
    "app_mode1": (["--mode", "1"], MODE1_FRAME),
    "app_mode2": (["--mode", "2"], dict(bilateral13=1, quality13=1,
                                        **PRE_LAUNCHES, **COMPACT_FUSE)),
    "app_mode3": (["--mode", "3"], dict(bilateral13=2, quality13=1,
                                        **PRE_LAUNCHES, **COMPACT_FUSE)),
    "app_mode4": (["--mode", "4"], dict(bilateral13=1, quality13=1,
                                        **PRE_LAUNCHES, **COMPACT_FUSE)),
    "app_mode1_anaglyph": (["--mode", "1", "--stereo", "anaglyph"],
                           dict(bilateral13=1, quality13=1, surface_occ=2,
                                sentinel_bake=2,
                                march=2 * PATH_MARCHES["fast"],
                                **_plus({k: 2 * n for k, n in
                                         _plus(FILL_LAUNCHES, HIT_LAUNCHES,
                                               FAST_STAGES,
                                               FAST_BAKE).items()},
                                        COMPACT_FUSE),
                                **PRE_LAUNCHES)),
    "app_mode1_refine": (["--mode", "1", "--refine-every", "1"],
                         MODE1_FRAME),
}
# the line the app prints after each refinement
REFINE_LINE = "refined sensor poses; translation corrections (mm):"
# phase 9: the fast config's variants; the color variants (and the render
# without the fill) must leave the hit mask and the depth of the fast
# path's render bit-equal. 16 rounds past 10-voxel bricks take the plain
# bake (the JAX package's rule: its Pallas bake only when brick_vox >=
# skip_fine_rounds); 20 rounds in 20-voxel bricks take the kernel, in two
# dilation launches; without the pixel models the preprocess reads the
# calibration volumes, and its four calibration passes run their twins
VARIANTS = {
    "shade_mode_3": dict(shade_mode=3),
    "best_two": dict(blend_mode="best_two"),
    "normal_deviation": dict(blend_mode="normal_deviation"),
    "debug_skip": dict(debug_skip="blend,grad,refine"),
    "bracket_per_block": dict(bracket_per_block=True),
    "march_chunk": dict(march_chunk=8),
    "march_chunk_per_block": dict(march_chunk=8, bracket_per_block=True),
    "skip_fine_rounds_16": dict(skip_fine_rounds=16),
    "bricks_20_rounds_20": dict(brick_size=0.2, skip_fine_rounds=20),
    "colorfill_off": dict(colorfill=False),
    "pixel_ray_model_off": dict(pixel_ray_model=False),
}
COLOR_VARIANTS = ("shade_mode_3", "best_two", "normal_deviation",
                  "colorfill_off")
# phase 11 (scripts/validate_pose_ba.py): the drift of sensor 1, and what
# the refinement must reach: sensor 1's mean lookup error at most half its
# start, each other sensor's lookup moved by at most 0.5 mm. The JAX
# package recorded 18.4 -> 5.8 mm for sensor 1 and 0.0 for the others
# (pose_ba_validation.md).
POSE_DRIFT_DEG = 1.0
POSE_DRIFT_T = (0.018, 0.0, 0.008)
POSE_RECOVERY = 0.5
POSE_OTHERS_MM = 0.5
POSE_ITERS = 24
POSE_ROUNDS = 4
# phase 12: the shard counts of each path on this card; the sharded fast
# path's colour may differ from the single device's by at most
# SHARD_COLOR_TOL (its volume, hit mask and depth must be bit-equal); the
# sensor-sharded maps within tests/test_dist.py's tolerances (atol, with
# rtol 1e-4); the mesh form of refine_poses over 2 LM iterations within
# 3e-4 of the single-device poses (tests/test_dist.py); the brute-force
# inverter at tests/test_calibration.py:113's sizes, held to the kd-tree
# inverter at :140's tolerances
COMPACT_SHARDS = (8, 4)
DENSE_SHARDS = 4
PREPROCESS_SHARDS = (4, 2)
SHARD_COLOR_TOL = 1e-5
MAP_TOLS = {"depth": 1e-6, "quality": 1e-6, "silhouette": 1e-6,
            "normal": 1e-5, "lab": 2e-4}
MESH_POSE_SHARDS = 4
# phase 14: the worker's layouts (processes, shards each): the first on
# any machine, the second where each process can have a card of its own; a
# worker that runs longer than MP_TIMEOUT_S fails the phase
MP_LAYOUTS = ((2, 4), (4, 2))
MP_TIMEOUT_S = 300
# phase 15: the app's preview run, and the encoder's timing samples
PREVIEW_ARGS = ["--mode", "1"]
JPEG_SAMPLES = 5
# phase 16: timed calls a row of the measurement scripts (10 and 5 by
# their defaults; 3 keeps the phase within the script's time)
MEASURE_ITERS = 3
MESH_POSE_ITERS = 2
MESH_POSE_ATOL = 3e-4
INV_CV_RES = (40, 48, 40)
INV_RES = (16, 18, 16)


class _Tee:
    """A text stream that writes to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _max_abs_err(torch, got, want) -> float:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(float((g.to(torch.float32) - w.to(torch.float32)).abs().max())
               for g, w in zip(got, want))


def _bound(tensors, ops):
    """(least ms, what sets it) of a function that reads and writes
    ``tensors`` once each and does ``ops`` operations: the larger of the
    bytes over the card's memory rate and the operations over its f32
    rate."""
    return _bound_of(sum(t.numel() * t.element_size() for t in tensors), ops)


def _bound_of(nbytes, ops):
    """(least ms, what sets it) of ``nbytes`` moved and ``ops`` done."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _stencil_ops(torch, d, non_border, per_tap, per_kept, centres=None):
    """Operations of a 13x13 fold over the (N, H, W) map ``d`` with edge
    padding: ``per_tap`` on every tap of the pixels where the bool map
    ``centres`` holds (all pixels without it), ``per_kept`` more on each
    tap for which ``non_border(s)`` holds (the data decides how many)."""
    from rgbd_recon_tpu_torch.ops.stencil13 import KS, _edge_pad

    H, W = d.shape[1:]
    pad = _edge_pad(d, KS)
    kept = torch.zeros((), dtype=torch.int64, device=d.device)
    for dy in range(2 * KS + 1):
        for dx in range(2 * KS + 1):
            kept += non_border(pad[:, dy: dy + H, dx: dx + W]).sum()
    pixels = d.numel() if centres is None else int(centres.sum())
    return per_tap * pixels * (2 * KS + 1) ** 2 + per_kept * int(kept)


def _short_name(name: str) -> str:
    """A device activity's name without its return type, namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].removeprefix("void ").strip()


def _events_ms(torch, fn, flush):
    """``fn``'s device time per call between CUDA events: (cold ms, warm
    ms). Cold: a pair of events around each of DEVICE_ITERS calls, each
    after ``flush``; warm: one pair around the calls back to back. Each
    timed stretch is queued behind a spin of the card (SPIN_CYCLES a call)
    that outlasts the host's launches, so the events time the device's
    work and not the host's launch gaps."""
    torch.cuda.synchronize()
    pairs = []
    for _ in range(DEVICE_ITERS):
        torch.cuda._sleep(SPIN_CYCLES)
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    cold = sum(s.elapsed_time(e) for s, e in pairs) / DEVICE_ITERS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * DEVICE_ITERS)
    start.record()
    for _ in range(DEVICE_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return cold, start.elapsed_time(end) / DEVICE_ITERS


# set once torch.profiler has handed back TRACE_TRIES traces of a call with
# no device activity: it records nothing more in this process, so the
# later calls are timed between CUDA events at once
_PROFILER_LOST = []


def _device_ms(torch, fn, flush, keep=None):
    """``fn``'s own device time per call: (cold ms, warm ms, {activity:
    cold ms}, traces retaken). Cold: ``flush`` (which evicts the L2) before
    each of DEVICE_ITERS calls, its own activities left out; warm: the calls
    back to back. ``keep`` (a test of an activity's short name) leaves out
    the activities of ``fn`` it refuses (a copy that restores an input the
    kernel updates in place). Under torch.profiler, a trace that comes back
    with no device activity, or with fewer of the calls' activities than
    they launched, is taken again, at most TRACE_TRIES times in all, and
    counted in the fourth value. When none of them records them all, the
    times are taken between CUDA events (``_events_ms``, every activity of
    ``fn``), and the split names that timer in the place of the
    activities."""
    from torch.profiler import ProfilerActivity, profile

    from rgbd_recon_tpu_torch.bench.trace import device_us, on_device

    retakes = [0]

    def trace(body, complete=bool):
        # torch.profiler can hand back a trace with no device activity, or
        # one that lacks an activity, although the calls ran
        for i in range(TRACE_TRIES):
            retakes[0] += i > 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                body()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if on_device(e)]
            if complete(events):
                return events
        return None

    def by_events():
        if not _PROFILER_LOST:
            print("torch.profiler recorded no device activity in "
                  f"{TRACE_TRIES} traces of a call: device times from here "
                  "on are taken between CUDA events", flush=True)
            _PROFILER_LOST.append(True)
        cold, warm = _events_ms(torch, fn, flush)
        return cold, warm, {EVENTS_SPLIT: cold}, retakes[0]

    fn()
    if _PROFILER_LOST:
        return by_events()
    own = trace(fn)
    flushing = own and trace(flush)
    if not flushing:
        return by_events()
    names = {e.name for e in own}
    if names & {e.name for e in flushing}:
        raise AssertionError(f"the L2 flush runs a kernel of the timed call: "
                             f"{names}")
    if keep is not None:
        names = {n for n in names if keep(_short_name(n))}
        own = [e for e in own if e.name in names]
        if not names:
            raise AssertionError("keep refuses every activity of the call")

    def per_call(cold):
        def body():
            for _ in range(DEVICE_ITERS):
                if cold:
                    flush()
                fn()
        def timed(events):
            return [e for e in events if e.name in names]

        events = trace(body, lambda events: len(timed(events)) ==
                       DEVICE_ITERS * len(own))
        if events is None:
            return None
        split = {}
        for e in timed(events):
            key = _short_name(e.name)
            split[key] = split.get(key, 0.0) + device_us(e) / 1e3
        split = {k: v / DEVICE_ITERS for k, v in split.items()}
        total = sum(split.values())
        if not total > 0.0:
            raise AssertionError(f"the profiler reads no device time: {split}")
        return total, split

    cold = per_call(True)
    warm = cold and per_call(False)
    if not warm:
        return by_events()
    return cold[0], warm[0], cold[1], retakes[0]


# the activity name and source file of each render stage's kernel (the
# stages' dispatches and twins: rgbd_recon_tpu_torch/ops/stage_calls.py)
STAGE_KERNEL_OF = {
    "scan": ("scan_kernel", "render_stages.cu"),
    "block_setup": ("block_setup_kernel", "render_stages.cu"),
    "compact": ("compact_kernel", "compact.cu"),
    "march_grid": ("march_rows_kernel", "march.cu"),
    "bracket": ("bracket_kernel", "render_stages.cu"),
    "march_rows": ("march_rows_kernel", "march.cu"),
    "hit_gather": ("hit_gather_kernel", "render_stages.cu"),
    "compose": ("compose_kernel", "render_stages.cu"),
}
# the JAX package's code each new kernel replaces (no Pallas kernel: XLA
# ops of its jitted render_from_baked)
STAGE_REPLACES = {
    "compact": "rgbd_recon_tpu/recon/tsdf_pipeline.py:1292",
    "scan": "rgbd_recon_tpu/recon/tsdf_pipeline.py:920",
    "block_setup": "rgbd_recon_tpu/recon/tsdf_pipeline.py:1253",
    "bracket": "rgbd_recon_tpu/recon/tsdf_pipeline.py:1327",
    "hit_gather": "rgbd_recon_tpu/recon/tsdf_pipeline.py:1472",
    "compose": "rgbd_recon_tpu/recon/tsdf_pipeline.py:1521",
}
# f32 operations of one scan sample (the arc length, three axes' product,
# sum, scale, truncation, floor division and clamp, the index, the field's
# tests, the three selections and extremes) and of one scan ray beyond its
# samples (the direction, the slab test, the spacing), counted by hand
# from csrc/render_stages.cu; the other stages are bound by bytes
SCAN_SAMPLE_OPS = 34
SCAN_RAY_OPS = 60
# the fast config with 2,048 block slots (of the 8,780 active blocks), a
# 5-step first march (a tail list of a third of the 32,768 rays, where most
# rays are still short of the surface) and 32 hit slots (0.1%): it drops
# blocks, tail rays and hits
OVERFLOW_CONFIG = dict(ray_compaction=0.01, march_phase1_steps=5,
                       hit_compaction=0.001)


def _differing_err(torch, got, want) -> float:
    """max |got - want| over the entries whose bits differ (0.0 where all
    are bit-equal; infinities and NaNs of equal bits count 0)."""
    if got.shape != want.shape:
        return float("inf")
    if got.dtype != torch.float32:
        return (0.0 if torch.equal(got, want)
                else float((got.float() - want.float()).abs().max()))
    g = got.contiguous().view(torch.int32)
    w = want.contiguous().view(torch.int32)
    differ = g != w
    if not bool(differ.any()):
        return 0.0
    return float((got[differ] - want[differ]).abs().max())


def _stage_call(stage, args, kwargs, plain):
    """A function that runs ``stage``'s kernel (its dispatch on CUDA
    tensors) or twin on working copies of the recorded inputs, and those
    copies; a march that resumes listed rows in place restores them first,
    so every call does the recorded work."""
    import torch

    from rgbd_recon_tpu_torch.ops import stage_calls

    fn = stage_calls.stage_fn(stage, plain)
    a, kw = stage_calls.copy(args), stage_calls.copy(kwargs)
    if stage == "march_rows" and kw.get("ids") is not None:
        st0, fl0 = kw["st8"].clone(), kw["flags"].clone()

        def run():
            kw["st8"].copy_(st0)
            kw["flags"].copy_(fl0)
            return fn(*a, **kw)
    else:
        def run():
            return fn(*a, **kw)
    return run, (a, kw)


def _march_samples(torch, stage, args, kwargs):
    """(rays, samples, longest ray, hits) of a recorded row march, from its
    plain twin's state rows (the coarse march: from march_plain on the
    listed blocks' rows)."""
    from rgbd_recon_tpu_torch.ops import raymarch

    if stage == "march_grid":
        table, limit, steps, blk, ids, _ = args
        NB = blk.shape[0]
        rows = blk[torch.clamp_max(ids, NB - 1)]
        length = torch.where(ids < NB, rows[:, 6], 0.0)
        hit, num, _ = raymarch.march_plain(
            table, limit, steps, ((rows[:, 0], rows[:, 1], rows[:, 2]),
                                  length),
            (rows[:, 3], rows[:, 4], rows[:, 5]), **kwargs)
        return int((ids < NB).sum()), int(num.sum()), int(num.max()), int(
            hit.sum())
    run, _ = _stage_call(stage, args, kwargs, plain=True)
    st8, _ = run()
    before = kwargs["st8"][:, 7] if kwargs.get("ids") is not None else 0.0
    num = st8[:, 7] - before
    rays = (int((kwargs["ids"] < st8.shape[0]).sum())
            if kwargs.get("ids") is not None else st8.shape[0])
    return rays, int(num.sum()), int(num.max()), int((st8[:, 6] > 0.5).sum())


def _stage_bytes(stage, args, kwargs, out, march=None):
    """(bytes, operations) a stage call's data needs: each input element
    it reads once, each output written once (the bracket: the listed
    blocks' columns and their windows' grid cells; a march: the listed
    rays' rows and the table entries its samples read, MARCH_STEP_OPS a
    sample; the scan: SCAN_*_OPS)."""
    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    if stage == "compact":
        flags, _, cap, _, _ = args[:5]
        slot = out[1]
        return flags.numel() + cap * 8 + (nb(slot) if slot is not None
                                          else 0) + 4, 0
    if stage == "scan":
        g, occ, bsafe = args[:3]
        rays = g.Hs * g.Ws
        return (nb(occ, bsafe, out) + 4 + 48,
                rays * (SCAN_RAY_OPS + g.n_scan * SCAN_SAMPLE_OPS))
    if stage == "block_setup":
        return nb(args[1], *out) + 48, 0
    if stage == "bracket":
        # the listed blocks' interval columns (blk's length and start, the
        # interval end, the flags) and the grid cells of their 3x3 windows
        # (edge-padded, so inside the grid), padding reading block NB - 1
        import torch
        import torch.nn.functional as F

        g, grid, blk, s_end, flags, blk_idx = args[:6]
        NB = blk.shape[0]
        listed = torch.zeros(NB, dtype=torch.float32, device=blk.device)
        listed[torch.clamp_max(blk_idx, NB - 1)] = 1.0
        window = F.max_pool2d(listed.reshape(1, 1, g.Hb, g.Wb), 3, 1, 1)
        blocks, cells = int(listed.sum()), int(window.sum())
        return (nb(blk_idx, out) + blocks * (2 * 4 + 4 + 1)
                + cells * 3 * 4 + 48), 0
    if stage == "hit_gather":
        ray8, st8, hit_idx = args
        live = int((hit_idx < ray8.shape[0]).sum())
        return nb(hit_idx, *out) + live * (6 + 3) * 4, 0
    if stage == "compose":
        g, blk_slot, hit_slot = args[:3]
        listed = int((blk_slot >= 0).sum()) * g.B2
        hits = int((hit_slot >= 0).sum())
        return (nb(blk_slot, *out[:4]) + 16 + listed * (4 + 4)
                + hits * (16 + 4) + 5 * 4), 0
    # the row marches
    rays, samples, _, hits = march
    table = args[0]
    taps = 8 if kwargs.get("mode") == "trilinear" else 1
    entries = min(samples * taps, table.numel()) * table.element_size()
    ops = samples * MARCH_STEP_OPS[kwargs.get("mode", "nearest")]
    if stage == "march_grid":
        return entries + rays * (8 * 4 + 8) + hits * 3 * 4, ops
    resumed = kwargs.get("ids") is not None
    return (entries + rays * (7 * 4 + (4 * 4 + 8) * resumed + 8 * 4 + 1),
            ops)


def _time_stage(torch, stage, args, kwargs, flush):
    """(events ms, plain ms, device ms cold, warm, split, retakes) of the
    kernel of a recorded stage call, its device time counting its own
    activity only."""
    from rgbd_recon_tpu_torch.bench.trace import event_ms

    kern, _ = _stage_call(stage, args, kwargs, plain=False)
    plain, _ = _stage_call(stage, args, kwargs, plain=True)
    act = STAGE_KERNEL_OF[stage][0]
    ms = event_ms(kern, iters=20, warmup=3)
    plain_ms = event_ms(plain, iters=3, warmup=1)
    cold, warm, split, n = _device_ms(torch, kern, flush,
                                      keep=lambda name: act in name)
    return ms, plain_ms, cold, warm, split, n


def _render_host_split(torch, render_from_baked, args, reps=5):
    """The host ms of each part of render_from_baked (the stages, the
    hit kernels, the fill) and of the whole call, medians of ``reps``
    renders: a host clock around each part's call (no part waits for the
    device), the whole call ended by a synchronize. What is left is the
    render's own Python and allocations."""
    from rgbd_recon_tpu_torch.ops import hits, holefill, stage_calls

    parts = [(mod, name) for mod, name, _ in stage_calls.STAGES.values()]
    parts += [(hits, "refine_hits"), (hits, "shade_hits"),
              (holefill, "fill_colors_planar")]
    samples = {f"{m.__name__.rsplit('.', 1)[1]}.{n}": [] for m, n in parts}
    samples["render_from_baked"] = []
    saved = []
    for m, name in parts:
        fn = getattr(m, name)
        saved.append((m, name, fn))
        key = f"{m.__name__.rsplit('.', 1)[1]}.{name}"

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            acc[_key] = acc.get(_key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        setattr(m, name, timed)
    try:
        for _ in range(reps):
            acc = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_from_baked(*args)
            torch.cuda.synchronize()
            samples["render_from_baked"].append(
                (time.perf_counter() - t0) * 1e3)
            for k in acc:
                samples[k].append(acc[k])
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    med = {k: sorted(v)[len(v) // 2] for k, v in samples.items() if v}
    med["rest"] = med["render_from_baked"] - sum(
        v for k, v in med.items() if k != "render_from_baked")
    return med


def _render_vs_twins(torch, render, args, label, stages, marches):
    """render_from_baked(*args) on the kernels against it on the stage
    twins (the hit kernels and the fill run in both): hit mask, window
    depth, march steps, overflow, colour and the pre-fill rgba planes bit
    for bit; the stage kernels launched ``stages`` times and the march
    ``marches``. Returns the overflow vector."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.ops import holefill, stage_calls

    fills = []
    fill = holefill.fill_colors_planar

    def record_fill(planes, depth, lods):
        fills.append([q.clone() for q in planes])
        return fill(planes, depth, lods)

    holefill.fill_colors_planar = record_fill
    try:
        kernels.reset_launch_counts()
        got = render.render_from_baked(*args)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        with stage_calls.plain_stages():
            want = render.render_from_baked(*args)
        torch.cuda.synchronize()
    finally:
        holefill.fill_colors_planar = fill
    same = {f: _bits_equal(torch, getattr(got, f), getattr(want, f))
            for f in ("hit", "depth", "num_samples", "overflow", "color")}
    same["prefill_planes"] = all(
        _bits_equal(torch, g.contiguous(), w.contiguous())
        for g, w in zip(fills[0], fills[1]))
    stage_launches = {k: launched[k] for k in stages}
    overflow = got.overflow.tolist()
    print(f"render_from_baked {label}: the kernels' render bit-equal to the "
          f"twins' {same}; {int(got.hit.sum())} hits; overflow {overflow} "
          f"(int32 {got.overflow.dtype == torch.int32}); stage launches "
          f"{stage_launches}, march {launched['march']}", flush=True)
    if (not all(same.values()) or stage_launches != stages
            or launched["march"] != marches
            or got.overflow.dtype != torch.int32):
        raise AssertionError(f"render_from_baked {label}: {same}, launches "
                             f"{launched}")
    return overflow


def _phase3_render(torch, pipe, frames, camera, card, flush):
    """The render's stage kernels (csrc/compact.cu, csrc/render_stages.cu,
    csrc/march.cu's row march) on the inputs one fast and one parity frame
    hand each stage: each call bit-equal to its plain twin (every output
    and every array updated in place), timed (events, device time with a
    cold and a warm L2 counting its own activity, the plain version)
    beside its bound; the whole render_from_baked on the kernels bit-equal
    to it on the twins (hit mask, window depth, march steps, overflow,
    pre-fill planes, colour), free of host syncs under
    torch.cuda.set_sync_debug_mode("error"), its launches counted and its
    host ms split by part. Each compaction also runs its one-call library
    counterpart (torch.nonzero_static, bench/kernel_inputs.py) on its flags,
    list against list; then both run on synthetic flags at 184,320,
    1,658,880 and 8,294,400 (kernel_inputs.compact_scaling). Returns the
    JSON rows of the march and of the six stage kernels: the fast frame's
    calls summed, the parity frame's under "parity", each call under
    "calls" (the compaction's scaling under "scaling"). Last,
    OVERFLOW_CONFIG's render on the kernels against the twins: its
    overflow vector must drop blocks, tail rays and hits."""
    from rgbd_recon_tpu_torch.bench import kernel_inputs
    from rgbd_recon_tpu_torch.bench.hit_gather_variants import sector_bytes
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.kernels.render_stages import (
        block_setup_plan,
        bracket_plan,
        hit_gather_plan,
        scan_plan,
    )
    from rgbd_recon_tpu_torch.ops import stage_calls
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    ppipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity"]), pipe.bbox)
    names = ("march", *STAGE_KERNELS)
    sums = {n: {} for n in names}
    calls_out = {n: [] for n in names}
    errs = {n: 0.0 for n in names}
    retakes = 0
    for path, p in (("fast", pipe), ("parity", ppipe)):
        render, cam = p.make_render_fn(camera)
        volume, maps, counts = p.fuse(frames)
        baked = render.bake(volume, counts)
        args = (baked, maps, cam, p._get_projection_models(), p._limit)
        render.render_from_baked(*args)           # warm-up: fits the models
        calls = stage_calls.record_stages(
            lambda: render.render_from_baked(*args))
        torch.cuda.synchronize()
        marches = [c for c in calls if c[0].startswith("march")]
        if len(marches) != PATH_MARCHES[path]:
            raise AssertionError(f"{path} frame: {len(marches)} marches, "
                                 f"expected {PATH_MARCHES[path]}")
        labels = iter(MARCH_STAGES[path])
        per = {n: dict(ms=0.0, plain_ms=0.0, device_ms=0.0,
                       device_ms_warm=0.0, bytes=0, ops=0, calls=0)
               for n in names}
        for stage, a, kw, _ in calls:
            kern, (ka, kkw) = _stage_call(stage, a, kw, plain=False)
            plain, (pa, pkw) = _stage_call(stage, a, kw, plain=True)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            same = (stage_calls.all_bits_equal(got, want)
                    and stage_calls.all_bits_equal((ka, kkw), (pa, pkw)))
            err = max([_differing_err(torch, g, w) for g, w in zip(
                stage_calls.tensors((got, ka, kkw)),
                stage_calls.tensors((want, pa, pkw)))
                if g.is_floating_point()] or [0.0])
            name = "march" if stage.startswith("march") else stage
            label = next(labels) if name == "march" else stage
            if not same:
                raise AssertionError(f"{name} {path}/{label}: the kernel "
                                     f"differs from its twin (max abs "
                                     f"error {err})")
            errs[name] = max(errs[name], err)
            march = (_march_samples(torch, stage, a, kw) if name == "march"
                     else None)
            nbytes, ops = _stage_bytes(stage, a, kw, want, march)
            ms, plain_ms, cold, warm, split, n = _time_stage(
                torch, stage, a, kw, flush)
            retakes += n
            bound_ms, bound_by = _bound_of(nbytes, ops)
            row = dict(path=path, stage=label, max_abs_err=err,
                       bit_equal=True, ms=ms, plain_ms=plain_ms,
                       device_ms=cold, device_ms_warm=warm,
                       device_split=split, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       share_of_bound=bound_ms / cold)
            if stage == "scan":
                # blocks, threads, lanes a ray, the staged brick table
                row["launch"] = scan_plan(a[0], a[1].shape, a[1].device)
            if stage == "block_setup":
                # tiles across and down, the thread block (the block's
                # column and row in its tile), static shared bytes
                row["launch"] = block_setup_plan(a[0])
            if stage == "bracket":
                # blocks, the thread block (ray column, row, slot), shared
                row["launch"] = bracket_plan(a[0], a[5].shape[0])
            if stage == "hit_gather":
                # blocks, threads (a slot each); the bytes it moves
                # counted in 32-byte sectors
                row["launch"] = hit_gather_plan(a[2].numel())
                row["sector_bytes"] = sector_bytes(*a, want)
            if stage == "compact":
                lib_name, lib = kernel_inputs.library_compact(
                    torch, *a[:3], ids=want[0])
                row.update(library=lib_name,
                           library_ms=event_ms(lib, iters=20, warmup=3),
                           library_events_cold_ms=_events_ms(
                               torch, lib, flush)[0])
                for k in ("library_ms", "library_events_cold_ms"):
                    per[name][k] = per[name].get(k, 0.0) + row[k]
            if march is not None:
                row.update(rays=march[0], samples=march[1],
                           longest_ray=march[2], hits=march[3],
                           max_steps=a[2], mode=kw.get("mode"),
                           table=str(a[0].dtype),
                           resumed=kw.get("ids") is not None)
            calls_out[name].append(row)
            for k in ("ms", "plain_ms", "device_ms", "device_ms_warm",
                      "bytes", "ops"):
                per[name][k] += row[k]
            per[name]["calls"] += 1
            print(f"{name} {path}/{label}: bit-equal to its twin (max abs "
                  f"error {err!r}); {ms!r} ms (events; plain {plain_ms!r}), "
                  f"device {cold!r} ms cold L2, {warm!r} warm, bound "
                  f"{bound_ms!r} ms by {bound_by} ({nbytes} B, {ops} ops), "
                  f"{bound_ms / cold:.1%} of it"
                  + (f"; {march[0]} rays, {march[1]} samples, longest "
                     f"{march[2]}, {march[3]} hits" if march else "")
                  + (f"; {row['library']} {row['library_ms']!r} ms (events)"
                     f", {row['library_events_cold_ms']!r} ms cold "
                     "(events)"
                     if "library" in row else "")
                  + (f"; launch {row['launch']}" if "launch" in row else "")
                  + (f"; {row['sector_bytes']} B in 32-byte sectors"
                     if "sector_bytes" in row else "")
                  + f", on {card}", flush=True)
            del kern, plain, got, want, ka, kkw, pa, pkw
        for name in names:
            r = per[name]
            r["bound_ms"], r["bound_by"] = _bound_of(r["bytes"], r["ops"])
            r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
            sums[name][path] = r
            print(f"{name}, the {path} frame's {r['calls']} calls: {r} on "
                  f"{card}", flush=True)

        # the whole render on the kernels against it on the twins
        _render_vs_twins(torch, render, args, path, PATH_STAGES[path],
                         PATH_MARCHES[path])
        # no host sync between the bake and the fill's end
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            render.render_from_baked(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        split = _render_host_split(torch, render.render_from_baked, args)
        print(f"render_from_baked {path}: no host sync under "
              "set_sync_debug_mode('error'); host ms by part (medians of 5, "
              f"host clock) {split} on {card}", flush=True)
        sums["march"].setdefault("host_split", {})[path] = split
        del volume, maps, counts, baked, args, calls
    # the compaction and its library call at the cells' size and past it
    scaling = kernel_inputs.compact_scaling(
        torch, lambda fn: _events_ms(torch, fn, flush), torch.device("cuda"))
    for r in scaling:
        print(f"compact at {r['n']} flags (capacity {r['capacity']}, slot "
              f"map {r['slot']}): bit-equal to compact_plain; "
              f"{r['events_cold_ms']!r} ms cold, {r['events_warm_ms']!r} "
              f"warm (events); {r['library']} "
              f"{r['library_events_cold_ms']!r} cold, "
              f"{r['library_events_warm_ms']!r} warm; growth from the size "
              "before "
              f"{r.get('growth')} ({r['library']} {r.get('library_growth')})"
              f" for n x {r.get('n_growth')}, on {card}", flush=True)
    # a configuration that overflows the block list, a tail stage's list
    # and the hit list: the overflow vector on the kernels equal to the
    # twins'
    opipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **OVERFLOW_CONFIG), pipe.bbox)
    render, cam = opipe.make_render_fn(camera)
    volume, maps, counts = opipe.fuse(frames)
    args = (render.bake(volume, counts), maps, cam,
            opipe._get_projection_models(), opipe._limit)
    render.render_from_baked(*args)               # warm-up
    overflow = _render_vs_twins(torch, render, args, "overflow",
                                PATH_STAGES["fast"], PATH_MARCHES["fast"])
    if not all(n > 0 for n in overflow[:3]):
        raise AssertionError(f"the overflow config dropped {overflow}: "
                             "not each of blocks, tail rays and hits")
    print(f"overflow config {OVERFLOW_CONFIG}: blocks, tail rays and hits "
          f"dropped {overflow[:3]}", flush=True)
    del ppipe, opipe, render, volume, maps, counts, args
    torch.cuda.empty_cache()
    out = []
    for name in names:
        fast = sums[name]["fast"]
        src = ("march.cu" if name == "march"
               else STAGE_KERNEL_OF[name][1])
        row = dict(
            name=name, route="cuda",
            source=f"rgbd_recon_tpu_torch/csrc/{src}",
            replaces=("rgbd_recon_tpu/ops/raymarch.py:501" if name == "march"
                      else STAGE_REPLACES[name]),
            max_abs_err=errs[name], ms=fast["ms"], plain_ms=fast["plain_ms"],
            device_ms=fast["device_ms"],
            device_ms_warm=fast["device_ms_warm"],
            bound_ms=fast["bound_ms"], bound_by=fast["bound_by"],
            share_of_bound=fast["share_of_bound"],
            library_ms=fast.get("library_ms"),
            parity=sums[name]["parity"], calls=calls_out[name],
            trace_retakes=retakes)
        if name == "march":
            row["host_split"] = sums["march"]["host_split"]
        if name in ("scan", "block_setup", "bracket", "hit_gather"):
            row["launch"] = calls_out[name][0]["launch"]
        if name == "compact":
            row.update(library=calls_out[name][0]["library"],
                       library_events_cold_ms=fast[
                           "library_events_cold_ms"],
                       scaling=scaling)
        out.append(row)
    return out


def _record_fills(torch, render_frame):
    """The arguments of every fill one render makes: [(the (4, H, W)
    pre-fill planes, its window depth, num_lods)], copies of what
    ``ops.holefill.fill_colors_planar`` received (the render calls it
    through the module and passes the rows of compose's (4, H, W)
    planes)."""
    from rgbd_recon_tpu_torch.ops import holefill

    calls, fill = [], holefill.fill_colors_planar

    def record(planes0, depth0, num_lods=7):
        calls.append((torch.stack(list(planes0)), depth0.clone(),
                      num_lods))
        return fill(planes0, depth0, num_lods)

    holefill.fill_colors_planar = record
    try:
        render_frame()
        torch.cuda.synchronize()
    finally:
        holefill.fill_colors_planar = fill
    return calls


def _fill_pull_one_level_bytes(levels):
    """Bytes a pull of one level a launch needs on its data: at each level
    below the last, alpha and depth once, r, g, b at the texels with
    alpha > 0 (no other colour can be kept), and the 5 planes of the
    level above written once. The bound the one-level design was held
    to, kept beside the tiled pull's so that the two rows compare."""
    nbytes = 0
    for below, above in zip(levels, levels[1:]):
        valid = int((below[3] > 0.0).sum())
        nbytes += 4 * (2 * below[3].numel() + 3 * valid + 5 * above[0].numel())
    return nbytes


def _fill_pull_bytes(levels):
    """Bytes the tiled pull needs on its data: at the input level of each
    launch (every second level below the last, from LOD 0) alpha and
    depth once and r, g, b at the texels with alpha > 0; every level past
    LOD 0 written once (a launch's inner level is not read back)."""
    nbytes = sum(4 * 5 * lv[0].numel() for lv in levels[1:])
    for lv in levels[:-1:2]:
        valid = int((lv[3] > 0.0).sum())
        nbytes += 4 * (2 * lv[3].numel() + 3 * valid)
    return nbytes


def _fill_push_bytes(level, levels):
    """Bytes the push needs on its data: LOD 0 alpha once, r, g, b of the
    pixels that keep level 0, the r, g, b, alpha planes of every coarser
    level once, and the 4 output planes written once."""
    n = level.numel()
    kept = int((level == 0).sum())
    coarse = sum(4 * lv[0].numel() for lv in levels[1:])
    return 4 * (n + 3 * kept + coarse + 4 * n)


def _phase3_fill(torch, pipe, camera, frames, card, flush):
    """The fill kernels on the recorded pre-fill planes of one fast and one
    parity frame (contiguous, as the render passes them): each pull level
    bit-equal to ``_pull_planar``, the push's level bit-equal and its
    colours within FILL_COLOR_ATOL of ``_push_planar``, the whole fill
    within FILL_COLOR_ATOL of ``fill_colors_plain``; the pull chain, the
    push and the whole fill timed (events, device time with a cold and a
    warm L2, the plain versions) beside their bounds by bytes. The same
    planes a float off 16 bytes and as the strided views of an (H, W, 4)
    image (as the dense render passes them): every level and the fill
    bit-equal to the contiguous run's, the pull's device time by layout.
    Returns the two kernels' JSON rows: the fast frame's figures, the
    parity frame's under "parity"."""
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.kernels.holefill import pull_cuda, push_cuda
    from rgbd_recon_tpu_torch.ops import holefill
    from rgbd_recon_tpu_torch.ops import stage_calls
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    ppipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity"]), pipe.bbox)
    rows = {"holefill_pull": {}, "holefill_push": {}}
    errs = {"holefill_pull": 0.0, "holefill_push": 0.0}
    retakes = 0
    for path, p in (("fast", pipe), ("parity", ppipe)):
        render = p.make_renderer(camera)
        volume, maps, counts = p.fuse(frames)
        render(volume, maps, counts)        # warm-up: fits the models
        calls = _record_fills(torch, lambda: render(volume, maps, counts))
        if len(calls) != 1:
            raise AssertionError(f"{path} frame: {len(calls)} fills")
        rgba, depth, lods = calls[0]
        views = list(rgba)
        colors, depths = holefill._build_pyramid_planar(views, depth, lods)
        n = len(colors)
        if holefill.pull_launches(n) != FILL_LAUNCHES["holefill_pull"]:
            raise AssertionError(f"{path}: {n} levels")
        # each pull level bit for bit: along the kernel's own chain, and
        # from each of the twin's levels (the launch of the next two)
        levels = pull_cuda([*views, depth], n - 1)
        pull_err, differ = 0.0, []
        for l in range(1, n):
            got = pull_cuda([*colors[l - 1], depths[l - 1]], min(2, n - l))
            torch.cuda.synchronize()
            pairs = [("chain", l, levels[l - 1])] + [
                (f"from {l - 1}", l + k, g) for k, g in enumerate(got)]
            for how, at, g in pairs:
                want = [*colors[at], depths[at]]
                for name, gp, w in zip("rgbad", g, want):
                    if not torch.equal(gp.view(torch.int32),
                                       w.view(torch.int32)):
                        differ.append((how, at, name))
                pull_err = max(pull_err, _max_abs_err(torch, tuple(g),
                                                      tuple(want)))
        if differ:
            raise AssertionError(f"holefill_pull {path}: (launch, level, "
                                 f"plane) {differ} differ from "
                                 f"_pull_planar's (max abs error {pull_err})")

        def pulls(views=views, depth=depth):
            return pull_cuda([*views, depth], n - 1)

        # the pull's device time by launch: each launch from the kernel's
        # own level below it
        by_launch = []
        for l in range(0, n - 1, 2):
            src = [*views, depth] if l == 0 else list(levels[l - 1])
            dev_ms = _device_ms(torch, lambda src=src, k=min(2, n - 1 - l):
                                pull_cuda(src, k), flush)
            retakes += dev_ms[3]
            by_launch.append(dict(levels=(l + 1, min(l + 2, n - 1)),
                                  device_ms=dev_ms[0],
                                  device_ms_warm=dev_ms[1]))
        print(f"holefill_pull {path}: device ms by launch (cold; warm) "
              + ", ".join(f"levels {b['levels']} {b['device_ms']!r}; "
                          f"{b['device_ms_warm']!r}" for b in by_launch)
              + f", on {card}", flush=True)
        got, level = push_cuda(views, levels, return_level=True)
        want, _ = holefill._push_planar(colors, depths)
        _, want_level = holefill._push_level(colors, *depth.shape)
        torch.cuda.synchronize()
        push_err = _max_abs_err(torch, tuple(got), tuple(want))
        same_level = torch.equal(level, want_level)
        filled, fdepth = holefill.fill_colors_planar(views, depth, lods)
        plain, _ = holefill.fill_colors_plain(views, depth, lods)
        fill_err = _max_abs_err(torch, tuple(filled), tuple(plain))
        if (not same_level or not push_err <= FILL_COLOR_ATOL
                or not fill_err <= FILL_COLOR_ATOL or fdepth is not depth):
            raise AssertionError(f"holefill_push {path}: level bit-equal "
                                 f"{same_level}, max|kernel - plain| "
                                 f"{push_err} (push), {fill_err} (fill)")
        errs["holefill_pull"] = max(errs["holefill_pull"], pull_err)
        errs["holefill_push"] = max(errs["holefill_push"], push_err,
                                    fill_err)
        # the planes contiguous, a float off 16 bytes, and as the (H, W, 4)
        # image's strided views: the same bits, the pull's time on each
        off = torch.empty(rgba.numel() + 1, device=rgba.device)[1:]
        off = off.view(rgba.shape).copy_(rgba)
        img = rgba.permute(1, 2, 0).contiguous()
        by_layout = {}
        for how, planes in (("contiguous", views), ("off_16_bytes", list(off)),
                            ("hw4_views", list(img.permute(2, 0, 1)))):
            got_levels = pull_cuda([*planes, depth], n - 1)
            got_fill, _ = holefill.fill_colors_planar(planes, depth, lods)
            torch.cuda.synchronize()
            if not (all(_bits_equal(torch, g, w)
                        for g, w in zip(got_levels, levels))
                    and all(_bits_equal(torch, g, w)
                            for g, w in zip(got_fill, filled))):
                raise AssertionError(f"holefill {path}: the {how} planes' "
                                     "levels or fill differ from the "
                                     "contiguous planes'")
            dev_ms = _device_ms(torch, lambda planes=planes: pull_cuda(
                [*planes, depth], n - 1), flush)
            retakes += dev_ms[3]
            by_layout[how] = dict(device_ms=dev_ms[0],
                                  device_ms_warm=dev_ms[1])
        print(f"holefill_pull {path}: device ms by the planes' layout (cold; "
              "warm; bit-equal) " + ", ".join(
                  f"{how} {b['device_ms']!r}; {b['device_ms_warm']!r}"
                  for how, b in by_layout.items()) + f", on {card}",
              flush=True)
        del off, img
        levels_by_twin = [[*c, d] for c, d in zip(colors, depths)]
        hist = torch.bincount(level.reshape(-1).long(),
                              minlength=len(colors)).tolist()
        work = {
            "holefill_pull": (pulls, lambda: holefill._build_pyramid_planar(
                views, depth, lods), _fill_pull_bytes(levels_by_twin),
                pull_err),
            "holefill_push": (lambda: push_cuda(views, levels),
                              lambda: holefill._push_planar(colors, depths),
                              _fill_push_bytes(level, levels_by_twin),
                              push_err),
        }
        for name, (kern, plain_fn, nbytes, err) in work.items():
            ms = event_ms(kern, iters=20, warmup=3)
            plain_ms = event_ms(plain_fn, iters=3, warmup=1)
            device_ms, device_ms_warm, split, tries = _device_ms(
                torch, kern, flush)
            retakes += tries
            bound_ms, bound_by = _bound_of(nbytes, 0)
            rows[name][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                device_ms=device_ms, device_ms_warm=device_ms_warm,
                device_split=split, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, share_of_bound=bound_ms / device_ms)
            print(f"{name} {path}: max|kernel - plain| {err!r} (bound "
                  f"{0.0 if name == 'holefill_pull' else FILL_COLOR_ATOL}); "
                  f"{ms!r} ms (events; plain {plain_ms!r}), device "
                  f"{device_ms!r} ms cold L2, {device_ms_warm!r} warm "
                  f"{split}, bound {bound_ms!r} ms by bytes ({nbytes} B), "
                  f"{bound_ms / device_ms:.1%} of it, on {card}", flush=True)
        one = _fill_pull_one_level_bytes(levels_by_twin)
        one_ms = _bound_of(one, 0)[0]
        pull_row = rows["holefill_pull"][path]
        pull_row.update(device_ms_by_launch=by_launch,
                        device_ms_by_layout=by_layout,
                        one_level_bytes=one, one_level_bound_ms=one_ms,
                        share_of_one_level_bound=one_ms
                        / pull_row["device_ms"])
        print(f"holefill_pull {path}: the one-level launches' bound (the "
              f"inner levels read back) {one} B, {one_ms!r} ms at the HBM "
              f"rate, {one_ms / pull_row['device_ms']:.1%} of it",
              flush=True)

        def fill(views=views, depth=depth, lods=lods):
            return holefill.fill_colors_planar(views, depth, lods)

        fill_ms = event_ms(fill, iters=20, warmup=3)
        fill_plain_ms = event_ms(lambda: holefill.fill_colors_plain(
            views, depth, lods), iters=3, warmup=1)
        fill_dev, fill_dev_warm, fill_split, tries = _device_ms(
            torch, fill, flush)
        retakes += tries
        # the fill's device activities are its 4 kernels: no copy (the
        # push's taps were uploaded once, at the first fill of this shape)
        if EVENTS_SPLIT not in fill_split and {
                k.split("<", 1)[0] for k in fill_split} != FILL_ACTIVITIES:
            raise AssertionError(f"fill {path}: device activities "
                                 f"{fill_split}")
        fill_bound = _bound_of(4 * (5 + 4) * depth.numel(), 0)[0]
        rows["holefill_push"][path].update(
            pixels_by_level=hist, fill_ms=fill_ms,
            fill_plain_ms=fill_plain_ms, fill_device_ms=fill_dev,
            fill_device_ms_warm=fill_dev_warm, fill_device_split=fill_split,
            fill_max_abs_err=fill_err)
        print(f"fill {path}: {tuple(depth.shape)} at {lods} LODs, pixels by "
              f"level {hist}; the whole fill {fill_ms!r} ms (events; plain "
              f"{fill_plain_ms!r}), device {fill_dev!r} ms cold L2, "
              f"{fill_dev_warm!r} warm {fill_split}, max|fill - plain| "
              f"{fill_err!r}; its inputs and outputs once {fill_bound!r} ms "
              f"at the HBM rate, on {card}", flush=True)
        del volume, maps, counts, calls, levels, colors, depths
    del ppipe
    torch.cuda.empty_cache()
    out = []
    for name, by_path in rows.items():
        row = dict(name=name, route="cuda",
                   source="rgbd_recon_tpu_torch/csrc/holefill.cu",
                   replaces=("rgbd_recon_tpu/ops/holefill.py:56"
                             if name == "holefill_pull"
                             else "rgbd_recon_tpu/ops/holefill.py:223"),
                   library_ms=None)
        row.update(by_path["fast"], max_abs_err=errs[name],
                   parity=by_path["parity"], trace_retakes=retakes)
        out.append(row)
    return out


def _record_hits(torch, render_frame):
    """{"refine": (args, kwargs), "shade": (args, kwargs)} as one render
    called ``ops.hits.refine_hits`` and ``shade_hits`` (the pipeline calls
    them through the module, so the recorder sees both)."""
    from rgbd_recon_tpu_torch.ops import hits

    calls, fns = {}, {"refine": hits.refine_hits, "shade": hits.shade_hits}

    def recorder(key):
        def record(*args, **kwargs):
            calls[key] = (args, kwargs)
            return fns[key](*args, **kwargs)
        return record

    hits.refine_hits, hits.shade_hits = (recorder("refine"),
                                         recorder("shade"))
    try:
        render_frame()
        torch.cuda.synchronize()
    finally:
        hits.refine_hits, hits.shade_hits = fns["refine"], fns["shade"]
    return calls


def _bits_equal(torch, got, want) -> bool:
    """Same shape, type and bits (float32 compared as int32)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == torch.float32:
        return torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32))
    return torch.equal(got, want)


def _touched_bytes(torch, fn, tables):
    """Bytes of the entries of ``tables`` ({name: (f32 tensor, bytes an
    entry)}) that ``fn(leaves)``'s outputs depend on: the entries of
    nonzero gradient of the outputs' sum, each counted once. A lower bound
    of what a kernel must read: an entry read only to be compared, or
    weighted by zero, counts nothing."""
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, (t, _) in tables.items()}
    with torch.enable_grad():
        outs = fn(leaves)
        sum(o.sum() for o in outs).backward()
    return {k: 0 if leaves[k].grad is None
            else int((leaves[k].grad != 0).sum()) * size
            for k, (_, size) in tables.items()}


def _refine_work(torch, args, kwargs):
    """(bytes, the touched table bytes, confirmed hits) of one hit_refine
    on the recorded hits, by what each hit's result needs: the live byte
    read and the position (3 f32) written, every hit; the march's position
    (3 f32) read where it is the result (a hit not live, or live and its
    crossing not confirmed); the ray and bracket (8 f32) read for a live
    hit; the table entries the refined positions depend on
    (``_touched_bytes``). A confirmed hit is one whose result is not the
    march's position: finite where the twin is given NaN positions."""
    from rgbd_recon_tpu_torch.ops import hits

    hit, hit_pos = args[4], args[5]
    n, live = hit.shape[0], int(hit.sum())
    nan_pos = torch.full_like(hit_pos, float("nan"))
    confirmed = int(torch.isfinite(hits.refine_hits_plain(
        *args[:5], nan_pos, *args[6:], **kwargs)).all(dim=-1).sum())
    oct = kwargs.get("oct")
    table = oct.rows if oct is not None else kwargs["table"]

    def refine(leaves):
        kw = dict(kwargs)
        if oct is not None:
            kw["oct"] = dataclasses.replace(oct, rows=leaves["table"])
        else:
            kw["table"] = leaves["table"]
        return (hits.refine_hits_plain(*args, **kw),)

    touched = _touched_bytes(torch, refine, {
        "table": (table.float(), table.element_size())})
    nbytes = (n * (1 + 3 * 4) + (n - confirmed) * 3 * 4 + live * 8 * 4
              + touched["table"])
    return nbytes, touched, confirmed


def _shade_work(torch, args, kwargs):
    """(bytes, the touched bytes by table, the normal's and blend's names)
    of one hit_shade on the recorded hits: the live byte read and rgba and
    window depth (5 f32) written, every hit; the position (3 f32) read, a
    live hit; the entries of the tables and maps the outputs depend on
    (``_touched_bytes``: the oct or march table, the colour map read as
    f32, depth and quality, the calibration volumes), the projection
    models and the camera whole."""
    from rgbd_recon_tpu_torch.ops import hits

    (config, calib, bbox, hit, hit_pos, maps, models, cam, near, far, limit,
     table, floor, oct) = args
    n, live = hit.shape[0], int(hit.sum())
    tab = oct.rows if oct is not None else table
    tables = {"table": (tab.float(), tab.element_size()),
              "color": (maps.color, 4), "depth": (maps.depth, 4),
              "quality": (maps.quality, 4)}
    if models is None:
        tables.update(cv_xyz_inv=(calib.cv_xyz_inv, 4),
                      cv_uv=(calib.cv_uv, 4))

    def shade(leaves):
        m = dataclasses.replace(maps, color=leaves["color"],
                                depth=leaves["depth"],
                                quality=leaves["quality"])
        c = calib
        if models is None:
            c = dataclasses.replace(calib, cv_xyz_inv=leaves["cv_xyz_inv"],
                                    cv_uv=leaves["cv_uv"])
        o, t = oct, leaves["table"]
        if oct is not None:
            o, t = dataclasses.replace(oct, rows=leaves["table"]), table
        return hits.shade_hits_plain(config, c, bbox, hit, hit_pos, m,
                                     models, cam, near, far, limit, t, floor,
                                     o)

    touched = _touched_bytes(torch, shade, tables)
    small = (0 if models is None else sum(
        getattr(models, f.name).numel() * 4
        for f in dataclasses.fields(models)))
    nbytes = (n * (1 + 5 * 4) + live * 3 * 4 + sum(touched.values()) + small
              + 15 * 4)
    k = hits.shade_kernel_args(*args, **kwargs)
    return nbytes, touched, k["normal"], k["blend"]


def _phase3_hits(torch, pipe, camera, frames, card, flush):
    """The hit kernels on the hit sets one fast and one parity frame hand
    to ops.hits.refine_hits and shade_hits: the refined positions bit-equal
    to refine_hits_plain; shade_hits_plain in modes 0, 1 and 2 (mode 0's
    rgba bit-equal, the window depth and modes 1-2 within HIT_ATOL; each
    bit-equal flag printed); each kernel timed (events, device time with a
    cold and a warm L2, the plain version) beside its bound (the bytes its
    data needs, ``_refine_work`` / ``_shade_work``). Returns the two
    kernels' JSON rows: the fast frame's figures, the parity frame's under
    "parity"."""
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.kernels.hits import (
        input_rows,
        refine_cuda,
        refine_plan,
        shade_cuda,
        shade_plan,
    )
    from rgbd_recon_tpu_torch.ops import hits
    from rgbd_recon_tpu_torch.ops import stage_calls
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    ppipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity"]), pipe.bbox)
    rows = {"hit_refine": {}, "hit_shade": {}}
    errs = {"hit_refine": 0.0, "hit_shade": 0.0}
    retakes = 0
    for path, p in (("fast", pipe), ("parity", ppipe)):
        render = p.make_renderer(camera)
        volume, maps, counts = p.fuse(frames)
        render(volume, maps, counts)        # warm-up: fits the models
        calls = _record_hits(torch, lambda: render(volume, maps, counts))
        if set(calls) != {"refine", "shade"}:
            raise AssertionError(f"{path} frame: hit path calls {set(calls)}")
        rargs, rkw = calls["refine"]
        sargs, skw = calls["shade"]
        hit = rargs[4]
        skernel = hits.shade_kernel_args(*sargs, **skw)
        # the refine, bit for bit
        got = refine_cuda(*rargs, **rkw)
        want = hits.refine_hits_plain(*rargs, **rkw)
        torch.cuda.synchronize()
        r_err = _max_abs_err(torch, got, want)
        if not _bits_equal(torch, got, want):
            raise AssertionError(f"hit_refine {path}: differs from "
                                 f"refine_hits_plain (max abs error {r_err})")
        moved = int((want != rargs[5]).any(dim=-1).sum())
        # the shade in modes 0, 1, 2
        modes = {}
        for mode in (0, 1, 2):
            margs = (dataclasses.replace(sargs[0], shade_mode=mode),
                     *sargs[1:])
            g_rgba, g_depth = shade_cuda(**hits.shade_kernel_args(*margs,
                                                                  **skw))
            w_rgba, w_depth = hits.shade_hits_plain(*margs, **skw)
            torch.cuda.synchronize()
            modes[mode] = dict(
                rgba_bit_equal=_bits_equal(torch, g_rgba, w_rgba),
                depth_bit_equal=_bits_equal(torch, g_depth, w_depth),
                rgba_max_abs_err=_max_abs_err(torch, g_rgba, w_rgba),
                depth_max_abs_err=_max_abs_err(torch, g_depth, w_depth))
            m = modes[mode]
            ok = (m["depth_max_abs_err"] <= HIT_ATOL
                  and _bits_equal(torch, g_rgba[:, 3], w_rgba[:, 3])
                  and (m["rgba_bit_equal"] if mode == 0
                       else m["rgba_max_abs_err"] <= HIT_ATOL))
            print(f"hit_shade {path} mode {mode}: {m}", flush=True)
            if not ok:
                raise AssertionError(f"hit_shade {path} mode {mode}: {m}")
        s_err = max(max(m["rgba_max_abs_err"], m["depth_max_abs_err"])
                    for m in modes.values())
        errs["hit_refine"] = max(errs["hit_refine"], r_err)
        errs["hit_shade"] = max(errs["hit_shade"], s_err)
        r_bytes, r_touched, confirmed = _refine_work(torch, rargs, rkw)
        s_bytes, s_touched, normal, blend = _shade_work(torch, sargs, skw)
        variant = dict(
            hits=int(hit.numel()), live=int(hit.sum()),
            sensors=int(maps.color.shape[0]), normal=normal, blend=blend,
            refine=("oct" if rkw.get("oct") is not None else "table")
            + (f", widened K = {rkw['widen_samples']}"
               if rkw.get("oct") is not None and rkw.get("widen_steps", 0) > 0
               else ""),
            table=str((rkw.get("oct").rows if rkw.get("oct") is not None
                       else rkw["table"]).dtype))
        work = {
            "hit_refine": (lambda: refine_cuda(*rargs, **rkw),
                           lambda: hits.refine_hits_plain(*rargs, **rkw),
                           r_bytes, r_err,
                           dict(bit_equal=True, moved=moved,
                                confirmed=confirmed,
                                touched_bytes=r_touched,
                                # blocks, threads, lanes a hit, samples a
                                # chunk; the per-hit inputs as one row
                                launch=dict(refine_plan(hit.numel()),
                                            row_path=bool(input_rows(
                                                [*rargs[0], *rargs[1],
                                                 *rargs[2:4]]))))),
            "hit_shade": (lambda: shade_cuda(**skernel),
                          lambda: hits.shade_hits_plain(*sargs, **skw),
                          s_bytes, s_err,
                          dict(modes=modes, touched_bytes=s_touched,
                               # blocks, threads, lanes a hit
                               launch=shade_plan(hit.numel()))),
        }
        for name, (kern, plain, nbytes, err, extra) in work.items():
            ms = event_ms(kern, iters=20, warmup=3)
            plain_ms = event_ms(plain, iters=3, warmup=1)
            device_ms, device_ms_warm, split, n = _device_ms(torch, kern,
                                                             flush)
            retakes += n
            bound_ms, bound_by = _bound_of(nbytes, 0)
            rows[name][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                device_ms=device_ms, device_ms_warm=device_ms_warm,
                device_split=split, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, share_of_bound=bound_ms / device_ms,
                **variant, **extra)
            print(f"{name} {path}: {variant}; max|kernel - plain| {err!r} "
                  f"(bound {0.0 if name == 'hit_refine' else HIT_ATOL}); "
                  f"{ms!r} ms (events; plain {plain_ms!r}), device "
                  f"{device_ms!r} ms cold L2, {device_ms_warm!r} warm "
                  f"{split}, bound {bound_ms!r} ms by {bound_by} ({nbytes} "
                  f"B), {bound_ms / device_ms:.1%} of it"
                  + (f"; launch {extra['launch']}" if "launch" in extra
                     else "") + f", on {card}", flush=True)
        del volume, maps, counts, calls, rargs, rkw, sargs, skw, skernel, work
    del ppipe
    torch.cuda.empty_cache()
    out = []
    for name, by_path in rows.items():
        row = dict(name=name, route="cuda",
                   source="rgbd_recon_tpu_torch/csrc/hits.cu",
                   replaces=("rgbd_recon_tpu/ops/raymarch.py:409"
                             if name == "hit_refine"
                             else "rgbd_recon_tpu/recon/tsdf_pipeline.py:695"),
                   library_ms=None)
        row.update(by_path["fast"], max_abs_err=errs[name],
                   parity=by_path["parity"], trace_retakes=retakes)
        out.append(row)
    return out


# the preprocess kernels (csrc/preprocess.cu): the public pass that
# launches each, its twin, and the JAX function it ports; f32 operations a
# pixel counted by hand from the source (a pow, a square root or a
# division as one): morph's two 3x3 passes, the LAB's texcoords, 4 pair
# taps of 3 channels and conversion, the bilateral finish and cull, the
# boundary's 25 taps (its row counts them only where the data needs them:
# bench/kernel_inputs.py boundary_work), the normal's 4 neighbours and cross
# product, the quality's powers and view angle
PRE_PASSES = {
    "morph": ("morph_dilate", "rgbd_recon_tpu/ops/preprocess.py:85", 134),
    "lab": ("lab_colors", "rgbd_recon_tpu/ops/preprocess.py:453", 125),
    "depth2": ("bilateral_lab", "rgbd_recon_tpu/ops/preprocess.py:124", 22),
    "boundary": ("boundary", "rgbd_recon_tpu/ops/preprocess.py:244", 385),
    "normals": ("normals", "rgbd_recon_tpu/ops/preprocess.py:300", 65),
    "quality": ("quality", "rgbd_recon_tpu/ops/preprocess.py:364", 40),
}


def _record_preprocess(torch, fuse):
    """{pass: (args, kwargs)} as one fuse called each public pass of
    ops/preprocess.py (preprocess_frames calls them through the module, so
    the recorder sees every call)."""
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    calls = {}
    fns = {name: getattr(pre, name) for name, _, _ in PRE_PASSES.values()}

    def recorder(name):
        def record(*args, **kwargs):
            calls[name] = (args, kwargs)
            return fns[name](*args, **kwargs)
        return record

    for name in fns:
        setattr(pre, name, recorder(name))
    try:
        fuse()
        torch.cuda.synchronize()
    finally:
        for name, fn in fns.items():
            setattr(pre, name, fn)
    return calls


def _pre_reads(kname, a):
    """The tensors the preprocess kernel ``kname`` reads, from its pass's
    arguments by name ``a`` (the LAB's colour frame apart: its taps are
    counted by ``_lab_taps_bytes``)."""
    pm = a.get("pixel_models")
    if kname == "morph":
        return [a["depth"]]
    if kname == "lab":
        return [a["depth_norm"], pm.uv_p, pm.uv_q, pm.uv_r]
    if kname == "depth2":
        return [a["depth_m"], a["bbox_min"], a["bbox_max"],
                a["depth_limits"], pm.ray_a, pm.ray_b,
                *(a["bf_sums"] or ())]
    if kname == "boundary":
        return [a["depth2"], a["lab"]]
    if kname == "normals":
        return [a["depth2"], pm.ray_a, pm.ray_b]
    return [a["depth2"], a["normal"], a["camera_positions"], *a["q_sums"],
            pm.ray_a, pm.ray_b]


def _lab_taps_bytes(torch, colors, depth_norm, models, z_far):
    """Bytes of the colour texels the LAB pass reads (the 4 pair taps of
    each pixel, each texel once): the colour frame it needs, not the whole
    frame."""
    N, Hc, Wc, _ = colors.shape
    z = torch.where((depth_norm <= 0.0) | (depth_norm >= 1.0), z_far,
                    depth_norm)[..., None]
    uv = (models.uv_p + models.uv_q * z) / (1.0 + models.uv_r * z)
    x0f = torch.floor(uv[..., 0] * Wc - 0.5)
    y0f = torch.floor(uv[..., 1] * Hc - 0.5)
    x0 = torch.clamp(x0f.to(torch.int32), 0, Wc - 1).long()
    x1 = torch.clamp_max(x0 + 1, Wc - 1)
    y0 = torch.clamp(y0f.to(torch.int32), 0, Hc - 1).long()
    y1 = torch.clamp((y0f + 1.0).to(torch.int32), 0, Hc - 1).long()
    base = torch.arange(N, device=colors.device).view(N, 1, 1) * Hc
    taps = torch.cat([((base + y) * Wc + x).reshape(-1)
                      for y in (y0, y1) for x in (x0, x1)])
    return int(torch.unique(taps).numel()) * 3 * 4


def _boundary_checks(torch, a):
    """The boundary kernel bit-equal to boundary_plain beyond the fuse's
    call: on its recorded maps with the refine off, and on
    bench/kernel_inputs.py's maps at shapes that are no multiple of its tile
    (invalid edges, a reliable half), both refine values."""
    from rgbd_recon_tpu_torch.bench import kernel_inputs
    from rgbd_recon_tpu_torch.kernels.preprocess import boundary_cuda
    from rgbd_recon_tpu_torch.ops.preprocess import boundary_plain

    d2, lab = a["depth2"].contiguous(), a["lab"].contiguous()
    cases = [("the fuse's maps", d2, lab, False)]
    for i, shape in enumerate(kernel_inputs.BOUNDARY_SHAPES):
        md2, mlab = kernel_inputs.boundary_maps(torch, shape, 40 + i,
                                               d2.device)
        cases += [(f"{shape}", md2, mlab, refine) for refine in (True, False)]
    checked = []
    for label, cd2, clab, refine in cases:
        equal = all(_bits_equal(torch, g, w) for g, w in zip(
            boundary_cuda(cd2, clab, refine),
            boundary_plain(cd2, clab, refine)))
        print(f"boundary on {label}, refine {refine}: bit-equal to "
              f"boundary_plain {equal}", flush=True)
        if not equal:
            raise AssertionError(f"boundary on {label}, refine {refine} "
                                 "differs from boundary_plain")
        checked.append(f"{label} refine {refine}")
    return dict(also_bit_equal_on=checked)


def _phase3_preprocess(torch, pipe, frames, card, flush):
    """The preprocess kernels on the arguments one fast fuse hands to each
    public pass of ops/preprocess.py: each bit-equal to its twin, timed
    (events around the public pass, device time with a cold and a warm L2,
    the twin) beside its bound by bytes (its inputs read once, its outputs
    written once; the LAB's colour frame by the texels its taps read).
    Returns the six kernels' JSON rows."""
    import inspect

    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench import kernel_inputs
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.kernels.preprocess import morph_plan
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    calls = _record_preprocess(torch, lambda: pipe.fuse(frames))
    names = {fn for fn, _, _ in PRE_PASSES.values()}
    if set(calls) != names:
        raise AssertionError(f"the fast fuse called {set(calls)}, expected "
                             f"{names}")
    rows = []
    for kname, (fname, replaces, ops_px) in PRE_PASSES.items():
        args, kwargs = calls[fname]
        public = getattr(pre, fname)
        plain = getattr(pre, fname + "_plain")

        def kern():
            return public(*args, **kwargs)

        def twin():
            return plain(*args, **kwargs)

        kernels.reset_launch_counts()
        got = kern()
        torch.cuda.synchronize()
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        if launched != {kname: 1}:
            raise AssertionError(f"{fname}: launched {launched}, expected "
                                 f"{{'{kname}': 1}}")
        want = twin()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(_bits_equal(torch, g, w) for g, w in zip(got, want))
        err = _max_abs_err(torch, got, want)
        print(f"{kname}: max|kernel - plain| = {err!r}, bit-equal {equal} "
              f"(bound 0)", flush=True)
        if not equal:
            raise AssertionError(f"{kname} differs from {fname}_plain: max "
                                 f"abs error {err}")
        a = inspect.signature(plain).bind(*args, **kwargs).arguments
        reads = _pre_reads(kname, a)
        taps_bytes = None
        if kname == "lab":
            taps_bytes = _lab_taps_bytes(torch, a["colors"], a["depth_norm"],
                                         a["pixel_models"],
                                         pre._far_plane(a["cv_uv"]))
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*reads, *got)) + (taps_bytes or 0)
        pixels = got[0].shape[0] * got[0].shape[1] * got[0].shape[2]
        ops = ops_px * pixels
        extra = {}
        if kname == "morph":
            # its launch, and the pixels that take each of its exits
            extra = dict(launch=morph_plan(a["depth"]),
                         exits=kernel_inputs.morph_exits(torch, a["depth"]))
            print(f"morph: launch {extra['launch']}; pixels by exit "
                  f"{extra['exits']}", flush=True)
        if kname == "boundary":
            # the colour is read only around the pixels whose flags read it
            extra = _boundary_checks(torch, a)
            extra["bytes_all_inputs"] = nbytes
            nbytes, ops = kernel_inputs.boundary_work(
                torch, a["depth2"], a["lab"], a.get("refine", True))
        ms = event_ms(kern, iters=20, warmup=3)
        plain_ms = event_ms(twin, iters=5, warmup=1)
        device_ms, device_ms_warm, split, n = _device_ms(torch, kern, flush)
        bound_ms, bound_by = _bound_of(nbytes, ops)
        row = dict(name=kname, route="cuda",
                   source="rgbd_recon_tpu_torch/csrc/preprocess.cu",
                   replaces=replaces, max_abs_err=err, bit_equal=equal,
                   ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                   device_ms_warm=device_ms_warm, device_split=split,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=ops, share_of_bound=bound_ms / device_ms,
                   library_ms=None, trace_retakes=n, **extra)
        if taps_bytes is not None:
            row["color_taps_bytes"] = taps_bytes
        rows.append(row)
        print(f"{kname}: {ms!r} ms (events; plain {plain_ms!r}, library "
              f"none), device {device_ms!r} ms cold L2, {device_ms_warm!r} "
              f"warm {split}, bound {bound_ms!r} ms by {bound_by} ({nbytes} "
              f"B, {ops} ops), {bound_ms / device_ms:.1%} of it, on {card}",
              flush=True)
    return rows


# the fuse kernels (csrc/fuse.cu): the dispatch each replaces on the card,
# its twin, and the JAX package's code it replaces (XLA ops of the jitted
# fuse; no Pallas kernel)
FUSE_CALLS = {
    "brick_mark": ("bricks", "mark_pixels", "mark_pixels_plain",
                   "rgbd_recon_tpu/ops/bricks.py:20"),
    "brick_integrate": ("tsdf", "integrate_compact",
                        "integrate_compact_plain",
                        "rgbd_recon_tpu/ops/tsdf.py:301"),
}
# f32 operations of a marked pixel (the world point, the brick index and
# centre, the neighbour rule, the two atomics) and of a listed voxel a
# sensor (the taps' coordinates, the bilinear blends or the bf16 rounding,
# the fold), counted by hand from csrc/fuse.cu; both kernels are bound by
# bytes at these counts
MARK_PIXEL_OPS = 40
INTEGRATE_OPS = {"nearest": 25, "bilinear": 60}


def _record_fuse(torch, fuse):
    """{kernel: (args, kwargs)} as one fuse called the dispatch of each
    fuse kernel (the pipeline calls them through their modules)."""
    from rgbd_recon_tpu_torch.ops import bricks, tsdf

    mods = {"bricks": bricks, "tsdf": tsdf}
    calls = {}
    saved = {}
    for kname, (mod, fname, _, _) in FUSE_CALLS.items():
        fn = getattr(mods[mod], fname)
        saved[(mod, fname)] = fn

        def record(*args, _k=kname, _fn=fn, **kwargs):
            calls[_k] = (args, kwargs)
            return _fn(*args, **kwargs)

        setattr(mods[mod], fname, record)
    try:
        fuse()
        torch.cuda.synchronize()
    finally:
        for (mod, fname), fn in saved.items():
            setattr(mods[mod], fname, fn)
    return calls


def _fuse_syncs(torch, fn):
    """{"file:line": count} of the host syncs ``fn`` makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    import warnings

    sites = {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{w.filename.split('rgbd_recon_tpu_torch/')[-1]}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def _fuse_work(kname, args, kwargs):
    """(bytes, operations) the data of a fuse kernel's call needs: the
    marking's sampled depth and world inputs once and its counts once; the
    integration's volume once, the listed bricks' projection rows, the
    three maps and the slot map once."""
    from rgbd_recon_tpu_torch.kernels.fuse import sampled_size

    if kname == "brick_mark":
        depth, _, _, res, s = args
        N, H, W = depth.shape
        px = N * sampled_size(H, s) * sampled_size(W, s)
        world = 12 if kwargs.get("worlds") is not None else 24
        return (px * (4 + world) + 4 * res[0] * res[1] * res[2],
                px * MARK_PIXEL_OPS)
    proj, counts, min_voxels, capacity = args[:4]
    N, B, V, _ = proj.shape
    listed = min(int((counts > min_voxels).sum()), capacity)
    Z, Y, X = args[8]
    maps = sum(m.numel() * 4 for m in args[4:7])
    nbytes = Z * Y * X * 4 + listed * N * V * 16 + maps + B * 4
    return nbytes, listed * V * N * INTEGRATE_OPS[kwargs.get("taps",
                                                             "nearest")]


def _phase3_fuse(torch, pipe, frames, card, flush):
    """The fuse kernels on the arguments one fast and one parity fuse hand
    ops/bricks.py mark_pixels and ops/tsdf.py integrate_compact: the
    marking's counts equal to mark_pixels_plain's, the volume bit-equal to
    integrate_compact_plain's (and at a capacity of half the occupied
    bricks), each kernel timed (events around the dispatch, device time
    with a cold and a warm L2, the twin) beside its bound by bytes, its
    launch and registers printed; the pipeline's marking and integration
    free of host syncs under set_sync_debug_mode("error"), and the whole
    fuse's remaining syncs by site under "warn". Returns the two kernels'
    JSON rows (the fast fuse's figures, the parity fuse's under
    "parity")."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.kernels import fuse as kfuse
    from rgbd_recon_tpu_torch.ops import bricks, tsdf
    from rgbd_recon_tpu_torch.ops.compact import compact
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    mods = {"bricks": bricks, "tsdf": tsdf}
    attrs = kfuse.kernel_attrs()
    print(f"fuse kernels' registers, static shared and local bytes: {attrs}",
          flush=True)
    ppipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity"]), pipe.bbox)
    rows = {k: {} for k in FUSE_CALLS}
    for path, p in (("fast", pipe), ("parity", ppipe)):
        p.fuse(frames)                          # warm-up: fits the models
        calls = _record_fuse(torch, lambda: p.fuse(frames))
        if set(calls) != set(FUSE_CALLS):
            raise AssertionError(f"{path} fuse called {set(calls)}")
        for kname, (mod, fname, pname, replaces) in FUSE_CALLS.items():
            args, kwargs = calls[kname]
            public = getattr(mods[mod], fname)
            plain = getattr(mods[mod], pname)

            def kern():
                return public(*args, **kwargs)

            def twin():
                return plain(*args, **kwargs)

            kernels.reset_launch_counts()
            got = kern()
            torch.cuda.synchronize()
            launched = {k: n for k, n in kernels.launch_counts().items() if n}
            want_launch = ({kname: 1} if kname == "brick_mark"
                           else {"compact": 1, kname: 1})
            if launched != want_launch:
                raise AssertionError(f"{fname} {path}: launched {launched}, "
                                     f"expected {want_launch}")
            want = twin()
            equal = _bits_equal(torch, got, want)
            err = _max_abs_err(torch, got, want)
            extra = {}
            if kname == "brick_mark":
                extra["launch"] = kfuse.mark_plan(*args, **kwargs)
                extra["occupied"] = int(
                    (got > p.config.min_voxels_per_brick).sum())
                extra["registers"] = attrs[
                    "mark_kernel<true>" if extra["launch"]["shared_histogram"]
                    else "mark_kernel<false>"]
            else:
                extra["launch"] = kfuse.integrate_plan(
                    args[8], args[9], args[3], args[0].shape[0])
                extra["registers"] = attrs[
                    f"integrate_kernel<{kwargs.get('taps', 'nearest')}>"]
                # a capacity of half the occupied bricks: the rest cleared
                occ = int((args[1] > args[2]).sum())
                half = list(args)
                half[3] = occ // 2
                low = public(*half, **kwargs)
                low_equal = _bits_equal(torch, low, plain(*half, **kwargs))
                extra.update(occupied=occ, capacity_below=occ // 2,
                             bit_equal_below_capacity=low_equal)
                print(f"brick_integrate {path} at capacity {occ // 2} of "
                      f"{occ} occupied bricks: bit-equal to its twin "
                      f"{low_equal}", flush=True)
                equal = equal and low_equal
            print(f"{kname} {path}: max|kernel - plain| = {err!r}, bit-equal "
                  f"{equal} (bound 0); launch {extra['launch']}, "
                  f"{extra['registers']}", flush=True)
            if not equal:
                raise AssertionError(f"{kname} {path} differs from {pname}: "
                                     f"max abs error {err}")
            if kname == "brick_integrate":
                # the kernel alone, on the slot map of the call's compaction
                flags = (args[1] > args[2]).reshape(-1).view(torch.uint8)
                listed = torch.empty(1, dtype=torch.int32, device=flags.device)
                ids, slot = compact(flags, 0, args[3], listed, 0,
                                    want_slot=True)

                def timed():
                    return kfuse.brick_integrate_cuda(
                        args[0], ids, slot, *args[4:], **kwargs)
                # events around the dispatch: the flags and the compaction
                # too
                extra["ms_with_flags_and_compact"] = event_ms(
                    kern, iters=20, warmup=3)
            else:
                timed = kern
            ms = event_ms(timed, iters=20, warmup=3)
            plain_ms = event_ms(twin, iters=5, warmup=1)
            cold, warm, split, n = _device_ms(torch, timed, flush)
            nbytes, ops = _fuse_work(kname, args, kwargs)
            bound_ms, bound_by = _bound_of(nbytes, ops)
            row = dict(max_abs_err=err, bit_equal=equal, ms=ms,
                       plain_ms=plain_ms, device_ms=cold,
                       device_ms_warm=warm, device_split=split,
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       ops=ops, share_of_bound=bound_ms / cold,
                       trace_retakes=n, **extra)
            rows[kname][path] = row
            print(f"{kname} {path}: {ms!r} ms (events; plain {plain_ms!r}, "
                  f"library none; {extra.get('ms_with_flags_and_compact')!r} "
                  f"with the flags and the compaction), device {cold!r} ms "
                  f"cold L2, {warm!r} warm {split}, bound {bound_ms!r} ms by "
                  f"{bound_by} ({nbytes} B, {ops} ops), "
                  f"{bound_ms / cold:.1%} of it, on {card}", flush=True)
            del got, want
        # the pipeline's marking and integration make no host sync
        pm = p._get_pixel_models(frames.depths.shape[1:3])
        maps, _ = p.preprocess(frames)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts = p._mark_bricks(pm, maps)
            p.integrate(maps, counts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sites = _fuse_syncs(torch, lambda: p.fuse(frames))
        brickdraw = event_ms(lambda: p._mark_bricks(pm, maps), iters=20)
        integrate = event_ms(lambda: p.integrate(maps, counts), iters=20)
        print(f"fuse {path}: _mark_bricks and integrate make no host sync "
              f"under set_sync_debug_mode('error'); the whole fuse's syncs "
              f"by site {sites}; _mark_bricks {brickdraw!r} ms, integrate "
              f"{integrate!r} ms (events, mean of 20) on {card}", flush=True)
        for kname in FUSE_CALLS:
            rows[kname][path].update(fuse_syncs=sites,
                                     brickdraw_ms=brickdraw,
                                     integrate_ms=integrate)
        del calls, maps, counts
    del ppipe
    torch.cuda.empty_cache()
    out = []
    for kname, (mod, fname, pname, replaces) in FUSE_CALLS.items():
        fast = rows[kname]["fast"]
        out.append(dict(name=kname, route="cuda",
                        source="rgbd_recon_tpu_torch/csrc/fuse.cu",
                        replaces=replaces, library_ms=None,
                        parity=rows[kname]["parity"], **fast))
    return out


# the render bake's chain kernels: the dispatch each wraps, its twin, and
# the JAX package's code it replaces (XLA stages of the jitted render)
BAKE_CALLS = {
    "brick_clearance": ("bake", "brick_clearance", "brick_clearance_plain",
                        "rgbd_recon_tpu/recon/tsdf_pipeline.py:1042"),
    "oct_table": ("raymarch", "oct_rows", "oct_rows_plain",
                  "rgbd_recon_tpu/ops/raymarch.py:351"),
}
# each kernel's device activity (csrc/bake.cu)
BAKE_ACTIVITY = {"brick_clearance": "clearance_grid_kernel",
                 "oct_table": "oct_table"}
# the clearance's extra rounds on the card, and a grid larger than the
# cells' (30 x 30 x 30 bricks, 1% set)
CLEARANCE_ROUNDS = (0, 1, 6, 16)
LARGE_GRID = (30, 30, 30)


def _record_bake(torch, bake_fn):
    """{kernel: (args, kwargs)} as one bake called the dispatch of each
    chain kernel, and the (args, kwargs) of its build_oct_bricks call (or
    None)."""
    from rgbd_recon_tpu_torch.ops import bake, raymarch

    mods = {"bake": bake, "raymarch": raymarch}
    calls = {}
    targets = [(mod, fname, k) for k, (mod, fname, _, _) in BAKE_CALLS.items()]
    targets.append(("raymarch", "build_oct_bricks", "build_oct"))
    saved = []
    for mod, fname, key in targets:
        fn = getattr(mods[mod], fname)
        saved.append((mod, fname, fn))

        def record(*args, _k=key, _fn=fn, **kwargs):
            calls[_k] = (args, kwargs)
            return _fn(*args, **kwargs)

        setattr(mods[mod], fname, record)
    try:
        bake_fn()
        torch.cuda.synchronize()
    finally:
        for mod, fname, fn in saved:
            setattr(mods[mod], fname, fn)
    return calls


@contextlib.contextmanager
def _bake_on_twins():
    """The render bake's dispatches pointed at their plain twins."""
    from rgbd_recon_tpu_torch.ops import bake, raymarch

    swaps = [(bake, "surface_occ", bake.surface_occ_plain),
             (bake, "brick_clearance", bake.brick_clearance_plain),
             (bake, "sentinel_bake", bake.sentinel_bake_plain),
             (raymarch, "build_oct_bricks", raymarch.build_oct_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, fn in swaps:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _bake_parts(baked):
    """The bake's outputs by name, the oct table as its rows and slots."""
    table, oct, occ, bsafe = baked
    parts = {"table": table, "occ": occ, "bsafe": bsafe}
    if oct is not None:
        parts.update(oct_rows=oct.rows, oct_slots=oct.slots)
    return parts


def _outputs_equal(torch, got, want) -> bool:
    """Tensors or tuples of tensors bit-equal (shapes, dtypes, bits; bf16
    compared as int16)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)

    def same(g, w):
        if g.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
            return g.shape == w.shape and torch.equal(
                g.contiguous().view(torch.int16),
                w.contiguous().view(torch.int16))
        return _bits_equal(torch, g, w)

    return len(got) == len(want) and all(map(same, got, want))


def _clearance_checks(torch, occ, brick_vox):
    """brick_clearance at CLEARANCE_ROUNDS on ``occ``, on an empty and a
    full grid of its shape, and on a LARGE_GRID grid, each bit-equal to
    brick_clearance_plain; {case: True}."""
    from rgbd_recon_tpu_torch.kernels.bake import brick_clearance_cuda
    from rgbd_recon_tpu_torch.ops import bake

    gen = torch.Generator(occ.device).manual_seed(5)
    grids = {"frame": occ, "empty": torch.zeros_like(occ),
             "full": torch.ones_like(occ),
             "large": torch.rand(LARGE_GRID, generator=gen,
                                 device=occ.device) < 0.01}
    out = {}
    for name, g in grids.items():
        for r in CLEARANCE_ROUNDS:
            want = bake.brick_clearance_plain(g, r, brick_vox)
            got = brick_clearance_cuda(g, r, brick_vox)
            out[f"{name} R={r}"] = _outputs_equal(torch, got, want)
    torch.cuda.synchronize()
    return out


def _phase3_bake(torch, pipe, frames, camera, card, flush):
    """The render bake's chain kernels on the inputs one fast and one
    parity frame's bake hands them (csrc/bake.cu brick_clearance through
    ops/bake.py brick_clearance; oct_table through ops/raymarch.py
    oct_rows, after build_oct_bricks' compaction): each bit-equal to its
    twin, timed (events, device time with a cold and a warm L2 counting
    its own activity, the twin, which is the parent's chain for the
    clearance) beside its bound by bytes (bench/kernel_inputs.py
    oct_table_bytes for the oct table); the whole bake on the kernels
    bit-equal, part for part, to it on the twins, its launches, no host
    sync under set_sync_debug_mode("error"), its device activities, device
    ms and host ms (profile_slice.py's helpers). On the fast frame's inputs
    also: the clearance at 0, 1, 6 and 16 rounds, on an empty, a full and
    a 30 x 30 x 30 grid; the oct table at half the surface bricks'
    capacity and as the f32 table. Returns the two kernels' JSON rows (the fast
    frame's figures, the parity frame's under "parity")."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench.kernel_inputs import oct_table_bytes
    from rgbd_recon_tpu_torch.bench.trace import event_ms, profile_frames
    from rgbd_recon_tpu_torch.ops import bake, raymarch
    from rgbd_recon_tpu_torch.profile_slice import host_wall_ms, render_syncs
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    mods = {"bake": bake, "raymarch": raymarch}
    ppipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity"]), pipe.bbox)
    rows = {k: {} for k in BAKE_CALLS}
    bakes = {}
    for path, p in (("fast", pipe), ("parity", ppipe)):
        render, _ = p.make_render_fn(camera)
        volume, _, counts = p.fuse(frames)

        def run_bake():
            return render.bake(volume, counts)

        run_bake()                                   # warm-up
        calls = _record_bake(torch, run_bake)
        want_calls = {"brick_clearance"} | (
            {"oct_table", "build_oct"} if path == "fast" else set())
        if set(calls) != want_calls:
            raise AssertionError(f"{path} bake called {set(calls)}")

        # the whole bake: launches, no host sync, bit-equal to the twins'
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run_bake()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        with _bake_on_twins():
            kernels.reset_launch_counts()
            want = run_bake()
            torch.cuda.synchronize()
            twin_launches = sum(kernels.launch_counts().values())
        g, w = _bake_parts(got), _bake_parts(want)
        same = {k: set(g) == set(w) and _outputs_equal(torch, g[k], w[k])
                for k in w}
        host_ms = host_wall_ms(run_bake, 20)
        prof = profile_frames(run_bake, 5, host_ms)
        syncs = render_syncs(run_bake)
        bakes[path] = dict(
            launches=launched, bit_equal=same, host_ms=host_ms,
            host_syncs=syncs,
            activities=prof and prof["activities_per_frame"],
            device_ms=prof and prof["device_ms_per_frame"],
            top=prof and [dict(r, calls=r["calls"] / 5,
                               device_ms=r["device_ms"] / 5)
                          for r in prof["top"]])
        print(f"bake {path}: no host sync under set_sync_debug_mode('error') "
              f"({syncs} under 'warn'); launches {launched} (expected "
              f"{BAKE_LAUNCHES[path]}); bit-equal to the twins' bake {same} "
              f"(the twins launch {twin_launches}); host ms {host_ms!r} a "
              f"bake (synchronized, mean of 20); device "
              f"{bakes[path]['activities']} activities, "
              f"{bakes[path]['device_ms']!r} ms a bake, by kernel "
              f"{bakes[path]['top']} on {card}", flush=True)
        if (launched != BAKE_LAUNCHES[path] or not all(same.values())
                or twin_launches or syncs):
            raise AssertionError(f"bake {path}: launches {launched}, "
                                 f"bit-equal {same}, twin launches "
                                 f"{twin_launches}, syncs {syncs}")

        for kname, (args, kwargs) in calls.items():
            if kname not in BAKE_CALLS:
                continue
            mod, fname, pname, _ = BAKE_CALLS[kname]
            public = getattr(mods[mod], fname)
            plain = getattr(mods[mod], pname)

            def kern(_f=public, _a=args, _k=kwargs):
                return _f(*_a, **_k)

            def twin(_f=plain, _a=args, _k=kwargs):
                return _f(*_a, **_k)

            kernels.reset_launch_counts()
            got_k = kern()
            torch.cuda.synchronize()
            n_launch = kernels.launch_counts()[kname]
            want_k = twin()
            torch.cuda.synchronize()
            equal = _outputs_equal(torch, got_k, want_k)
            err = max(_max_abs_err(torch, a, b) for a, b in zip(
                got_k if isinstance(got_k, tuple) else (got_k,),
                want_k if isinstance(want_k, tuple) else (want_k,)))
            if not (equal and n_launch == 1):
                raise AssertionError(f"{kname} {path}: bit-equal {equal} "
                                     f"(max abs error {err}), {n_launch} "
                                     "launches")
            act = BAKE_ACTIVITY[kname]
            ms = event_ms(kern, iters=20, warmup=3)
            plain_ms = event_ms(twin, iters=5, warmup=1)
            cold, warm, split, n = _device_ms(
                torch, kern, flush, keep=lambda a, _s=act: _s in a)
            plain_cold, plain_warm = _events_ms(torch, twin, flush)
            outs = got_k if isinstance(got_k, tuple) else (got_k,)
            extra = {}
            if kname == "brick_clearance":
                occ, r, v = args
                n_b = occ.numel()
                # the mask read once, both f32 outputs written once; at
                # least one tap a brick a pass
                nbytes, ops = n_b + 8 * n_b, 3 * n_b
                extra["bricks"], extra["rounds"] = n_b, r
            else:
                vol, ids, v = args[:3]
                cap = ids.numel()
                # the union of the read bricks' extended boxes, the list
                # and the rows, each once
                nbytes = oct_table_bytes(torch, vol.shape, ids, v,
                                         outs[0].element_size())
                ops = 0
                extra.update(slots=cap, table=str(outs[0].dtype),
                             listed=int((ids < vol.numel() // v ** 3)
                                        .sum()))
            bound_ms, bound_by = _bound_of(nbytes, ops)
            row = dict(max_abs_err=err, bit_equal=equal, ms=ms,
                       plain_ms=plain_ms, device_ms=cold,
                       device_ms_warm=warm, device_split=split,
                       plain_events_cold_ms=plain_cold,
                       plain_events_warm_ms=plain_warm, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       share_of_bound=bound_ms / cold, trace_retakes=n,
                       **extra)
            rows[kname][path] = row
            print(f"{kname} {path}: bit-equal to its twin (max abs error "
                  f"{err!r}); {ms!r} ms (events; plain {plain_ms!r}, "
                  f"library none), device {cold!r} ms cold L2, {warm!r} warm "
                  f"{split}; the twin's chain {plain_cold!r} cold, "
                  f"{plain_warm!r} warm (events); bound {bound_ms!r} ms by "
                  f"{bound_by} ({nbytes} B, {ops} ops), "
                  f"{bound_ms / cold:.1%} of it; {extra} on {card}",
                  flush=True)

        if path == "fast":
            # the extra shapes, on the fast frame's inputs
            occ, r, v = calls["brick_clearance"][0]
            checks = _clearance_checks(torch, occ, v)
            vol, occ_b, v, cap, dtype = calls["build_oct"][0]
            listed = int(occ_b.sum())
            half = max(listed // 2, 1)
            for label, c, dt in (("half capacity", half, dtype),
                                 ("f32 table", cap, torch.float32)):
                a = raymarch.build_oct_bricks(vol, occ_b, v, c, dt)
                b = raymarch.build_oct_plain(vol, occ_b, v, c, dt)
                checks[f"oct {label}"] = (
                    _outputs_equal(torch, (a.rows, a.slots),
                                   (b.rows, b.slots)))
            ids = calls["oct_table"][0][1]

            def kern32():
                return raymarch.oct_rows(vol, ids, v, torch.float32)

            rows32 = kern32()
            c32, w32, _, n = _device_ms(
                torch, kern32, flush,
                keep=lambda a: BAKE_ACTIVITY["oct_table"] in a)
            b32 = _bound_of(oct_table_bytes(torch, vol.shape, ids, v, 4),
                            0)[0]
            rows["oct_table"]["fast"].update(
                f32_device_ms=c32, f32_device_ms_warm=w32, f32_bound_ms=b32,
                f32_share_of_bound=b32 / c32,
                f32_ms=event_ms(kern32, iters=20, warmup=3))
            print(f"bake extra shapes bit-equal to the twins {checks}; "
                  f"surface bricks {listed} (oct capacity {cap}; half "
                  f"{half}); oct_table f32: device {c32!r} ms cold, "
                  f"{w32!r} warm, bound {b32!r}, {b32 / c32:.1%} of it, on "
                  f"{card}", flush=True)
            if not all(checks.values()):
                raise AssertionError(f"bake extra shapes: {checks}")
            rows["brick_clearance"]["fast"]["extra_shapes"] = checks
        del calls, got, want, volume, counts
    del ppipe
    torch.cuda.empty_cache()
    out = []
    for kname, (_, _, _, replaces) in BAKE_CALLS.items():
        out.append(dict(name=kname, route="cuda",
                        source="rgbd_recon_tpu_torch/csrc/bake.cu",
                        replaces=replaces, library_ms=None,
                        parity=rows[kname].get("parity"), bake=bakes,
                        **rows[kname]["fast"]))
    return out


def _check_render(torch, label, volume, out, counts, cfg, camera):
    """Finite volume, color and depth, a 1280x720 image, and the oracle's
    gate (bench/oracle.py) that the path ``label`` holds (``_gate``): the
    surface RMSE within its limit and the hit count within its tolerance.
    Returns (rmse_mm, hit pixels)."""
    from rgbd_recon_tpu_torch.bench import oracle

    gate = _gate(label)

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
    rmse, n_hit = oracle.surface_rmse_mm(out, camera)
    print(f"{label}: surface RMSE {rmse!r} mm over {n_hit} hit pixels "
          f"(gate {gate})", flush=True)
    failures = oracle.gate(rmse, n_hit, **gate)
    if failures:
        raise AssertionError(f"{label}: {'; '.join(failures)}")
    return rmse, n_hit


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
    from rgbd_recon_tpu_torch.bench.oracle import sphere_depth

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
    sil, t_true = sphere_depth(cam)
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
    from rgbd_recon_tpu_torch.bench.trace import event_ms
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
    each run's stage means. Adds each run's launches to ``by_path``.
    Returns the working directory and the size arguments of the runs."""
    import shutil
    from pathlib import Path

    from rgbd_recon_tpu_torch.io.checkpoint import CheckpointManager
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
        err = io.StringIO()
        with contextlib.redirect_stderr(_Tee(sys.stderr, err)):
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
        if "--refine-every" in extra:
            lines = [ln for ln in err.getvalue().splitlines()
                     if ln.startswith(REFINE_LINE)]
            if len(lines) != APP_FRAMES:
                raise AssertionError(f"{name}: {len(lines)} refinement "
                                     f"lines, expected {APP_FRAMES}")
        if stereo:
            latest = CheckpointManager(ck).latest()
            if latest is None or latest.frame_index != APP_FRAMES:
                raise AssertionError(f"{name}: checkpoint {latest}")
            print(f"{name}: checkpoint at frame {latest.frame_index}, "
                  f"volume {latest.volume.shape}", flush=True)
    return work, sizes


def _timed(fn, samples=3, iters=10):
    """CUDA-event ms per call of ``fn``: ``samples`` means of ``iters``."""
    from rgbd_recon_tpu_torch.bench.trace import event_ms

    return [event_ms(fn, iters=iters, warmup=2 if i == 0 else 0)
            for i in range(samples)]


def _frame_fn(pipe, renderer, frames):
    def full():
        v, m, c = pipe.fuse(frames)
        return renderer(v, m, c)
    return full


def _phase9_variants(np, torch, pipe, frames, camera, card, fast, by_path):
    """Fuse + render of the fast config with each of VARIANTS: launch
    counts (reset just before the counted frame), the color variants' hit
    mask and window depth bit-equal to the fast path's render ``fast``,
    the others held to the sphere like the fast path; fuse + render ms.
    Adds each variant's launches to ``by_path``."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.ops import hits
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    fast_hit, fast_depth = fast
    for name, overrides in VARIANTS.items():
        t0 = time.perf_counter()
        vpipe = TsdfPipeline(pipe.calib,
                             dataclasses.replace(pipe.config, **overrides),
                             pipe.bbox)
        vrender = vpipe.make_renderer(camera)
        _frame_fn(vpipe, vrender, frames)()       # warm-up: fits the models
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        volume, maps, counts = vpipe.fuse(frames)
        out = vrender(volume, maps, counts)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        print(f"{name}: setup + 2 frames {time.perf_counter() - t0:.1f} s; "
              f"launches {launched}", flush=True)
        want = {k: int(k in PATH_KERNELS) for k in launched}
        want.update(PATH_FRAME["fast"])
        if vpipe.config.skip_fine_rounds > vpipe.brick_vox:
            want["sentinel_bake"] = 0        # the plain bake, as in JAX
        # with march_chunk, phase 1 is the chunked march (no kernel)
        want["march"] = (PATH_MARCHES["fast"]
                         - int(vpipe.config.march_chunk > 0))
        want.update(FILL_LAUNCHES if vpipe.config.colorfill else NO_FILL)
        # the camera-influence view, the normal-weighted blends and the
        # profiling switches shade on the twin; "refine" skips the refine
        want["hit_shade"] = int(hits.kernel_shades(vpipe.config))
        want["hit_refine"] = int("refine" not in vpipe.config.debug_skip)
        # through the calibration volumes the four calibration passes run
        # their twins (ops/preprocess.py kernel_passes)
        if vpipe._get_pixel_models(frames.depths.shape[1:3]) is None:
            want.update({k: 0 for k in PRE_CALIB})
        if launched != want:
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"{want}")
        by_path[name] = launched
        for field in ("color", "depth"):
            if not bool(torch.isfinite(getattr(out, field)).all()):
                raise AssertionError(f"{name}: non-finite {field}")
        if name in COLOR_VARIANTS:
            same = (torch.equal(out.hit, fast_hit)
                    and torch.equal(out.depth, fast_depth))
            print(f"{name}: hit mask and depth bit-equal to the fast path's: "
                  f"{same} ({int(out.hit.sum())} hits), overflow "
                  f"{out.overflow.tolist()}", flush=True)
            if not same:
                raise AssertionError(f"{name}: hits or depth differ from the "
                                     "fast path's")
        else:
            _check_render(torch, name, volume, out, counts, vpipe.config,
                          camera)
        del volume, maps, counts, out
        frame_ms = _timed(_frame_fn(vpipe, vrender, frames), samples=2,
                          iters=3)
        print(f"{name}: fuse+render ms {frame_ms} on {card}", flush=True)
        del vpipe, vrender
        torch.cuda.empty_cache()


def _phase10_reconfig(np, torch, pipe, frames, camera, card):
    """One pipeline and one renderer handle through set_tsdf_limit(0.02)
    and back, set_voxel_size(0.02) (a 100x110x100 volume) and back: each
    fuse launching the marking, one compaction and the integration once,
    every render finite, the flip-backs' hit masks (and after the voxel
    size, depth) bit-equal to the first render."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench.oracle import surface_rmse_mm
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    rpipe = TsdfPipeline(pipe.calib, dataclasses.replace(pipe.config),
                         pipe.bbox)
    handle = rpipe.make_renderer(camera)

    def frame(label):
        kernels.reset_launch_counts()
        volume, maps, counts = rpipe.fuse(frames)
        torch.cuda.synchronize()
        fused = {k: kernels.launch_counts()[k] for k in COMPACT_FUSE}
        if fused != COMPACT_FUSE:
            raise AssertionError(f"{label}: the fuse launched {fused}, "
                                 f"expected {COMPACT_FUSE}")
        out = handle(volume, maps, counts)
        torch.cuda.synchronize()
        for field in ("color", "depth"):
            if not bool(torch.isfinite(getattr(out, field)).all()):
                raise AssertionError(f"{label}: non-finite {field}")
        rmse, n_hit = surface_rmse_mm(out, camera)
        print(f"{label}: volume {tuple(volume.shape)}, {n_hit} hits, surface "
              f"RMSE {rmse!r} mm, overflow {out.overflow.tolist()}",
              flush=True)
        if n_hit <= 0:
            raise AssertionError(f"{label}: no hit")
        return volume, out

    def timed_call(label, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms (host "
              f"clock) on {card}", flush=True)

    _, first = frame("reconfig first")
    timed_call("set_tsdf_limit(0.02)", lambda: rpipe.set_tsdf_limit(0.02))
    frame("reconfig limit 0.02")
    rpipe.set_tsdf_limit(0.01)
    _, back = frame("reconfig limit back to 0.01")
    if not torch.equal(back.hit, first.hit):
        raise AssertionError("limit flip-back: hit mask differs")
    timed_call("set_voxel_size(0.02)", lambda: rpipe.set_voxel_size(0.02))
    coarse, _ = frame("reconfig 2 cm voxels")
    if tuple(coarse.shape) != (100, 110, 100):
        raise AssertionError(f"2 cm voxels: volume {tuple(coarse.shape)}")
    timed_call("set_voxel_size(0.01)", lambda: rpipe.set_voxel_size(0.01))
    _, back = frame("reconfig voxels back to 1 cm")
    if not (torch.equal(back.hit, first.hit)
            and torch.equal(back.depth, first.depth)):
        raise AssertionError("voxel-size flip-back: hit mask or depth differ")
    print("reconfig: flip-backs bit-equal to the first render", flush=True)
    del rpipe, handle
    torch.cuda.empty_cache()


def _phase11_pose(np, torch, card):
    """scripts/validate_pose_ba.py on the card: the drifted rig's
    calibration baked in numpy, the true rig's forward volumes for the
    error, four refine -> apply -> re-fuse rounds. Checks the recovery,
    prints each round's gates, ms per round and per LM iteration, and the
    device's busy share over one more (estimate-only) round."""
    from rgbd_recon_tpu_torch.calib.sensors import (
        build_synthetic_calibration,
    )
    from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
    from rgbd_recon_tpu_torch.core.camera import RGBDSensor, SensorRig
    from rgbd_recon_tpu_torch.bench.trace import profile_frames
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
    from rgbd_recon_tpu_torch.refine import pose_ba
    from rgbd_recon_tpu_torch.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=4, depth_size=(512, 424),
                           color_size=(640, 540), bbox=bbox)
    th = np.radians(POSE_DRIFT_DEG)
    E_rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]], np.float32)
    E_t = np.array(POSE_DRIFT_T, np.float32)
    s1 = rig.sensors[1]
    bad_depth = dataclasses.replace(
        s1.depth,
        r_cw=tuple(map(tuple, (E_rot @ np.asarray(s1.depth.R)).tolist())),
        t_cw=tuple((E_rot @ np.asarray(s1.depth.t_cw) + E_t).tolist()))
    bad_rig = SensorRig(sensors=(
        rig.sensors[0],
        RGBDSensor(depth=bad_depth, color=s1.color, serial=s1.serial),
        rig.sensors[2], rig.sensors[3]))
    scene = SyntheticScene(spheres=[((0.0, 1.25, 0.0), 0.45),
                                    ((0.45, 0.55, 0.25), 0.28),
                                    ((-0.5, 0.75, -0.2), 0.22)])
    frames = render_rig_frames(scene, rig, device=dev)
    calib = build_synthetic_calibration(bad_rig, bbox, cv_res=(64, 128, 64),
                                        inv_res=(200, 220, 200), device=dev)
    truth = build_synthetic_calibration(rig, bbox, cv_res=(64, 128, 64),
                                        inv_res=(8, 8, 8), device=dev)
    pipe = TsdfPipeline(calib, PipelineConfig(
        voxel_size=0.01, brick_size=0.1, tsdf_limit=0.01), bbox)
    volume, maps, counts = pipe.fuse(frames)
    torch.cuda.synchronize()
    print(f"pose: drifted rig baked (numpy), frames, first fuse "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def lookup_error_mm(c):
        """Mean |cv_xyz - cv_xyz_true| per sensor over mid-frustum
        depths (validate_pose_ba.py's calib_error_mm)."""
        d = c.cv_xyz[:, 16:112] - truth.cv_xyz[:, 16:112]
        return (torch.linalg.norm(d, dim=-1).mean(dim=(1, 2, 3))
                * 1000.0).cpu().numpy()

    # the drifted rig's state, for phase 12's mesh form of refine_poses
    drifted = (pipe.calib, maps, volume)
    cv_before = pipe.calib.cv_xyz.clone()
    err0 = lookup_error_mm(pipe.calib)
    t0 = time.perf_counter()
    pipe.refine_sensor_poses(maps, counts, iters=POSE_ITERS,
                             rounds=POSE_ROUNDS, frames=frames,
                             band_schedule=(1.0,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err1 = lookup_error_mm(pipe.calib)
    moved = (torch.linalg.norm(pipe.calib.cv_xyz - cv_before, dim=-1)
             .mean(dim=(1, 2, 3)) * 1000.0).cpu().numpy()
    for r in pipe.refine_report:
        print(f"pose round {r['round']}: worst sensor {r['worst']}, "
              f"residuals {r['residuals']}, margin {r['margin']}, improve "
              f"{r['improve']} ({r['residual_after']!r} after), applied "
              f"{r['applied']}", flush=True)
    print(f"pose: mean lookup error per sensor (mm) before {err0.tolist()}, "
          f"after {err1.tolist()}; cv_xyz moved (mm) {moved.tolist()}",
          flush=True)
    print(f"pose: {POSE_ROUNDS} rounds x {POSE_ITERS} LM iterations in "
          f"{wall:.2f} s: {wall / POSE_ROUNDS * 1e3:.1f} ms a round (host "
          f"clock, synchronized) on {card}", flush=True)
    if not err1[1] <= POSE_RECOVERY * err0[1]:
        raise AssertionError(f"pose: sensor 1 lookup error {err1[1]} mm, "
                             f"more than {POSE_RECOVERY} of {err0[1]}")
    others = [i for i in range(4) if i != 1]
    if not (moved[others] <= POSE_OTHERS_MM).all():
        raise AssertionError(f"pose: undrifted sensors moved {moved} mm")

    # the parts of one round, on the refined rig: leave-one-out volumes,
    # then the LM iterations alone
    volume, maps, counts = pipe.fuse(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vols, obs = pose_ba.leave_one_out_volumes(pipe, maps, counts,
                                              limit=0.01,
                                              return_observers=True)
    torch.cuda.synchronize()
    loo_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pose_ba.refine_poses(pipe.calib, maps, None, 0.01, iters=POSE_ITERS,
                         volumes=vols, mask_floor=-0.01 * 0.999,
                         observers=obs, min_observers=2.0)
    torch.cuda.synchronize()
    lm_ms = (time.perf_counter() - t0) * 1e3 / POSE_ITERS
    print(f"pose: leave-one-out volumes with observers {loo_ms:.1f} ms, "
          f"{lm_ms:.2f} ms per LM iteration (4 sensors; host clock, "
          f"synchronized) on {card}", flush=True)
    del vols, obs

    # device busy share over one estimate-only round: its device time under
    # the profiler against the wall time of the same round unprofiled
    def estimate_round():
        pipe.refine_sensor_poses(maps, counts, iters=POSE_ITERS, apply=False,
                                 band_schedule=(1.0,))
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    estimate_round()
    round_wall = (time.perf_counter() - t0) * 1e3
    window = profile_frames(estimate_round, 1, round_wall)
    if window is None:
        print(f"pose: one estimate-only round {round_wall:.1f} ms wall; "
              f"torch.profiler recorded no device activity, so its busy "
              f"share is not measured, on {card}", flush=True)
    else:
        print(f"pose: one estimate-only round {round_wall:.1f} ms wall "
              f"({window['traced_wall_ms_per_frame']:.1f} under the "
              f"profiler), device {window['device_ms']:.1f} ms over "
              f"{window['device_activities']} activities, busy share "
              f"{window['busy_share']!r} of the unprofiled wall on {card}",
              flush=True)
    del pipe, volume, maps, counts, frames, calib, truth
    torch.cuda.empty_cache()
    return drifted


def _phase12_dist(np, torch, pipe, frames, camera, card, drifted, by_path):
    """The multi-device layer on this card (see the module docstring):
    every check raises on failure. Adds each path's launches to
    ``by_path``. Returns {kernel: {path: (slab shape, max |kernel - plain|)}}
    of the per-slab bake kernels at the shapes each sharded path gives
    them."""
    from rgbd_recon_tpu_torch import dist, kernels
    from rgbd_recon_tpu_torch.calib.bake import bake_cv_xyz
    from rgbd_recon_tpu_torch.calib.inverter import (
        invert_calibration_bruteforce,
        invert_calibration_knn,
    )
    from rgbd_recon_tpu_torch.core import BoundingBox
    from rgbd_recon_tpu_torch.dist import collectives
    from rgbd_recon_tpu_torch.dist.mesh import _bake_slabs
    from rgbd_recon_tpu_torch.kernels.bake import (
        sentinel_bake_cuda,
        surface_occ_cuda,
    )
    from rgbd_recon_tpu_torch.ops import bake
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
    from rgbd_recon_tpu_torch.refine import pose_ba
    from rgbd_recon_tpu_torch.sensors.synthetic import default_test_rig

    dev = pipe.device
    note = ("all shards on one card: the times measure the shards' extra "
            "launches and copies, not scaling")

    def counted(label, fn, want):
        """One call of ``fn`` with the launch counts and the collectives'
        byte counts set to 0 just before and read just after; the launches
        must be ``want``."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        collectives.reset_bytes()
        out = fn()
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        moved = collectives.bytes_moved()
        print(f"{label}: launches {launched}; bytes per frame {moved}",
              flush=True)
        want = {k: dict(want).get(k, 0) for k in launched}
        if launched != want:
            raise AssertionError(f"{label}: launched {launched}, expected "
                                 f"{want}")
        by_path[label] = launched
        return out

    slab_checks = {"surface_occ": {}, "sentinel_bake": {}}

    def slab_bake(label, vol_sh, volume, counts):
        """The slab bake of ``vol_sh`` bit-equal to the single-device bake
        of ``volume`` (table, oct table, surface bricks, brick clearance),
        and each shard's kernels against their plain twins on its slab
        grown by one brick, with ghost bricks at the clear value beyond
        the z faces and zero brick clearance in them."""
        v, K = pipe.brick_vox, pipe.config.skip_fine_rounds
        limit = pipe._limit
        render, _ = pipe.make_render_fn(camera)
        want = render.bake(volume, counts)
        got = _bake_slabs(render, vol_sh.slabs, vol_sh.shape, v, limit, dev)

        def equal(g, w):
            # a tensor, None, or the oct table (a dataclass of tensors)
            if isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor):
                return torch.equal(g, w)
            if dataclasses.is_dataclass(g) and type(g) is type(w):
                return all(equal(getattr(g, f.name), getattr(w, f.name))
                           for f in dataclasses.fields(g))
            return g == w

        same = {k: equal(g, w) for k, g, w in zip(
            ("table", "oct", "occ", "bsafe"), got, want)}
        ext = dist.halo_exchange_z(vol_sh.slabs, v, fill=-limit)
        bs = want[3] * float(v)
        Bz, By, Bx = bs.shape
        Bzl = vol_sh.slabs[0].shape[0] // v
        bs_pad = torch.cat([bs.new_zeros((1, By, Bx)), bs, bs.new_zeros(
            (len(ext) * Bzl - Bz + 1, By, Bx))])
        errs = {"surface_occ": 0.0, "sentinel_bake": 0.0}
        for s, e in enumerate(ext):
            bs_e = bs_pad[s * Bzl: (s + 1) * Bzl + 2].contiguous()
            pairs = {"surface_occ": (surface_occ_cuda(e, v),
                                     bake.surface_occ_plain(e, v)),
                     "sentinel_bake": (sentinel_bake_cuda(e, bs_e, v, K),
                                       bake.sentinel_bake_plain(e, bs_e, v,
                                                                K))}
            for k, (g, w) in pairs.items():
                errs[k] = max(errs[k], _max_abs_err(torch, g, w))
        shape = tuple(ext[0].shape)
        for k, err in errs.items():
            slab_checks[k][label] = {"slab_shape": shape, "max_abs_err": err}
        print(f"{label}: slab bake bit-equal to the single device's {same}; "
              f"per shard on its {shape} grown slab, max |kernel - plain| "
              f"{errs} (bound 0)", flush=True)
        if not all(same.values()) or any(errs.values()):
            raise AssertionError(f"{label}: the slab bake differs")

    def compact(label, mesh, ref):
        volume, counts, out = ref
        step = dist.shard_compact_step(pipe, camera, mesh)
        step(frames)                                  # warm-up
        n = mesh.size
        # a compaction and an integrate launch a slab, the marking once;
        # the two bake kernels a slab, the clearance and the oct table
        # (with its compaction) once on the gathered mask and volume
        want = dict(bilateral13=1, quality13=1, surface_occ=n,
                    sentinel_bake=n, march=PATH_MARCHES["fast"],
                    **FILL_LAUNCHES, **PATH_HITS["fast"], **PRE_LAUNCHES,
                    **_plus(FAST_STAGES, FAST_BAKE,
                            dict(brick_mark=1, compact=n,
                                 brick_integrate=n)))
        vol_sh, out_sh = counted(label, lambda: step(frames), want)
        same = {f: torch.equal(getattr(out_sh, f), getattr(out, f))
                for f in ("hit", "depth")}
        same["volume"] = torch.equal(vol_sh.gather(), volume)
        color = float((out_sh.color - out.color).abs().max())
        print(f"{label}: bit-equal to the single device {same}; max colour "
              f"difference {color!r} (limit {SHARD_COLOR_TOL}); overflow "
              f"{out_sh.overflow.tolist()}; per shard "
              f"{step.diagnostics()}", flush=True)
        if not all(same.values()) or not color <= SHARD_COLOR_TOL:
            raise AssertionError(f"{label}: differs from the single device")
        slab_bake(label, vol_sh, volume, counts)
        return step

    # ---- the compact step over 8 and 4 shards of this card --------------
    renderer = pipe.make_renderer(camera)
    volume, maps, counts = pipe.fuse(frames)
    ref = (volume, counts, renderer(volume, maps, counts))
    single_ms = _timed(_frame_fn(pipe, renderer, frames), samples=2, iters=5)
    for n in COMPACT_SHARDS:
        step = compact(f"sharded{n}", dist.make_mesh(devices=[dev] * n), ref)
        ms = _timed(lambda: step(frames), samples=2, iters=5)
        print(f"sharded{n}: step ms {ms} against the single device's fuse+"
              f"render {single_ms} (CUDA events, means of 5) on {card}; "
              f"{note}", flush=True)
        del step
    del volume, maps, counts, ref

    # ---- the dense step over 4 shards at the parity_dense config --------
    dpipe = TsdfPipeline(pipe.calib, dataclasses.replace(
        pipe.config, **_side_paths()["parity_dense"]), pipe.bbox)
    drender = dpipe.make_renderer(camera)
    dvol, dmaps, dcounts = dpipe.fuse(frames)
    dout = drender(dvol, dmaps, dcounts)
    dstep = dist.shard_pipeline_step(
        dpipe, camera, dist.make_mesh(devices=[dev] * DENSE_SHARDS))
    dstep(frames)                                     # warm-up
    vol_sh, out_sh = counted(f"dense{DENSE_SHARDS}", lambda: dstep(frames),
                             dict(bilateral13=1, quality13=1, surface_occ=0,
                                  sentinel_bake=0,
                                  march=PATH_MARCHES["parity_dense"],
                                  **FILL_LAUNCHES,
                                  **PATH_HITS["parity_dense"],
                                  **PRE_LAUNCHES,
                                  **PATH_FUSE["parity_dense"]))
    same = {f: torch.equal(getattr(out_sh, f), getattr(dout, f))
            for f in ("hit", "depth")}
    same["volume"] = torch.equal(vol_sh.gather(), dvol)
    color = float((out_sh.color - dout.color).abs().max())
    print(f"dense{DENSE_SHARDS}: bit-equal to the single device {same}; max "
          f"colour difference {color!r} (limit {SHARD_COLOR_TOL}), "
          f"{int(dout.hit.sum())} hits", flush=True)
    if not all(same.values()) or not color <= SHARD_COLOR_TOL:
        raise AssertionError("dense step: differs from the single device")
    ms = _timed(lambda: dstep(frames), samples=2, iters=3)
    single = _timed(_frame_fn(dpipe, drender, frames), samples=2, iters=3)
    print(f"dense{DENSE_SHARDS}: step ms {ms} against the single device's "
          f"fuse+render {single} on {card}; {note}", flush=True)
    del dpipe, drender, dvol, dmaps, dcounts, dout, dstep, vol_sh, out_sh
    torch.cuda.empty_cache()

    # ---- the sensor-sharded preprocess ----------------------------------
    ref_maps, ref_counts = pipe.preprocess(frames)
    for n in PREPROCESS_SHARDS:
        run = dist.shard_preprocess(pipe, dist.make_mesh(devices=[dev] * n))
        run(frames)                                   # warm-up
        smaps, scounts = counted(f"preprocess{n}", lambda: run(frames),
                                 dict(bilateral13=n, quality13=n,
                                      surface_occ=0, sentinel_bake=0,
                                      brick_mark=n,
                                      **{k: n for k in PRE_LAUNCHES}))
        errs = {k: float((getattr(smaps, k) - getattr(ref_maps, k)).abs()
                         .max()) for k in MAP_TOLS}
        print(f"preprocess{n}: counts equal "
              f"{torch.equal(scounts, ref_counts)}; max |sharded - "
              f"replicated| per map {errs}", flush=True)
        if not torch.equal(scounts, ref_counts):
            raise AssertionError(f"preprocess{n}: brick counts differ")
        for k, atol in MAP_TOLS.items():
            want = getattr(ref_maps, k)
            if not torch.allclose(getattr(smaps, k), want, rtol=1e-4,
                                  atol=atol):
                raise AssertionError(f"preprocess{n}: map {k} differs")
        ms = event_ms(lambda: run(frames), iters=5)
        single = event_ms(lambda: pipe.preprocess(frames), iters=5)
        print(f"preprocess{n}: {ms!r} ms against {single!r} ms replicated "
              f"(CUDA events, mean of 5) on {card}; {note}", flush=True)
    del ref_maps, ref_counts

    # ---- the mesh form of refine_poses on phase 11's drifted rig --------
    calib, dmaps, dvol = drifted
    t0 = time.perf_counter()
    single, _ = pose_ba.refine_poses(calib, dmaps, dvol, 0.01,
                                     iters=MESH_POSE_ITERS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh_poses, _ = pose_ba.refine_poses(
        calib, dmaps, dvol, 0.01, iters=MESH_POSE_ITERS,
        mesh=dist.make_mesh(devices=[dev] * MESH_POSE_SHARDS))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = float((mesh_poses - single).abs().max())
    print(f"refine_poses over {MESH_POSE_SHARDS} shards, "
          f"{MESH_POSE_ITERS} LM iterations: max |mesh - single| {err!r} "
          f"(limit {MESH_POSE_ATOL}), bit-equal "
          f"{torch.equal(mesh_poses, single)}; sensor 1 correction "
          f"{mesh_poses[1].tolist()}; {(t1 - t0) * 1e3:.1f} ms single, "
          f"{(t2 - t1) * 1e3:.1f} ms mesh (host clock, synchronized) on "
          f"{card}", flush=True)
    if not err <= MESH_POSE_ATOL:
        raise AssertionError(f"refine_poses mesh form: {err}")

    # ---- the brute-force inverter on the card ---------------------------
    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    cv = bake_cv_xyz(default_test_rig(num_sensors=2, bbox=bbox).sensors[0],
                     res=INV_CV_RES)
    want = invert_calibration_knn(cv, bbox, INV_RES, k=8)
    got = invert_calibration_bruteforce(cv, bbox, INV_RES, k=8, device=dev)
    valid = want[..., 3] > 0
    same_mask = bool(((got[..., 3] > 0) == valid).all())
    diff = np.abs(got[valid] - want[valid])
    over = int((diff > 1e-4 + 1e-3 * np.abs(want[valid])).sum())
    ms = event_ms(lambda: invert_calibration_bruteforce(
        cv, bbox, INV_RES, k=8, device=dev), iters=3, warmup=1)
    print(f"invert_calibration_bruteforce {INV_CV_RES} -> {INV_RES}: valid "
          f"masks equal {same_mask}, {int(valid.sum())} valid texels, max "
          f"|brute force - kd-tree| {float(diff.max())!r}, {over} beyond "
          f"rtol 1e-3 / atol 1e-4; {ms!r} ms a call on {card}", flush=True)
    if not same_mask or over:
        raise AssertionError("the brute-force inverter disagrees with the "
                             "kd-tree inverter")

    # ---- real devices ---------------------------------------------------
    if torch.cuda.device_count() >= 2:
        volume, maps, counts = pipe.fuse(frames)
        compact(f"sharded_devices{torch.cuda.device_count()}",
                dist.make_mesh(),
                (volume, counts, renderer(volume, maps, counts)))
    else:
        print(f"real devices: {torch.cuda.device_count()} CUDA device, so "
              "the compact step did not run over several cards", flush=True)
    return slab_checks


def _phase13_gather(np, torch, card, flush):
    """The gather-rate probe at the TPU probe's shapes (see the module
    docstring). Returns the four kernels' JSON records; gather_rows' holds
    gather_rows_cluster's under "cluster"."""
    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench import gather_probe
    from rgbd_recon_tpu_torch.kernels import gather as kg
    from rgbd_recon_tpu_torch.ops import gather
    from rgbd_recon_tpu_torch.bench.trace import event_ms

    dev = torch.device("cuda")
    n = gather_probe.LOOKUPS
    table, idx = gather_probe.make_inputs(dev, seed=0)
    cap4, cap8 = kg.rows_capacities(dev)
    limits = (cap4, cap8, kg.smem_table_entries(dev))
    print(f"gather probe: {n} lookups, table {table.numel()} f32 entries; "
          f"on this card gather_flat_smem takes at most {limits[2]} "
          f"entries, gather_rows_cluster rows of at most {cap4} entries in "
          f"its smaller cluster, {cap8} in its larger", flush=True)

    def measure(f):
        config = None
        if f.name in ("gather_rows_cluster", "gather_flat_smem"):
            config = gather_probe.configuration(f.name, *f.moved[:2])
            print(f"{f.name}: launch configuration {config}; the table "
                  f"read from L2 {config['table_bytes_from_l2']} B a call "
                  f"(reckoned)", flush=True)
        before = kernels.launch_counts()
        got = f.kernel()
        counted = {k: v - before[k]
                   for k, v in kernels.launch_counts().items()
                   if v != before[k]}
        want, lib = f.plain(), f.library()
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        print(f"{f.name}: max|kernel - plain| = {err!r} (bound 0); "
              f"launched {counted}", flush=True)
        if counted != {f.name: 1}:
            raise AssertionError(f"{f.name}: launched {counted}")
        if not torch.equal(got, want):
            raise AssertionError(f"{f.name} differs from its plain version")
        if not torch.equal(lib, want):
            raise AssertionError(f"{f.name}: {f.library_name} computes "
                                 "another function")
        ms = event_ms(f.kernel, iters=20, warmup=3)
        plain_ms = event_ms(f.plain, iters=20, warmup=3)
        library_ms = event_ms(f.library, iters=20, warmup=3)
        device_ms, device_ms_warm, split, retakes = _device_ms(
            torch, f.kernel, flush)
        lib_cold, lib_warm, _, r = _device_ms(torch, f.library, flush)
        retakes += r
        bound_ms, bound_by = _bound(f.moved, 0)
        row = dict(name=f.name, route="cuda",
                   source="rgbd_recon_tpu_torch/csrc/gather.cu",
                   replaces=f.replaces, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, device_ms=device_ms,
                   device_ms_warm=device_ms_warm, device_split=split,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / device_ms,
                   library=f.library_name,
                   library_ms=library_ms, library_device_ms=lib_cold,
                   library_device_ms_warm=lib_warm,
                   mlookups_s_cold=n / device_ms / 1e3,
                   mlookups_s_warm=n / device_ms_warm / 1e3, ops=0)
        if config is not None:
            row["config"] = config
        if f.name in ("gather_flat", "gather_rows", "gather_cols"):
            # reckoned, not a counter: a random lookup moves one 32-byte
            # sector from L2 to an SM
            row.update(l2_sector_tb_s_cold=n * 32 / device_ms / 1e9,
                       l2_sector_tb_s_warm=n * 32 / device_ms_warm / 1e9)
        if f.name == "gather_flat_smem":
            # the table load alone: a launch of the same grid with no
            # lookups
            tab_s = f.moved[0]
            none = idx[:0]

            def load():
                return gather.gather_flat_smem(tab_s, none)

            load_ms, load_warm, _, r = _device_ms(torch, load, flush)
            retakes += r
            row.update(load_device_ms=load_ms, load_device_ms_warm=load_warm,
                       mlookups_s_past_load=n / (device_ms - load_ms) / 1e3)
            print(f"{f.name}: table load alone {load_ms!r} ms cold, "
                  f"{load_warm!r} warm (device); lookups past the load "
                  f"{n / (device_ms - load_ms) / 1e3:.1f} M/s", flush=True)
        row["trace_retakes"] = retakes
        print(f"{f.name}: {ms!r} ms (events; plain {plain_ms!r}, "
              f"{f.library_name} {library_ms!r}), device {device_ms!r} ms "
              f"cold L2, {device_ms_warm!r} warm ({n / device_ms / 1e3:.1f} "
              f"/ {n / device_ms_warm / 1e3:.1f} M lookups/s; "
              f"{f.library_name} {lib_cold!r} / {lib_warm!r}), bound "
              f"{bound_ms!r} ms by {bound_by}, {bound_ms / device_ms:.1%} "
              f"of it, on {card}",
              flush=True)
        if "l2_sector_tb_s_cold" in row:
            print(f"{f.name}: {n / device_ms / 1e6:.2f} / "
                  f"{n / device_ms_warm / 1e6:.2f} G lookups/s cold / warm; "
                  f"L2 sector rate (lookups x 32 B / device time, reckoned) "
                  f"{row['l2_sector_tb_s_cold']:.3f} / "
                  f"{row['l2_sector_tb_s_warm']:.3f} TB/s", flush=True)
        if f.name == "gather_rows_cluster":
            # reckoned: each lookup reads the owning block's shared memory,
            # another block's for all but 1 in cluster
            remote = (config["cluster"] - 1) / config["cluster"]
            print(f"{f.name}: {n / device_ms / 1e6:.2f} / "
                  f"{n / device_ms_warm / 1e6:.2f} G lookups/s cold / warm "
                  f"from the cluster's shared memory, {remote:.0%} of them "
                  f"in another block (reckoned), the table load included",
                  flush=True)
        return row

    rows = [measure(f) for f in gather_probe.formulations(table, idx)]
    by_name = {r["name"]: r for r in rows}
    by_name["gather_rows_cluster"] = by_name["gather_rows"]["cluster"] = \
        measure(gather_probe.cluster_formulation(table, idx))

    # the gathers against their plain versions at odd shapes, at the
    # clusters' capacity and past it, and on views at a storage offset
    twins = {"gather_flat": (gather.gather_flat, gather.gather_flat_plain),
             "gather_flat_smem": (gather.gather_flat_smem,
                                  gather.gather_flat_plain),
             "gather_rows": (gather.gather_rows, gather.gather_rows_plain),
             "gather_rows_cluster": (kg.gather_rows_cluster_cuda,
                                     gather.gather_rows_plain),
             "gather_cols": (gather.gather_cols, gather.gather_cols_plain)}
    for label, name, t, i in gather_probe.edge_cases(dev, limits=limits):
        kernel, plain = twins[name]
        before = kernels.launch_counts()
        got = kernel(t, i)
        counted = [k for k, v in kernels.launch_counts().items()
                   if v != before[k]]
        want = plain(t, i)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        print(f"{name}, {label}: table {tuple(t.shape)} at storage offset "
              f"{t.storage_offset()}, idx {tuple(i.shape)} at "
              f"{i.storage_offset()}, kernel {counted}, max|kernel - "
              f"plain| = {err!r} (bound 0)", flush=True)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({label})")
        by_name[name].setdefault("edge_checks", {})[label] = err
        if name == "gather_rows":
            # past every cluster: the cluster kernel's launch is refused
            try:
                kg.gather_rows_cluster_cuda(t, i)
            except RuntimeError as e:
                print(f"gather_rows_cluster, {label}: refused ({e})",
                      flush=True)
            else:
                raise AssertionError(f"gather_rows_cluster took {label}")
    return rows


def _phase14_multiprocess(np, torch, card, processes, shards):
    """The worker as ``processes`` processes of ``shards`` shards each (see
    the module docstring); every check raises on failure."""
    import json as js
    import os
    import shutil
    import socket
    import subprocess
    from pathlib import Path

    from rgbd_recon_tpu_torch import dist
    from rgbd_recon_tpu_torch.dist.worker import scene

    root = Path(__file__).resolve().parent
    dev = torch.device("cuda", 0)
    pipe, frames, camera = scene(dev)
    volume, maps, counts = pipe.fuse(frames)
    out = pipe.make_renderer(camera)(volume, maps, counts)
    vol8, out8 = dist.shard_pipeline_step(
        pipe, camera, dist.make_mesh(devices=[dev] * shards
                                     * processes))(frames)
    want = {"volume": volume, "color": out.color, "hit": out.hit}
    one = {"volume": vol8.gather(), "color": out8.color, "hit": out8.hit}
    for k in want:
        if not torch.equal(one[k], want[k]):
            raise AssertionError(f"the 8-shard step's {k} differs from the "
                                 "single device's")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        q for q in (str(root), env.get("PYTHONPATH")) if q)

    def workers(backend):
        """Run the workers; (returncodes, outputs, outdir)."""
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        outdir = root / "build" / "chip_smoke_mp" / backend
        shutil.rmtree(outdir, ignore_errors=True)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rgbd_recon_tpu_torch.dist.worker",
             "--process-id", str(i), "--num-processes", str(processes),
             "--coordinator", f"127.0.0.1:{port}", "--outdir", str(outdir),
             "--devices-per-process", str(shards), "--device", "cuda",
             "--backend", backend], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(processes)]
        deadline = time.monotonic() + MP_TIMEOUT_S
        outs = []
        try:
            for q in procs:
                o, _ = q.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                outs.append(o.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{backend} workers ran past "
                                 f"{MP_TIMEOUT_S} s") from None
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        return [q.returncode for q in procs], outs, outdir

    def bit_equal(backend):
        t0 = time.perf_counter()
        rcs, outs, outdir = workers(backend)
        wall = time.perf_counter() - t0
        if any(rcs) or not (outdir / "done").exists():
            raise AssertionError(f"{backend} workers failed ({rcs}):\n"
                                 + "\n".join(o[-3000:] for o in outs))
        meta = js.loads((outdir / "meta.json").read_text())
        got = {k: np.load(outdir / f"{k}.npy") for k in want}
        same = {k: bool(np.array_equal(got[k], want[k].cpu().numpy()))
                for k in want}
        launched = meta["launches_per_step"]
        print(f"multiprocess {backend}: {processes} processes x "
              f"{shards} shards on {meta['devices']}, spans "
              f"{meta['process_spans']}; bit-equal to the single device and "
              f"the 8-shard step of one process {same} "
              f"({int(out.hit.sum())} hits); process 0's launches a step "
              f"{launched}; bytes a step {meta['bytes_per_step']}; step "
              f"{meta['step_seconds'] * 1e3!r} ms (host clock, process 0, "
              f"after a warm-up), {wall:.1f} s for the whole run, on "
              f"{card}", flush=True)
        if not all(same.values()) or meta["process_spans"] != list(
                range(processes)):
            raise AssertionError(f"multiprocess {backend}: {same}, spans "
                                 f"{meta['process_spans']}")
        if (launched["surface_occ"] != shards
                or launched["sentinel_bake"] != shards
                or launched["brick_integrate"] != shards
                or launched["brick_mark"] != 1):
            raise AssertionError(f"multiprocess {backend}: process 0 "
                                 f"launched {launched}, not once a shard "
                                 f"of its {shards} (brick_mark once)")

    bit_equal("gloo")
    if torch.cuda.device_count() >= processes:
        bit_equal("nccl")
    else:
        rcs, outs, _ = workers("nccl")
        refused = all(rc != 0 for rc in rcs) and any(
            "NCCL refuses two ranks on one GPU" in o for o in outs)
        print(f"multiprocess nccl, both processes on the one card: refused "
              f"{refused} (exit codes {rcs}); NCCL with a card a process is "
              f"not run: one card", flush=True)
        if not refused:
            raise AssertionError("nccl with two ranks on one GPU was not "
                                 "refused:\n" + "\n".join(
                                     o[-3000:] for o in outs))


def _phase14_layouts(np, torch, card):
    """Phase 14 at each layout of MP_LAYOUTS this machine's cards allow."""
    t_phase = time.perf_counter()
    for processes, shards in MP_LAYOUTS:
        if processes == MP_LAYOUTS[0][0] or (
                torch.cuda.device_count() >= processes):
            _phase14_multiprocess(np, torch, card, processes, shards)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _phase15_preview(np, torch, card, work, sizes, color, by_path):
    """The app with the live preview, and the encoder's time (see the
    module docstring)."""
    import socket
    import statistics
    import struct
    import urllib.request

    from rgbd_recon_tpu_torch import app, kernels
    from rgbd_recon_tpu_torch.viz import jpeg
    from rgbd_recon_tpu_torch.viz.preview import PreviewServer

    served, update_ms = [], []
    publish = PreviewServer.update

    def update_then_fetch(self, image):
        # what the app's frame loop pays (the copy to the host), then the
        # viewer's fetch, which encodes on the server's thread
        t0 = time.perf_counter()
        publish(self, image)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/frame",
                                    timeout=10) as r:
            served.append(r.read())

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out_dir = work / "app_preview"
    argv = ["run", str(work / "scene.ks"), "--conf", str(work / "scene.conf"),
            "--streams", str(work / "rec"), "--no-native-ingest", "--frames",
            str(APP_FRAMES), "--out", str(out_dir), "--width", "1280",
            "--height", "720", *sizes, *PREVIEW_ARGS, "--preview-port",
            str(port)]
    kernels.reset_launch_counts()
    PreviewServer.update = update_then_fetch
    try:
        app.main(argv)
    finally:
        PreviewServer.update = publish
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    by_path["app_mode1_preview"] = launched
    want = {k: APP_FRAMES * MODE1_FRAME.get(k, 0) for k in launched}
    if launched != want:
        raise AssertionError(f"app_mode1_preview: launched {launched}, "
                             f"expected {want}")

    def frame_size(data):
        i = 2
        while data[i + 1] != 0xC0:
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
        return struct.unpack(">HH", data[i + 5:i + 9])

    sizes_ok = [d[:2] == b"\xff\xd8" and d[-2:] == b"\xff\xd9"
                and frame_size(d) == (720, 1280) for d in served]
    print(f"app_mode1_preview: launches {launched}; /frame after each of "
          f"{len(served)} frames: SOI, EOI and 1280x720 {sizes_ok}, "
          f"{[len(d) for d in served]} bytes; update() on the frame loop "
          f"{update_ms!r} ms (host clock, the copy to the host; the encode "
          f"runs on the server's thread), on {card}", flush=True)
    if len(served) != APP_FRAMES or not all(sizes_ok):
        raise AssertionError(f"preview: {len(served)} frames, {sizes_ok}")
    times = []
    for _ in range(JPEG_SAMPLES):
        t0 = time.perf_counter()
        data = jpeg.encode_jpeg(color, 80)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"jpeg encode of the fast path's 1280x720 render at quality 80: "
          f"{statistics.median(times)!r} ms (host clock, median of "
          f"{JPEG_SAMPLES}: {times}), {len(data)} bytes, on this card's "
          f"host ({card})", flush=True)


def _phase16_measure(torch, card, oracle_by_path):
    """The three measurement scripts of ``rgbd_recon_tpu_torch.bench`` at
    reference scale on one setup (see the module docstring)."""
    import math

    from rgbd_recon_tpu_torch.bench import ablation, render_sweep, stages
    from rgbd_recon_tpu_torch.bench.headline import REFERENCE, reference_setup
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    def positive(*times):
        return all(t is not None and math.isfinite(t) and t > 0.0
                   for t in times)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pipe, frames, camera = reference_setup(dev)
    two = pipe, render_sweep.two_sphere_frames(dev, bbox=pipe.bbox), camera
    print(f"measure: setup (bake, one- and two-sphere frames) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    abl = ablation.run(iters=MEASURE_ITERS, setup=(pipe, frames, camera),
                       out=ablation.OUT)
    for r in abl["rows"]:
        print(f"ablation {r['variant']}: surface RMSE {r['surface_rmse_mm']!r}"
              f" mm over {r['surface_hits']} hits, overflow {r['overflow']}; "
              f"fuse {r['fuse_ms']!r} ms (events {r['fuse_event_ms']!r}), "
              f"render {r['render_ms']!r} ms (events "
              f"{r['render_event_ms']!r}) on {card}", flush=True)
        if not (math.isfinite(r["surface_rmse_mm"])
                and positive(r["fuse_ms"], r["fuse_event_ms"],
                             r["render_ms"], r["render_event_ms"])):
            raise AssertionError(f"ablation {r['variant']}: {r}")
    print(f"ablation: launches {abl['launches']}; table {abl['table']}",
          flush=True)
    rows = {r["variant"]: r for r in abl["rows"]}
    for variant, path in (("fast defaults", "fast"),
                          ("reference-exact (all)", "parity")):
        got = (rows[variant]["surface_rmse_mm"],
               rows[variant]["surface_hits"])
        if got != oracle_by_path[path]:
            raise AssertionError(f"ablation {variant}: {got}, the {path} "
                                 f"path read {oracle_by_path[path]}")
    missing = [k for k in PATH_KERNELS if not abl["launches"].get(k)]
    if missing:
        raise AssertionError(f"ablation launched no {missing}")
    print("ablation: fast defaults and reference-exact (all) bit-equal to "
          "the fast and parity paths' RMSE and hits", flush=True)

    sweep = render_sweep.run(iters=MEASURE_ITERS, setup=two)
    for r in sweep["rows"]:
        print(f"sweep {r['variant']}: render {r['render_ms']!r} ms (events "
              f"{r['render_event_ms']!r}), hits {r['hits']}, overflow "
              f"{r['overflow']}, {r['diagnostics']} on {card}", flush=True)
        if not positive(r["render_ms"], r["render_event_ms"]):
            raise AssertionError(f"sweep {r['variant']}: {r}")
    fresh = TsdfPipeline(pipe.calib, REFERENCE.config(), pipe.bbox)
    out = fresh.make_renderer(camera)(*fresh.fuse(two[1]))
    want = (int(out.hit.sum()), out.overflow.tolist())
    base = sweep["rows"][0]
    if (base["hits"], base["overflow"]) != want:
        raise AssertionError(f"sweep baseline {base['hits']} hits, overflow "
                             f"{base['overflow']}; a fresh pipeline {want}")
    print(f"sweep: launches {sweep['launches']}; baseline equal to a fresh "
          f"pipeline's render ({want[0]} hits, overflow {want[1]})",
          flush=True)
    del fresh, out

    st = stages.run("all", iters=MEASURE_ITERS, setup=two)
    for part, res in st["parts"].items():
        for name, r in res["rows"].items():
            print(f"stages {part}/{name}: {r['ms']!r} ms (events "
                  f"{r['event_ms']!r})", flush=True)
            if not positive(r["ms"], r["event_ms"]):
                raise AssertionError(f"stages {part}/{name}: {r}")
    render = st["parts"]["render"]
    moved = render["moved_camera"]
    print(f"stages: occupied bricks {st['parts']['fuse']['occupied_bricks']}"
          f"; render hits {render['hits']}, overflow {render['overflow']}, "
          f"{render['diagnostics']}; moved-camera render {moved['ms']!r} ms, "
          f"rebuilt {moved['rebuilt']}; launches {st['launches']} on {card}",
          flush=True)
    if moved["rebuilt"] or not positive(moved["ms"]):
        raise AssertionError(f"stages: moved-camera render {moved}")
    del pipe, frames, two
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multiprocess", action="store_true",
                    help="build the kernels and run phase 14 alone")
    args = ap.parse_args(argv)
    # imports first: in a directory without the repo this fails before any
    # result is printed
    import numpy as np
    import torch

    from rgbd_recon_tpu_torch import kernels
    from rgbd_recon_tpu_torch.bench.headline import reference_setup
    from rgbd_recon_tpu_torch.bench.trace import card_line
    from rgbd_recon_tpu_torch.kernels import _build
    from rgbd_recon_tpu_torch.ops import bake, stencil13
    from rgbd_recon_tpu_torch.bench.trace import event_ms
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 1. build the kernels --------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)
    for src in _build.SOURCES:
        report = _build.BUILD_DIR / f"{src.stem}.ptxas.txt"
        print(f"ptxas -v, {src.name}:\n{report.read_text().strip()}",
              flush=True)
    if args.multiprocess:
        _phase14_layouts(np, torch, card)
        print(card)
        return 0

    # ---- 2. reference-scale setup ------------------------------------------
    t0 = time.perf_counter()
    pipe, frames, camera = reference_setup(dev)
    calib, cfg = pipe.calib, pipe.config
    renderer = pipe.make_renderer(camera)
    volume, maps, counts = pipe.fuse(frames)     # warm-up, fits the models
    renderer(volume, maps, counts)
    torch.cuda.synchronize()
    print(f"setup (bake, frames, fits, first fuse+render): "
          f"{time.perf_counter() - t0:.1f} s; volume {tuple(volume.shape)}",
          flush=True)

    # ---- 3. each kernel against its plain twin, main-path shapes -----------
    t_phase = time.perf_counter()
    d_m = maps.raw_depth.contiguous()
    limits = calib.depth_limits.contiguous()
    d_norm = maps.depth[..., 0].contiguous()
    vol = volume.contiguous()
    bv = pipe.brick_vox
    occ = bake.surface_occ_plain(vol, bv)
    bs_scaled = bake.brick_clearance(occ, cfg.skip_brick_rounds, bv)[1]
    K = cfg.skip_fine_rounds
    from rgbd_recon_tpu_torch.kernels.bake import (
        sentinel_bake_cuda,
        surface_occ_cuda,
    )
    from rgbd_recon_tpu_torch.kernels.stencil13 import (
        bilateral13_cuda,
        quality13_cuda,
    )

    # operations per tap (every tap: the range and its three border tests,
    # plus the border count in quality13; each non-border tap: the range
    # weight's division and subtraction and the sums) and per voxel (the
    # positive test, K rounds of three separable 2-max passes, the encode).
    # A quality13 centre d <= 0 needs no tap (all 169 are border taps, its
    # result is (169, 0)), so only the taps of the other centres count.
    near = limits[:, :1, None]
    far = limits[:, 1:, None]
    drm_b = d_m * stencil13._DRM_SCALE
    drm_q = 0.35 * d_norm
    ops = {
        "bilateral13": _stencil_ops(
            torch, d_m, lambda s: (s >= near) & (s <= far)
            & ((s - d_m).abs() <= drm_b), per_tap=5, per_kept=7),
        "quality13": _stencil_ops(
            torch, d_norm, lambda s: (s > 0.0) & (s < 1.0)
            & ((s - d_norm).abs() <= drm_q), per_tap=6, per_kept=3,
            centres=~(d_norm <= 0.0)),
        "surface_occ": 2 * vol.numel(),
        "sentinel_bake": (5 + 6 * K) * vol.numel(),
    }

    def surface_occ_library():
        # brick max-pool of the volume over each brick grown by one voxel
        pooled = torch.nn.functional.max_pool3d(
            vol[None, None], kernel_size=bv + 2, stride=bv, padding=1,
            ceil_mode=True)
        return pooled[0, 0] > 0.0

    cases = [
        ("bilateral13", "rgbd_recon_tpu_torch/csrc/stencil13.cu",
         "rgbd_recon_tpu/ops/stencil_pallas.py:153",
         lambda: bilateral13_cuda(d_m, limits),
         lambda: stencil13.bilateral13_plain(d_m, limits), None, [d_m, limits]),
        ("quality13", "rgbd_recon_tpu_torch/csrc/stencil13.cu",
         "rgbd_recon_tpu/ops/stencil_pallas.py:186",
         lambda: quality13_cuda(d_norm),
         lambda: stencil13.quality13_plain(d_norm), None, [d_norm]),
        ("surface_occ", "rgbd_recon_tpu_torch/csrc/bake.cu",
         "rgbd_recon_tpu/ops/bake_pallas.py:58",
         lambda: surface_occ_cuda(vol, bv),
         lambda: bake.surface_occ_plain(vol, bv), surface_occ_library,
         [vol]),
        ("sentinel_bake", "rgbd_recon_tpu_torch/csrc/bake.cu",
         "rgbd_recon_tpu/ops/bake_pallas.py:112",
         lambda: sentinel_bake_cuda(vol, bs_scaled, bv, K),
         lambda: bake.sentinel_bake_plain(vol, bs_scaled, bv, K), None,
         [vol, bs_scaled]),
    ]
    flush_write = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                              device=dev)
    flush_read = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)

    def flush():
        flush_write.fill_(1.0)
        flush_read.sum()

    results = []
    for name, source, replaces, kern, plain, library, inputs in cases:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        print(f"{name}: max|kernel - plain| = {err!r} (bound 0)", flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max abs error {err}")
        ms = event_ms(kern, iters=20, warmup=3)
        plain_ms = event_ms(plain, iters=5, warmup=1)
        device_ms, device_ms_warm, split, retakes = _device_ms(torch, kern,
                                                                flush)
        outs = list(got) if isinstance(got, tuple) else [got]
        bound_ms, bound_by = _bound(inputs + outs, ops[name])
        library_ms = library_device_ms = None
        if library is not None:
            if not torch.equal(library(), want):
                raise AssertionError(f"{name}: the library call computes "
                                     "another function")
            library_ms = event_ms(library, iters=20, warmup=3)
            library_device_ms, _, _, n = _device_ms(torch, library, flush)
            retakes += n
        row = dict(name=name, route="cuda", source=source,
                   replaces=replaces, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, device_ms=device_ms,
                   device_ms_warm=device_ms_warm, device_split=split,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / device_ms,
                   library_ms=library_ms,
                   library_device_ms=library_device_ms, ops=ops[name])
        if name == "sentinel_bake":
            # the f32 table of march_dtype="float32", also bit for bit
            got32 = sentinel_bake_cuda(vol, bs_scaled, bv, K, torch.float32)
            want32 = bake.sentinel_bake_plain(vol, bs_scaled, bv, K,
                                              torch.float32)
            torch.cuda.synchronize()
            err32 = _max_abs_err(torch, got32, want32)
            if not (got32.dtype == torch.float32 and err32 == 0.0):
                raise AssertionError(f"sentinel_bake f32: {got32.dtype}, "
                                     f"max|kernel - plain| = {err32}")
            def kern32():
                return sentinel_bake_cuda(vol, bs_scaled, bv, K,
                                          torch.float32)

            ms32 = event_ms(kern32, iters=20, warmup=3)
            dev32, dev32_warm, split32, n = _device_ms(torch, kern32, flush)
            retakes += n
            bound32 = _bound([vol, bs_scaled, got32], ops[name])[0]
            row.update(f32_max_abs_err=err32, f32_ms=ms32,
                       f32_device_ms=dev32, f32_device_ms_warm=dev32_warm,
                       f32_device_split=split32, f32_bound_ms=bound32,
                       f32_share_of_bound=bound32 / dev32)
            print(f"{name} f32: {ms32!r} ms (events), device {dev32!r} ms "
                  f"cold L2, {dev32_warm!r} warm {split32}, bound "
                  f"{bound32!r} ms, {bound32 / dev32:.1%} of it, on {card}",
                  flush=True)
            # 20 rounds in 20-voxel bricks (phase 9's bricks_20_rounds_20):
            # two dilation launches of 10 rounds, also bit for bit
            occ20 = bake.surface_occ_plain(vol, 20)
            bs20 = bake.brick_clearance(occ20, cfg.skip_brick_rounds, 20)[1]

            def kern20():
                return sentinel_bake_cuda(vol, bs20, 20, 20)

            def plain20():
                return bake.sentinel_bake_plain(vol, bs20, 20, 20)

            err20 = _max_abs_err(torch, kern20(), plain20())
            if err20 != 0.0:
                raise AssertionError(f"sentinel_bake K = 20: max|kernel - "
                                     f"plain| = {err20}")
            ms20 = event_ms(kern20, iters=20, warmup=3)
            plain_ms20 = event_ms(plain20, iters=3, warmup=1)
            dev20, _, _, n = _device_ms(torch, kern20, flush)
            retakes += n
            row.update(k20_max_abs_err=err20, k20_ms=ms20,
                       k20_plain_ms=plain_ms20, k20_device_ms=dev20)
            print(f"{name} K = 20, 20-voxel bricks: max|kernel - plain| = "
                  f"{err20!r}, {ms20!r} ms (events; plain {plain_ms20!r}), "
                  f"device {dev20!r} ms cold L2, on {card}", flush=True)
        print(f"{name}: {ms!r} ms (events; plain {plain_ms!r}, library "
              f"{library_ms!r}), device {device_ms!r} ms cold L2, "
              f"{device_ms_warm!r} warm {split} (library {library_device_ms!r}"
              f" cold), bound {bound_ms!r} ms by {bound_by}, "
              f"{bound_ms / device_ms:.1%} of it, on {card}", flush=True)
        # traces that torch.profiler handed back empty and were taken again
        row["trace_retakes"] = retakes
        if retakes:
            print(f"{name}: {retakes} profiler trace(s) came back with no "
                  f"device activity and were taken again", flush=True)
        results.append(row)

    results += _phase3_bake(torch, pipe, frames, camera, card, flush)
    results += _phase3_render(torch, pipe, frames, camera, card, flush)
    results += _phase3_fill(torch, pipe, camera, frames, card, flush)
    results += _phase3_hits(torch, pipe, camera, frames, card, flush)
    results += _phase3_preprocess(torch, pipe, frames, card, flush)
    results += _phase3_fuse(torch, pipe, frames, card, flush)
    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 13. the gather-rate probe, right after phase 3: torch.profiler
    # handed back only empty traces after phase 11's profile of a whole
    # refinement round (~111 k device activities) ---------------------------
    t_phase = time.perf_counter()
    results += _phase13_gather(np, torch, card, flush)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 4. the main path, counted -----------------------------------------
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    volume, maps, counts = pipe.fuse(frames)
    out = renderer(volume, maps, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    print(f"launches on the fast path: {launched}", flush=True)
    missing = [k for k in PATH_KERNELS if launched[k] <= 0]
    extra = [k for k, n in launched.items() if n and k not in PATH_KERNELS]
    fills = {k: launched[k] for k in FILL_LAUNCHES}
    hit_launches = {k: launched[k] for k in HIT_LAUNCHES}
    pre_launches = {k: launched[k] for k in PRE_LAUNCHES}
    stage_launches = {k: launched[k] for k in FRAME_KERNELS}
    if (missing or extra or launched["march"] != PATH_MARCHES["fast"]
            or fills != FILL_LAUNCHES or hit_launches != PATH_HITS["fast"]
            or pre_launches != PRE_LAUNCHES
            or stage_launches != PATH_FRAME["fast"]):
        raise AssertionError(f"fast path did not launch {missing}, "
                             f"launched {extra}, march "
                             f"{launched['march']} times, fill {fills}, "
                             f"hits {hit_launches}, preprocess "
                             f"{pre_launches}, stages {stage_launches}")
    by_path = {"fast": launched}
    # each path's oracle reading (phase 16's ablation must repeat them)
    oracle_by_path = {"fast": _check_render(torch, "fast", volume, out,
                                            counts, cfg, camera)}
    fast_hits = oracle_by_path["fast"][1]

    # the colour variants of phase 9 must leave these bit-equal
    fast = (out.hit.clone(), out.depth.clone())
    # phase 15 encodes this render
    fast_color = out.color.cpu().numpy()

    # ---- 5. timings (informative) ------------------------------------------
    fuse_ms = _timed(lambda: pipe.fuse(frames))
    frame_ms = _timed(_frame_fn(pipe, renderer, frames))
    print(f"fast: fuse ms {fuse_ms}, fuse+render ms {frame_ms} on {card}",
          flush=True)
    del volume, maps, counts, out

    print(f"phases 4-5: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 6. the side paths, counted and checked ----------------------------
    t_phase = time.perf_counter()
    for name, overrides in _side_paths().items():
        t0 = time.perf_counter()
        ppipe = TsdfPipeline(calib, dataclasses.replace(cfg, **overrides),
                             pipe.bbox)
        prender = ppipe.make_renderer(camera)
        _frame_fn(ppipe, prender, frames)()  # warm-up: fits the models
        torch.cuda.synchronize()
        print(f"{name}: setup + first fuse+render "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        kernels.reset_launch_counts()
        volume, maps, counts = ppipe.fuse(frames)
        out = prender(volume, maps, counts)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        print(f"launches on the {name} path: {launched}", flush=True)
        must, must_not = SIDE_LAUNCHES[name]
        missing = [k for k in must if launched[k] <= 0]
        extra = [k for k, n in launched.items()
                 if n > 0 and (k in must_not or k not in PATH_KERNELS)]
        fills = {k: launched[k] for k in FILL_LAUNCHES}
        hit_launches = {k: launched[k] for k in HIT_LAUNCHES}
        pre_launches = {k: launched[k] for k in PRE_LAUNCHES}
        stage_launches = {k: launched[k] for k in FRAME_KERNELS}
        if (missing or extra or launched["march"] != PATH_MARCHES[name]
                or fills != FILL_LAUNCHES
                or hit_launches != PATH_HITS[name]
                or pre_launches != PRE_LAUNCHES
                or stage_launches != PATH_FRAME[name]):
            raise AssertionError(f"{name} path: not launched {missing}, "
                                 f"launched {extra}, march "
                                 f"{launched['march']} times, fill {fills}, "
                                 f"hits {hit_launches}, preprocess "
                                 f"{pre_launches}, stages {stage_launches}")
        by_path[name] = launched
        oracle_by_path[name] = _check_render(torch, name, volume, out,
                                             counts, ppipe.config, camera)
        rmse = oracle_by_path[name][0]
        if name.startswith("parity"):
            print(f"{name}: surface RMSE {rmse!r} mm; BENCH_r05.json "
                  f"records {TPU_EXACT_RMSE_MM} mm for the JAX "
                  "reference-exact path, measured on a TPU", flush=True)
        else:
            render_fn, _ = ppipe.make_render_fn(camera)
            table = render_fn.bake(volume, counts)[0]
            print(f"{name}: march table {table.dtype}", flush=True)
            if table.dtype != torch.float32:
                raise AssertionError(f"{name}: march table {table.dtype}")
            del render_fn, table
        fuse_ms = _timed(lambda: ppipe.fuse(frames), samples=2, iters=3)
        frame_ms = _timed(_frame_fn(ppipe, prender, frames), samples=2,
                          iters=3)
        print(f"{name}: fuse ms {fuse_ms}, fuse+render ms {frame_ms} on "
              f"{card}", flush=True)
        del ppipe, prender, volume, maps, counts, out
        torch.cuda.empty_cache()

    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 7. the other reconstruction modes on the fast path's state -------
    t_phase = time.perf_counter()
    _phase7_modes(np, torch, pipe, frames, camera, card, fast_hits, by_path)
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 8. the application shell, every mode -----------------------------
    t_phase = time.perf_counter()
    app_work, app_sizes = _phase8_app(torch, pipe, frames, card, by_path)
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 9. the fast config's variants ------------------------------------
    t_phase = time.perf_counter()
    _phase9_variants(np, torch, pipe, frames, camera, card, fast, by_path)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 10. runtime reconfiguration under one renderer handle -----------
    t_phase = time.perf_counter()
    _phase10_reconfig(np, torch, pipe, frames, camera, card)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del renderer
    torch.cuda.empty_cache()

    # ---- 11. sensor-pose refinement at reference scale --------------------
    t_phase = time.perf_counter()
    drifted = _phase11_pose(np, torch, card)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 12. the multi-device layer, its shards on this card --------------
    t_phase = time.perf_counter()
    slab_checks = _phase12_dist(np, torch, pipe, frames, camera, card,
                                drifted, by_path)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del pipe, frames, drifted
    torch.cuda.empty_cache()

    # ---- 14. the mesh over two processes ----------------------------------
    _phase14_layouts(np, torch, card)

    # ---- 15. the live preview and its encoder ------------------------------
    t_phase = time.perf_counter()
    _phase15_preview(np, torch, card, app_work, app_sizes, fast_color,
                     by_path)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 16. the measurement scripts at reference scale --------------------
    t_phase = time.perf_counter()
    _phase16_measure(torch, card, oracle_by_path)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    for r in results:
        r["launches"] = by_path["fast"][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()}
        if r["name"] in slab_checks:
            r["slab_checks"] = slab_checks[r["name"]]

    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
