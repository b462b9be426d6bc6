"""The interval scan's and the hit shade's kernel algorithms on the CPU
(csrc/render_stages.cu scan_kernel, csrc/hits.cu shade_kernel), and the
whole render against the JAX package at the scan's edge cases.

The scan kernel splits a ray's samples over SCAN_LANES lanes of a warp:
each lane folds a contiguous run of them by the sequential rule (a NaN
held stays, a NaN arriving wins, else a strictly smaller value replaces;
larger for ``last``), and shuffles combine the runs with the lower samples
always on the left. ``_scan_fold_as_kernel`` models that (the brick codes
from a table, the runs, the combine tree) and is held bit for bit against
ops/render_stages.py scan_plain, whose minima and maxima are torch's
reductions over the samples, at the kernel's lane count and at others:
on the inputs a CPU render hands the scan, and on crafted grids and
cameras. The fold alone is held against torch's reductions on crafted
rows (signed-zero ties, NaNs, infinities).

The shade kernel adds each sensor's term of the blend to the sums in
sensor order from 0.0: ``_blend_as_kernel`` computes each term on its own
and folds them one by one, and is held bit for bit against the blends
ops/hits.py shade_hits_plain calls (the analytic projection models with
nearest and bilinear depth taps, the calibration volumes' trilinear and
nearest lookups) at 1, 3, 4 and 5 sensors.

Last, the port's whole CPU render against the JAX package's render of
the same state with an eye inside the surface bricks' box and with a
volume of no surface brick, at tests/test_torch_render.py's tolerances.
"""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_recon_tpu.calib import sensors as jax_sensors
from rgbd_recon_tpu.ops import preprocess as jax_preprocess
from rgbd_recon_tpu.ops.raymarch import ViewCamera as JaxCamera
from rgbd_recon_tpu.recon import tsdf_pipeline as jax_pipeline
from rgbd_recon_tpu_torch.ops import raymarch, render_stages
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.ops.sampling import quad_bilinear
from rgbd_recon_tpu_torch.ops.stage_calls import bits_equal, record_stages
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

from hit_cases import record_hits
from scan_cases import SCAN_CASES, scan_case
from test_torch_parity import (
    BBOX,
    CAM,
    PBBOX,
    SPHERE,
    _cfg,
    _np,
    _pcfg,
    port_calibration,
    port_synthetic,
    shared_hits,
)

torch.set_num_threads(2)

CSRC = (Path(__file__).resolve().parent.parent / "rgbd_recon_tpu_torch"
        / "csrc")


def _constant(source: str, name: str) -> int:
    """The value of ``constexpr int name`` in csrc/``source``."""
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, (source, name)
    return int(m.group(1))


SCAN_LANES = _constant("render_stages.cu", "SCAN_LANES")
# the kernel's lane count, another power of two, and one lane (the
# sequential fold)
LANES = sorted({SCAN_LANES, 16 if SCAN_LANES != 16 else 8, 1})
INF = float("inf")


@pytest.fixture(scope="module")
def verify():
    """The verify scene (4 sensors, 5 cm voxels in 20 cm bricks, the fast
    config) fused on the CPU and rendered at 96x80: (pipeline, volume,
    maps, counts, the scan's recorded call, the shade's recorded call)."""
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    calib = port_calibration(rig, PBBOX, cv_res=(24, 32, 24),
                             inv_res=(40, 44, 40), device="cpu")
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    pipe = TsdfPipeline(calib, _pcfg(), PBBOX)
    volume, maps, counts = pipe.fuse(frames)
    render, cam = pipe.make_render_fn(ViewCamera(**CAM))
    args = (render.bake(volume, counts), maps, cam,
            pipe._get_projection_models(), pipe._limit)
    hit_calls = {}

    def frame():
        hit_calls.update(record_hits(lambda: render.render_from_baked(*args)))

    calls = record_stages(frame)
    (scan,) = [c for c in calls if c[0] == "scan"]
    return pipe, volume, maps, counts, scan, hit_calls["shade"]


# ---- the scan ---------------------------------------------------------------

def fold_min(acc, v):
    """The kernel's fold of a minimum: a NaN held stays, a NaN arriving
    wins, else a strictly smaller value replaces."""
    return torch.where(~torch.isnan(acc) & (torch.isnan(v) | (v < acc)), v,
                       acc)


def fold_max(acc, v):
    return torch.where(~torch.isnan(acc) & (torch.isnan(v) | (v > acc)), v,
                       acc)


def lane_fold(rows, lanes, fold, identity):
    """The kernel's fold of each row of ``rows`` (R, n) over ``lanes``
    lanes: lane j folds samples [j * run, (j + 1) * run) (run = ceil(n /
    lanes), cut at n) in order from ``identity``, then at step s = 1, 2,
    4, ... each lane j with j % 2s == 0 folds in lane j + s's partial
    (shuffled down): the lower samples' run on the left."""
    R, n = rows.shape
    run = -(-n // lanes)
    part = []
    for j in range(lanes):
        acc = torch.full((R,), identity, dtype=rows.dtype)
        for k in range(min(j * run, n), min((j + 1) * run, n)):
            acc = fold(acc, rows[:, k])
        part.append(acc)
    s = 1
    while s < lanes:
        for j in range(0, lanes, 2 * s):
            part[j] = fold(part[j], part[j + s])
        s *= 2
    return part[0]


def brick_division(bv):
    """(shift, magic) of the scan kernel's floor division by ``bv`` of
    0 <= v < 2^31: v // bv == (v * magic) >> shift, magic = ceil(2^shift
    / bv), shift = 31 + ceil(log2 bv)."""
    shift = 31 + (bv - 1).bit_length()
    return shift, -(-(1 << shift) // bv)


@pytest.mark.parametrize("bv", [1, 2, 3, 4, 5, 7, 10, 16, 20, 25, 64, 255,
                                1000, 46_341])
def test_scan_brick_division_is_exact(bv):
    """The kernel's magic product equals v // bv (and its product fits 64
    bits) over 0..5,000, seeded draws up to 2^31 - 1, and the multiples
    of bv and their neighbours just under 2^31."""
    shift, magic = brick_division(bv)
    assert magic <= 2 ** 32
    rng = np.random.default_rng(bv)
    top = (2 ** 31 - 1) // bv * bv
    v = np.concatenate([
        np.arange(5000), rng.integers(0, 2 ** 31, 100_000),
        np.arange(top - 3 * bv, top + 1) if top >= 3 * bv else [],
        [2 ** 31 - 2, 2 ** 31 - 1]]).astype(np.uint64)
    v = v[v < 2 ** 31]
    np.testing.assert_array_equal((v * np.uint64(magic)) >> np.uint64(shift),
                                  v // np.uint64(bv))


def _scan_fold_as_kernel(g, occ, bsafe, cam, lanes):
    """(scan5 (5, Hs, Ws), surface-brick count) as csrc/render_stages.cu's
    scan computes them at ``lanes`` lanes a ray: each sample's brick read
    from the table of codes (-1 surface, 0 clear, 1 other) the kernel
    stages at the brick index of :func:`brick_division`, a sample outside
    the interval leaving the fold as it is, and first / last / fsurf by
    :func:`lane_fold`. The per-ray values (the
    surface bricks' box, the slab test, the spacing) and each sample's
    arithmetic are the twin's, in its order."""
    Z, Y, X = g.vol_shape
    bv, n = g.brick_vox, g.n_scan
    Bz, By, Bx = occ.shape
    code = torch.where(occ, -1, torch.where(bsafe == 0.0, 0, 1)).reshape(-1)
    box_min, box_max = render_stages.surface_aabb(g, occ)
    d = [x[::g.sc, ::g.sc].reshape(-1)
         for x in render_stages._block_centres(g, cam)]
    e = cam.eye_vol
    lo, hi = [], []
    for a in range(3):
        inv = 1.0 / d[a]
        tb = inv * (box_min[a] - e[a])
        tt = inv * (box_max[a] - e[a])
        lo.append(torch.minimum(tb, tt))
        hi.append(torch.maximum(tb, tt))
    s0 = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    s1 = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    valid = (s0 <= s1) & (s1 > 0.0)
    s0 = torch.clamp_min(s0, 0.0)
    s1 = torch.where(valid, s1, -1.0)
    spacing = torch.clamp_max((s1 - s0) / (n - 1), g.step_len)
    t = s0[:, None] + torch.arange(n, dtype=torch.float32) * spacing[:, None]
    shift, magic = brick_division(bv)
    bi = [torch.clamp_max(
        (torch.clamp_min(((e[a] + d[a][:, None] * t) * size).to(torch.int32),
                         0).to(torch.int64) * magic) >> shift, nb - 1)
          for a, (size, nb) in enumerate(((X, Bx), (Y, By), (Z, Bz)))]
    c = code[((bi[2] * By + bi[1]) * Bx + bi[0]).to(torch.int64)]
    inside = valid[:, None] & (t <= s1[:, None])
    first = lane_fold(torch.where((c <= 0) & inside, t, INF), lanes,
                      fold_min, INF)
    last = lane_fold(torch.where((c < 0) & inside, t, -INF), lanes,
                     fold_max, -INF)
    fsurf = lane_fold(torch.where((c < 0) & inside, t, INF), lanes,
                      fold_min, INF)
    out = torch.stack([first, last, fsurf, s0, torch.where(valid, s1, 0.0)])
    return out.reshape(5, g.Hs, g.Ws), int(occ.sum())


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", SCAN_CASES)
def test_scan_lane_fold_matches_plain(verify, name, lanes):
    """_scan_fold_as_kernel bit for bit against scan_plain (all five
    planes, NaNs and signed zeros included) and the surface-brick count,
    at the kernel's lane count and at others."""
    g, occ, bsafe, cam = scan_case(*verify[4][1][:4], name)
    counts = torch.full((5,), -1, dtype=torch.int32)
    want = render_stages.scan_plain(g, occ, bsafe, cam, counts, 4)
    got, count = _scan_fold_as_kernel(g, occ, bsafe, cam, lanes)
    assert bits_equal(got, want)
    assert count == int(counts[4])
    valid = want[4] > 0.0
    if name == "no_surface_brick":
        # the box lo = n, hi = -1 of no brick: no surface sample
        assert count == 0 and not bool(torch.isfinite(want[1]).any())
    elif name == "eye_inside_box":
        assert bool((valid & (want[3] == 0.0)).any())
    elif name == "axis_parallel_on_face":
        assert bool(torch.isnan(want[3]).all())
    else:
        assert bool(torch.isfinite(want[0]).any())


def test_scan_variant_sources():
    """bench/scan_variants.py's variant sources: the scan's two launch
    constants set, the floor-division brick index in place of the magic
    product; at the kernel's own constants the source unchanged; and the
    script exits 1 without a card, before any build."""
    from rgbd_recon_tpu_torch.bench import scan_variants as sv

    text = sv.SOURCE.read_text()
    blocks = _constant("render_stages.cu", "SCAN_BLOCKS_PER_SM")
    assert sv.variant_source(text, SCAN_LANES, blocks, False) == text
    for lanes, bps, floor in sv.VARIANTS.values():
        out = sv.variant_source(text, lanes, bps, floor)
        assert f"constexpr int SCAN_LANES = {lanes};" in out
        assert f"constexpr int SCAN_BLOCKS_PER_SM = {bps};" in out
        assert (sv.FLOOR_INDEX in out) == floor
        assert (sv.MAGIC_INDEX in out) != floor
    assert sv.main([]) == 1


def _fold_rows(seed, n):
    """(96, n) crafted rows: values of one small set (signed zeros, NaN,
    infinities), so that minima tie between -0.0 and +0.0 and NaNs arrive
    before, at and after the extremes."""
    rng = np.random.default_rng(seed)
    pool = np.array([-0.0, 0.0, 0.5, 1.0, INF, -INF, np.nan], np.float32)
    p = [0.2, 0.2, 0.15, 0.15, 0.12, 0.12, 0.06]
    rows = rng.choice(pool, size=(96, n), p=p).astype(np.float32)
    rows[0] = 0.0
    rows[1] = -0.0
    rows[2, ::2], rows[2, 1::2] = -0.0, 0.0
    rows[3, ::2], rows[3, 1::2] = 0.0, -0.0
    rows[4] = INF
    return torch.from_numpy(rows)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n", [1, 7, 53, 64])
def test_scan_fold_rule_matches_torch_reductions(n, lanes):
    """lane_fold of the min and max rules against scan_intervals'
    reductions (torch's min / max over the samples: the first NaN, else
    the first of the extreme values) on crafted rows, bit for bit."""
    rows = _fold_rows(n, n)
    assert bits_equal(lane_fold(rows, lanes, fold_min, INF),
                      rows.min(dim=-1).values)
    assert bits_equal(lane_fold(rows, lanes, fold_max, -INF),
                      rows.max(dim=-1).values)


# ---- the shade's blend ------------------------------------------------------

def _sensors(x, picks):
    return x[torch.tensor(picks)]


def _blend_inputs(shade_call, picks):
    """(world position, volume position, projection models, calibration
    volumes, colour, depth, quality, limit) of the recorded shade call
    with the sensors ``picks`` (4 recorded; 5 repeats sensor 0)."""
    args, _ = shade_call
    calib, bbox, hit_pos, maps, models, limit = (args[1], args[2], args[4],
                                                 args[5], args[6], args[10])
    bbox_sz = torch.tensor(bbox.size, dtype=torch.float32)
    world = hit_pos * bbox_sz + calib.bbox_min
    models = dataclasses.replace(models, **{
        f.name: _sensors(getattr(models, f.name), picks)
        for f in dataclasses.fields(models)})
    return SimpleNamespace(
        world=world, pos=hit_pos, models=models,
        cv_inv=_sensors(calib.cv_xyz_inv, picks),
        cv_uv=_sensors(calib.cv_uv, picks),
        color=_sensors(maps.color, picks),
        depth=_sensors(maps.depth[..., 0], picks),
        quality=_sensors(maps.quality, picks), limit=limit)


def _term_analytic(b, i, dq_taps):
    """Sensor i's term of blend_colors_analytic: (colour * w (..., 3), w,
    colour * w2, w2)."""
    H, W = b.depth.shape[1:3]
    px, py, pz = b.world[..., 0], b.world[..., 1], b.world[..., 2]
    u, v, d = b.models.uvd_p(i, px, py, pz)
    in_frustum = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                  & (d >= 0.0) & (d <= 1.0))
    cu, cv_ = b.models.color_uv_p(i, px, py, pz)
    col = quad_bilinear(b.color.to(torch.bfloat16)[i], cu, cv_)
    dq = torch.stack([b.depth, b.quality], dim=-1)
    if dq_taps == "nearest":
        xi = torch.clamp((u * W).to(torch.int32), 0, W - 1)
        yi = torch.clamp((v * H).to(torch.int32), 0, H - 1)
        dqv = dq[i].reshape(H * W, 2)[(yi * W + xi).to(torch.int64)]
    else:
        dqv = quad_bilinear(dq[i], u, v)
    dist = torch.abs(dqv[..., 0] - d)
    qual = torch.where((dist < b.limit) & in_frustum, dqv[..., 1], 0.0)
    w = qual / (dist + 0.01)
    w2 = torch.where(in_frustum, 1.0 / torch.clamp_min(dist, 1e-20), 0.0)
    return col * w[..., None], w, col * w2[..., None], w2


def _term_volume(b, i, fast):
    """Sensor i's term of blend_colors (trilinear lookups) or
    blend_colors_fast (nearest lookups)."""
    from rgbd_recon_tpu_torch.ops.sampling import (
        bilinear_2d,
        nearest_3d,
        pair_bilinear,
        trilinear_3d,
    )

    dq = torch.stack([b.depth, b.quality], dim=-1)
    if fast:
        look = nearest_3d(b.cv_inv[i], b.pos)
        pc = nearest_3d(b.cv_uv[i], look[..., :3])
        col = pair_bilinear(b.color.to(torch.bfloat16)[i], pc[..., 0],
                            pc[..., 1])
        dqv = pair_bilinear(dq[i], look[..., 0], look[..., 1])
    else:
        look = trilinear_3d(b.cv_inv[i], b.pos)
        pc = trilinear_3d(b.cv_uv[i], look[..., :3])[..., :2]
        col = bilinear_2d(b.color[i], pc)
        dqv = bilinear_2d(dq[i], look[..., :2])
    in_frustum = look[..., 3] > 0.99
    dist = torch.abs(dqv[..., 0] - look[..., 2])
    qual = torch.where((dist < b.limit) & in_frustum, dqv[..., 1], 0.0)
    w = qual / (dist + 0.01)
    w2 = torch.where(in_frustum, 1.0 / torch.clamp_min(dist, 1e-20), 0.0)
    return col * w[..., None], w, col * w2[..., None], w2


def _blend_as_kernel(b, kind, n_sensors):
    """The blend as csrc/hits.cu's shade folds it: each sensor's term on
    its own, the sums folded term by term in sensor order from 0.0, then
    the analytic blend's products by reciprocals or the volumes'
    divisions."""
    terms = [(_term_analytic(b, i, kind.split("_")[1])
              if kind.startswith("analytic")
              else _term_volume(b, i, kind == "volume_fast"))
             for i in range(n_sensors)]
    acc = [torch.zeros_like(x) for x in terms[0]]
    for term in terms:
        acc = [a + t for a, t in zip(acc, term)]
    c, w, c2, w2 = acc
    primary = w > 0.0
    if kind.startswith("analytic"):
        rgb = torch.where(primary[..., None],
                          c * (1.0 / torch.clamp_min(w, 1e-20))[..., None],
                          c2 * (1.0 / torch.clamp_min(w2, 1e-20))[..., None])
    else:
        rgb = torch.where(primary[..., None],
                          c / torch.clamp_min(w, 1e-20)[..., None],
                          c2 / torch.clamp_min(w2, 1e-20)[..., None])
    alpha = torch.where(primary, 1.0, -1.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _blend_plain(b, kind):
    """The blend shade_hits_plain calls for ``kind``."""
    if kind.startswith("analytic"):
        return raymarch.blend_colors_analytic(
            b.world, b.models, b.color, b.depth, b.quality, b.limit,
            dq_taps=kind.split("_")[1])
    blend = (raymarch.blend_colors_fast if kind == "volume_fast"
             else raymarch.blend_colors)
    return blend(b.pos, b.cv_inv, b.cv_uv, b.color, b.depth, b.quality,
                 b.limit)


BLENDS = ["analytic_nearest", "analytic_bilinear", "volume", "volume_fast"]
# the sensors of each count, of the recorded 4 (5: sensor 0 again, last)
PICKS = {1: [2], 3: [0, 1, 2], 4: [0, 1, 2, 3], 5: [0, 1, 2, 3, 0]}


@pytest.mark.parametrize("sensors", sorted(PICKS))
@pytest.mark.parametrize("kind", BLENDS)
def test_shade_sensor_fold_matches_plain(verify, kind, sensors):
    """The blends shade_hits_plain calls equal the sequential fold of the
    per-sensor terms, each computed on its own as the shade kernel does,
    bit for bit, at 1, 3, 4 and 5 sensors, on the verify render's hits."""
    b = _blend_inputs(verify[5], PICKS[sensors])
    want = _blend_plain(b, kind)
    got = _blend_as_kernel(b, kind, sensors)
    assert bits_equal(got, want)
    assert bool((want[..., 3] == 1.0).any())


# ---- the whole render against the JAX package -----------------------------

def _fields(container):
    return {f.name: jnp.asarray(_np(getattr(container, f.name)))
            for f in dataclasses.fields(container)}


# an eye inside the surface bricks' box (the scan's s0 clamped to 0),
# looking at the sphere; and the verify camera over a volume of no
# surface brick (every scan interval empty)
EDGE_RENDERS = {
    "eye_inside_box": dict(width=96, height=80, eye=(0.45, 1.55, 0.45),
                           target=(0.0, 1.1, 0.0)),
    "no_surface_brick": CAM,
}


@pytest.mark.parametrize("name", sorted(EDGE_RENDERS))
def test_render_edge_cases_match_jax(verify, name):
    """The port's CPU render of the verify scene's fused state against the
    JAX package's render of the same state (colorfill off), with an eye
    inside the surface bricks' box and over a volume of no surface brick:
    hit masks equal but at 0.5% of pixels, window depth to 2e-4 and colour
    to 1e-3 on shared hits, overflow and march steps equal
    (tests/test_torch_render.py's tolerances)."""
    pipe, volume, maps, counts, _, _ = verify
    if name == "no_surface_brick":
        volume = torch.full_like(volume, -1.0)
    cam = EDGE_RENDERS[name]
    ppipe = TsdfPipeline(pipe.calib, _pcfg(colorfill=False), PBBOX)
    got = ppipe.make_renderer(ViewCamera(**cam))(volume, maps, counts)
    jpipe = jax_pipeline.TsdfPipeline(
        jax_sensors.CalibrationSet(**_fields(pipe.calib)),
        _cfg(colorfill=False), BBOX)
    want = jpipe.make_renderer(JaxCamera(**cam))(
        jnp.asarray(_np(volume)),
        jax_preprocess.SensorMaps(**_fields(maps)),
        jnp.asarray(_np(counts)))
    jax.block_until_ready(want)
    hj, hp = np.asarray(want.hit), _np(got.hit)
    assert (hj != hp).sum() <= 0.005 * hj.size
    if name == "no_surface_brick":
        assert hj.sum() == 0 and hp.sum() == 0
    else:
        assert hj.sum() > 300
    m = shared_hits(want, got)
    np.testing.assert_allclose(_np(got.depth)[m], np.asarray(want.depth)[m],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(got.color)[m], np.asarray(want.color)[m],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(_np(got.overflow), np.asarray(want.overflow))
    np.testing.assert_array_equal(_np(got.num_samples),
                                  np.asarray(want.num_samples))
