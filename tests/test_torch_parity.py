"""Unit parity of the reference-exact path's modules against the JAX package:
trilinear taps, the trilinear march (state, resume, unit-cube entry), the
table-based secant refine and gradient, the three color blends, bilinear
brick integration, dense integration and the voxel-mask expansion; the
projection-model fallback of the pipeline; and the configuration table and
runner shared by the whole-slice files tests/test_torch_slice_*.py.

Inputs come from seeds with numpy, or from the port's own small scene (the
verify scene: 4 sensors at 64x56, 5 cm voxels, a 0.55 m sphere), and are
fed to both packages as numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.calib import sensors as jax_sensors
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import bricks as jax_bricks
from rgbd_recon_tpu.ops import holefill as jax_holefill
from rgbd_recon_tpu.ops import raymarch as jax_raymarch
from rgbd_recon_tpu.ops import tsdf as jax_tsdf
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.sensors import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
    derive_projection_models,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.ops import bricks as port_bricks
from rgbd_recon_tpu_torch.ops import holefill as port_holefill
from rgbd_recon_tpu_torch.ops import raymarch as port_raymarch
from rgbd_recon_tpu_torch.ops import tsdf as port_tsdf
from rgbd_recon_tpu_torch.ops.bake import sentinel_bake_plain
from rgbd_recon_tpu_torch.ops.sampling import pair_trilinear
from rgbd_recon_tpu_torch.recon import tsdf_pipeline as port_pipeline
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

torch.set_num_threads(2)

# each package builds its own box and configs from the same arguments
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
CAM = dict(width=96, height=80, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0))
LIMIT = 0.02

# bench.py's reference-exact parity config (bench.py:227-236)
PARITY = dict(march_mode="trilinear", march_empty_skip=False,
              integrate_taps="bilinear", mark_stride=1,
              projection_model=False, march_dtype="float32")
# the whole-slice configurations, on top of the verify scene's config
SLICE_CONFIGS = {
    "parity": PARITY,
    # scripts/make_golden.py's config: dense integrate + render_dense
    "parity_dense": dict(PARITY, bricking=False, skip_space=False),
    "no_skip": dict(march_empty_skip=False),
    "no_proj": dict(projection_model=False),
    "bilinear_taps": dict(integrate_taps="bilinear"),
    "no_oct": dict(oct_hit_table=False),
    "no_surface_skip": dict(surface_skip=False),
    "dense_nearest": dict(ray_compaction=0.0),
    # a brick of 3.2 voxels: dense integrate gated by the occupied bricks
    "brick_frac": dict(voxel_size=0.0625),
    # the fast path with an f32 sentinel table (and f32 oct table)
    "sentinel_f32": dict(march_dtype="float32"),
    # the variants of tests/test_torch_slice_variants*.py: the camera-
    # influence view, the normal-weighted blends, the profiling switches
    "shade_mode_3": dict(shade_mode=3),
    "best_two": dict(blend_mode="best_two"),
    "normal_deviation": dict(blend_mode="normal_deviation"),
    "debug_skip": dict(debug_skip="blend,grad,refine"),
    # per-block brackets, the chunked fine march, and both (the pairing
    # core/config.py describes); 16 dilation rounds, past the 4 voxels of
    # a brick (the plain bake, as the JAX package's jnp bake)
    "bracket_per_block": dict(bracket_per_block=True),
    "march_chunk": dict(march_chunk=8),
    "march_chunk_per_block": dict(march_chunk=8, bracket_per_block=True),
    "skip_fine_rounds_16": dict(skip_fine_rounds=16),
    # the render levers of scripts/bench_render_sweep.py:46-53 (the port's
    # bench/render_sweep.py) that change the march: fewer compacted
    # blocks, a longer phase 1, a finer interval scan, fewer compacted hits
    "ray_compaction_025": dict(ray_compaction=0.25),
    "phase1_16": dict(march_phase1_steps=16),
    "step_frac_0125": dict(interval_step_frac=0.125),
    "hit_compaction_035": dict(hit_compaction=0.35),
}
# the verify scene's config
BASE_CFG = dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=LIMIT,
                num_lods=5)


def _cfg(**kw):
    """The JAX package's config of the verify scene."""
    return PipelineConfig(**{**BASE_CFG, **kw})


def _pcfg(**kw):
    """The port's config from the same arguments."""
    return PortConfig(**{**BASE_CFG, **kw})


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def jax_arrays(container):
    """{field: numpy array} of a JAX-package container: the form in which
    JAX state crosses to the port (its convert.*_from_numpy)."""
    return {f.name: np.asarray(getattr(container, f.name))
            for f in dataclasses.fields(container)}


# ---- whole-slice runner (used by tests/test_torch_slice_*.py) -------------

def slice_setup():
    """Both packages' calibration and frames of the verify scene."""
    rig = default_test_rig(num_sensors=4, bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    prig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    pcalib = port_calibration(prig, PBBOX, cv_res=(24, 32, 24),
                              inv_res=(40, 44, 40), device="cpu")
    pframes = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), prig, device="cpu")
    return calib, frames, pcalib, pframes


def capturing_fills(store):
    """Pull-push fills of both packages that record their pre-fill planes
    (r, g, b, alpha, window depth) as numpy in ``store``; the jitted JAX
    render hands them over through a debug callback."""
    jax_fill = jax_holefill.fill_colors_planar
    port_fill = port_holefill.fill_colors_planar

    def record_jax(*arrays):
        store["jax"] = [np.array(a) for a in arrays]

    def jfill(planes, depth, num_lods):
        jax.debug.callback(record_jax, *planes, depth)
        return jax_fill(planes, depth, num_lods)

    def pfill(planes, depth, num_lods):
        store["port"] = [_np(p) for p in planes] + [_np(depth)]
        return port_fill(planes, depth, num_lods)

    return jfill, pfill


def run_slice(setup, name):
    """Fuse + render of configuration ``name`` in both packages. Returns
    {"jax": (volume, RenderOutput), "port": (volume, RenderOutput),
    "prefill": {"jax": planes, "port": planes}}."""
    calib, frames, pcalib, pframes = setup
    cfg = _cfg(**SLICE_CONFIGS[name])
    pcfg = _pcfg(**SLICE_CONFIGS[name])
    out = {"prefill": {}}
    jfill, pfill = capturing_fills(out["prefill"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_holefill, "fill_colors_planar", jfill)
        mp.setattr(port_holefill, "fill_colors_planar", pfill)
        pipe = TsdfPipeline(calib, cfg, BBOX)
        vol, maps, counts = pipe.fuse(frames)
        jax_out = pipe.make_renderer(ViewCamera(**CAM))(vol, maps, counts)
        jax.block_until_ready(jax_out)
        jax.effects_barrier()
        ppipe = port_pipeline.TsdfPipeline(pcalib, pcfg, PBBOX)
        pvol, pmaps, pcounts = ppipe.fuse(pframes)
        port_out = ppipe.make_renderer(port_raymarch.ViewCamera(**CAM))(
            pvol, pmaps, pcounts)
    out["jax"] = (vol, jax_out)
    out["port"] = (pvol, port_out)
    return out


def shared_hits(jax_out, port_out):
    """Pixels that hit in both and are not next to a hit-mask mismatch
    (tests/test_golden.py's knife-edge rule)."""
    hj, hp = _np(jax_out.hit), _np(port_out.hit)
    mis = torch.from_numpy((hj != hp).astype(np.float32))[None, None]
    near = torch.nn.functional.max_pool2d(mis, 3, stride=1, padding=1)
    return hj & hp & ~(near[0, 0].numpy() > 0)


def check_volume(run):
    """tests/test_golden.py's volume tolerance."""
    np.testing.assert_allclose(_np(run["port"][0]), _np(run["jax"][0]),
                               rtol=1e-4, atol=1e-6)


def check_hits(run):
    """Hit masks equal except at most 0.5% of pixels (knife edges)."""
    hj, hp = _np(run["jax"][1].hit), _np(run["port"][1].hit)
    assert hj.sum() > 300
    assert (hj != hp).sum() <= 0.005 * hj.size


def check_depth(run):
    """Window depth at atol 2e-4 on shared hits."""
    jo, po = run["jax"][1], run["port"][1]
    m = shared_hits(jo, po)
    np.testing.assert_allclose(_np(po.depth)[m], _np(jo.depth)[m], rtol=0,
                               atol=2e-4)


def check_prefill_color(run):
    """Blended, shaded colors before the pull-push fill at atol 1e-3 on
    shared hits, and the same quality/fallback alpha."""
    m = shared_hits(run["jax"][1], run["port"][1])
    pj, pp = run["prefill"]["jax"], run["prefill"]["port"]
    for a, b in zip(pp[:4], pj[:4]):
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=1e-3)


def check_overflow_and_samples(run):
    """Overflow counters equal; per-pixel march step counts equal except at
    knife edges: the JAX CPU compiler contracts the ray-direction products
    into FMAs, so about half of the directions differ from the port's by
    an ulp, and a nearest sample that lands on a voxel face can move a hit
    by one step. At most 8 pixels (0.1%) may differ, by one step each."""
    jo, po = run["jax"][1], run["port"][1]
    np.testing.assert_array_equal(_np(po.overflow), _np(jo.overflow))
    nj = _np(jo.num_samples).astype(np.int64)
    npp = _np(po.num_samples).astype(np.int64)
    diff = np.abs(nj - npp)
    assert (diff > 0).sum() <= 8 and diff.max() <= 1


# ---- scene inputs for the unit tests --------------------------------------

@pytest.fixture(scope="module")
def scene():
    """The port's calibration and fused maps of the verify scene, and 256
    random points on the sphere's surface (volume-normalized), as numpy."""
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    calib = port_calibration(rig, PBBOX, cv_res=(24, 32, 24),
                             inv_res=(40, 44, 40), device="cpu")
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    pipe = port_pipeline.TsdfPipeline(calib, _pcfg(), PBBOX)
    volume, maps, counts = pipe.fuse(frames)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    world = np.asarray(SPHERE[0][0]) + d * SPHERE[0][1]
    bmin, bsize = np.asarray(PBBOX.min), np.asarray(PBBOX.size)
    models, residual = derive_projection_models(calib.cv_xyz, calib.cv_uv)
    assert residual < 2e-3
    return dict(
        cv_xyz_inv=_np(calib.cv_xyz_inv), cv_uv=_np(calib.cv_uv),
        color=_np(maps.color), depth=_np(maps.depth[..., 0]),
        quality=_np(maps.quality), silhouette=_np(maps.silhouette),
        counts=_np(counts), volume=_np(volume), models=models,
        sample_pos=((world - bmin) / bsize).astype(np.float32),
        world_pos=world.astype(np.float32), pipe=pipe,
    )


def _sphere_volume(shape, limit=LIMIT):
    """TSDF-like (Z, Y, X) volume of a sphere, clamped to +-limit."""
    z, y, x = np.meshgrid(*(np.arange(s) + 0.5 for s in shape),
                          indexing="ij")
    Z, Y, X = shape
    r = np.sqrt((x - X / 2) ** 2 + (y - Y / 2) ** 2 + (z - Z / 2) ** 2)
    return np.clip((min(shape) * 0.3 - r) * limit * 0.4, -limit,
                   limit).astype(np.float32)


def _rays(rng, n, eye=None):
    """Planar unit directions; from ``eye`` toward random points inside the
    unit cube when it is given."""
    if eye is None:
        d = rng.normal(size=(3, n))
    else:
        d = rng.uniform(0.1, 0.9, (3, n)) - np.asarray(eye)[:, None]
        d[:, : n // 8] = rng.normal(size=(3, n // 8))      # some miss
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return d.astype(np.float32)


# ---- sampling -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16_half_floor"])
def test_pair_trilinear_matches(kind):
    """pair_trilinear against PackedVolume.sample_trilinear_p on positions
    that reach past every face: the f32 pair layout, a bf16 table, and a
    bf16 sentinel-coded table in the half-pair layout with clamp_floor."""
    rng = np.random.default_rng(11)
    vol = rng.uniform(-LIMIT, LIMIT, (6, 7, 10)).astype(np.float32)
    floor = None
    if kind == "bf16_half_floor":
        vol[rng.random(vol.shape) < 0.3] = -5.0          # sentinels
        floor = -LIMIT
    p = rng.uniform(-0.15, 1.15, (3, 500)).astype(np.float32)
    p[:, :6] = [[0.0, 1.0, 0.05, 0.95, 0.5, 0.1]] * 3    # faces, centers
    if kind == "f32":
        packed = jax_raymarch.PackedVolume.from_volume(_j(vol))
        table = _t(vol)
    else:
        packed = jax_raymarch.PackedVolume.from_volume(
            _j(vol), dtype=jnp.bfloat16, half=kind == "bf16_half_floor")
        table = _t(vol).to(torch.bfloat16)
    want = packed.sample_trilinear_p(*(_j(x) for x in p), clamp_floor=floor)
    got = pair_trilinear(table, *(_t(x) for x in p), floor)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-7)


# ---- march, refine, gradient ----------------------------------------------

def test_trilinear_march_state_and_resume():
    """The trilinear march without sentinels (return_state), stopped after
    6 steps and resumed for 60: equal hits and step counts, states to f32
    rounding."""
    vol = _sphere_volume((20, 22, 20))
    rng = np.random.default_rng(12)
    n = 400
    pos0 = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    pos0[2] = 0.02
    d = _rays(rng, n)
    d[2] = np.abs(d[2]) + 0.3
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    length = rng.uniform(0.0, 1.2, n).astype(np.float32)
    packed = jax_raymarch.PackedVolume.from_volume(_j(vol))
    jd, jp, jl = tuple(_j(x) for x in d), tuple(_j(x) for x in pos0), _j(
        length)
    td, tp, tl = tuple(_t(x) for x in d), tuple(_t(x) for x in pos0), _t(
        length)
    hj, _, nj, sj = jax_raymarch.march(
        packed, jnp.zeros(3), jd, LIMIT, 6, (jp, jl), mode="trilinear",
        refine_nearest=False, return_state=True)
    hp, nump, sp = port_raymarch.march(_t(vol), LIMIT, 6, (tp, tl), td,
                                      mode="trilinear", sentinel_skip=False)
    np.testing.assert_array_equal(_np(hp), _np(hj))
    np.testing.assert_array_equal(_np(nump), _np(nj))
    hj2, _, nj2, sj2 = jax_raymarch.march(
        packed, jnp.zeros(3), jd, LIMIT, 60, (jp, jl), mode="trilinear",
        refine_nearest=False, return_state=True, resume=sj[:3])
    hp2, np2, sp2 = port_raymarch.march(
        _t(vol), LIMIT, 60, (tp, tl), td, mode="trilinear",
        sentinel_skip=False, resume=sp[:3])
    assert int(_np(hj2).sum()) > 20
    np.testing.assert_array_equal(_np(hp2), _np(hj2))
    np.testing.assert_array_equal(_np(np2), _np(nj2))
    for a, b in zip(sp2, sj2):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_march_from_unit_cube_entry(mode):
    """unit_cube_entry + march against march(start_end=None), the
    full-screen form of render_dense; nearest mode adds the trilinear
    refine_crossing the JAX march applies (refine_nearest)."""
    vol = _sphere_volume((20, 22, 20))
    rng = np.random.default_rng(13)
    eye = np.array([0.5, 0.55, 1.8], np.float32)
    d = _rays(rng, 500, eye)
    hj, posj, nj = jax_raymarch.march(
        _j(vol), _j(eye), tuple(_j(x) for x in d), LIMIT, 200, None,
        mode=mode)
    dn = tuple(_t(x) for x in d)
    pos0, length = port_raymarch.unit_cube_entry(_t(eye), dn, LIMIT)
    hp, nump, st = port_raymarch.march(_t(vol), LIMIT, 200, (pos0, length),
                                      dn, mode=mode, sentinel_skip=False)
    posp = torch.stack([pos0[i] + dn[i] * st[5] for i in range(3)], dim=-1)
    if mode == "nearest":
        posp = port_raymarch.refine_crossing(_t(vol), pos0, dn, st[3], st[4],
                                             hp, posp)
    assert int(_np(hj).sum()) > 100 and (_np(length) == 0).sum() > 10
    np.testing.assert_array_equal(_np(hp), _np(hj))
    np.testing.assert_array_equal(_np(nump), _np(nj))
    np.testing.assert_allclose(_np(posp), _np(posj), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sentinel_table():
    """A bf16 sentinel-coded table of the sphere volume (kernel 4's plain
    twin), as the (Z, Y, X) f32 values it holds."""
    vol = _sphere_volume((20, 24, 20))
    bs = np.zeros((5, 6, 5), np.float32)
    return vol, _np(sentinel_bake_plain(_t(vol), _t(bs), 4, 3).float())


@pytest.mark.parametrize("table", ["raw_f32", "sentinel_bf16"])
def test_refine_crossing_matches(sentinel_table, table):
    """The table-based trilinear secant refine at nearest-march brackets,
    on the raw f32 volume and on the bf16 sentinel table with the -limit
    clamp floor."""
    vol, sent = sentinel_table
    rng = np.random.default_rng(14)
    eye = np.array([0.5, 0.5, 1.6], np.float32)
    d = _rays(rng, 400, eye)
    dn = tuple(_t(x) for x in d)
    pos0, length = port_raymarch.unit_cube_entry(_t(eye), dn, LIMIT)
    if table == "raw_f32":
        t_port, t_jax, floor = _t(vol), _j(vol), None
    else:
        t_port = _t(sent).to(torch.bfloat16)
        t_jax, floor = _j(sent).astype(jnp.bfloat16), -LIMIT
    hit, _, st = port_raymarch.march(t_port, LIMIT, 200, (pos0, length), dn,
                                     sentinel_skip=table != "raw_f32",
                                     sentinel_scale=1.0 / 24)
    hit_pos = torch.stack([pos0[i] + dn[i] * st[5] for i in range(3)], -1)
    assert int(hit.sum()) > 100
    got = port_raymarch.refine_crossing(t_port, pos0, dn, st[3], st[4], hit,
                                        hit_pos, clamp_floor=floor)
    want = jax_raymarch.refine_crossing(
        jax_raymarch.PackedVolume.from_volume(t_jax),
        tuple(_j(_np(x)) for x in pos0), tuple(_j(x) for x in d),
        _j(_np(st[3])), _j(_np(st[4])), _j(_np(hit)), _j(_np(hit_pos)),
        clamp_floor=floor)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,floor", [("trilinear", False),
                                        ("nearest", False),
                                        ("trilinear", True),
                                        ("nearest", True)])
def test_gradient_normal_matches(sentinel_table, mode, floor):
    """Central-difference normals at points near the sphere's surface, on
    the raw volume and on the sentinel table with the clamp floor."""
    vol, sent = sentinel_table
    rng = np.random.default_rng(15)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    Z, Y, X = vol.shape
    r = min(vol.shape) * 0.3 + rng.uniform(-0.5, 0.5, (300, 1))
    pos = ((np.array([X, Y, Z]) / 2 + d * r) / [X, Y, Z]).astype(np.float32)
    table = sent if floor else vol
    clamp = -LIMIT if floor else None
    want = jax_raymarch.gradient_normal(_j(table), _j(pos), LIMIT, mode=mode,
                                        clamp_floor=clamp)
    got = port_raymarch.gradient_normal(_t(table), _t(pos), LIMIT, mode=mode,
                                        clamp_floor=clamp)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


# ---- color blends ---------------------------------------------------------

@pytest.mark.parametrize("blend", ["blend_colors", "blend_colors_fast"])
def test_volume_blends_match(scene, blend):
    """The calibration-volume blends (trilinear lookups; nearest lookups
    with bf16 colors) at points on the sphere, which take both the quality
    blend (alpha 1) and the inverse-distance fallback: rgba to 1e-5."""
    s = scene
    args = [s["cv_xyz_inv"], s["cv_uv"], s["color"], s["depth"],
            s["quality"]]
    want = getattr(jax_raymarch, blend)(
        _j(s["sample_pos"]), *(_j(a) for a in args), LIMIT)
    got = getattr(port_raymarch, blend)(
        _t(s["sample_pos"]), *(_t(a) for a in args), LIMIT)
    assert 0.1 < (_np(want)[:, 3] == 1.0).mean() < 0.9
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dq_taps", ["nearest", "bilinear"])
def test_blend_colors_analytic_dq_taps(scene, dq_taps):
    """blend_colors_analytic with nearest and with four-corner bilinear
    depth/quality taps against the JAX function (the pipeline passes
    integrate_taps as dq_taps)."""
    s = scene
    m = s["models"]
    jm = jax_sensors.ProjectionModels(**{
        f: _j(_np(getattr(m, f))) for f in (
            "uv_num", "uv_off", "uv_den", "d_lin", "d_off", "cuv_num",
            "cuv_off", "cuv_den")})
    maps = [s["color"], s["depth"], s["quality"]]
    want = jax_raymarch.blend_colors_analytic(
        _j(s["world_pos"]), jm, *(_j(a) for a in maps), LIMIT,
        dq_taps=dq_taps)
    got = port_raymarch.blend_colors_analytic(
        _t(s["world_pos"]), m, *(_t(a) for a in maps), LIMIT,
        dq_taps=dq_taps)
    assert 0.1 < (_np(want)[:, 3] == 1.0).mean() < 0.9
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


# ---- integration ----------------------------------------------------------

def test_integrate_bricks_bilinear_matches(scene):
    """Brick-compact integration with bilinear taps on the scene's maps:
    tests/test_golden.py's volume tolerance."""
    s = scene
    pipe = s["pipe"]
    proj = _np(pipe.projections)
    ids = _np(port_tsdf.occupied_brick_ids(_t(s["counts"]), 10, 640))
    maps = [s["depth"], s["quality"], s["silhouette"]]
    want = jax_tsdf.integrate_bricks(
        _j(proj), _j(ids), *(_j(a) for a in maps), LIMIT,
        pipe.volume_grid.shape, pipe.brick_vox, taps="bilinear")
    got = port_tsdf.integrate_bricks(
        _t(proj), _t(ids), *(_t(a) for a in maps), LIMIT,
        pipe.volume_grid.shape, pipe.brick_vox, taps="bilinear")
    assert (_np(want) > 0).sum() > 100
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_dense_integrate_matches(scene, gated):
    """Dense integration: with precomputed projections and the occupied
    bricks' voxel mask, and with in-call lookups and no mask."""
    s = scene
    shape = s["pipe"].volume_grid.shape
    maps = [s["depth"], s["quality"], s["silhouette"]]
    inv = s["cv_xyz_inv"]
    mask = None
    if gated:
        occ = s["counts"] > 10
        mask = _np(port_bricks.expand_mask_to_voxel_grid(
            _t(occ), shape, tuple(float(x) for x in PBBOX.size), 0.2))
        jproj = jax_tsdf.bake_projections(_j(inv), shape)
        pproj = port_tsdf.bake_projections(_t(inv), shape)
        for a, b in zip(pproj, jproj):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)
    else:
        jproj = pproj = None
    want = jax_tsdf.integrate(
        shape, _j(inv), *(_j(a) for a in maps), LIMIT,
        voxel_mask=None if mask is None else _j(mask), projections=jproj)
    got = port_tsdf.integrate(
        shape, _t(inv), *(_t(a) for a in maps), LIMIT,
        voxel_mask=None if mask is None else _t(mask), projections=pproj)
    assert (_np(want) > 0).sum() > 100
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,bbox_size,brick", [
    ((44, 40, 40), (2.0, 2.2, 2.0), 0.2),
    ((35, 32, 33), (2.0, 2.2, 2.0), 0.3),
])
def test_expand_mask_to_voxel_grid_matches(shape, bbox_size, brick):
    """Brick mask -> voxel mask, for a brick that holds a whole number of
    voxels and one that does not: exact."""
    rng = np.random.default_rng(16)
    grid = tuple(int(np.ceil(s / brick - 1e-6)) for s in bbox_size[::-1])
    mask = rng.random(grid) < 0.4
    want = jax_bricks.expand_mask_to_voxel_grid(_j(mask), shape, bbox_size,
                                                brick)
    got = port_bricks.expand_mask_to_voxel_grid(_t(mask), shape, bbox_size,
                                                brick)
    np.testing.assert_array_equal(_np(got), _np(want))


# ---- the pipeline's projection-model fallback -----------------------------

def test_projection_fit_miss_blends_through_volumes(scene, monkeypatch,
                                                    capsys):
    """A projection-model fit whose residual exceeds 2e-3 falls back to the
    calibration-volume blend, as projection_model=False does: the two
    renders are equal bit for bit."""
    pipe = scene["pipe"]
    calib = pipe.calib
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    volume, maps, counts = pipe.fuse(frames)
    cam = port_raymarch.ViewCamera(**CAM)

    def bad_fit(cv_xyz, cv_uv):
        models, _ = derive_projection_models(cv_xyz, cv_uv)
        return models, 1.0

    monkeypatch.setattr(port_pipeline, "derive_projection_models", bad_fit)
    missed = port_pipeline.TsdfPipeline(calib, _pcfg(), PBBOX)
    out = missed.make_renderer(cam)(volume, maps, counts)
    assert "residual 1.00e+00 too large" in capsys.readouterr().out
    off = port_pipeline.TsdfPipeline(calib, _pcfg(projection_model=False),
                                     PBBOX)
    ref = off.make_renderer(cam)(volume, maps, counts)
    assert int(ref.hit.sum()) > 300
    for f in ("color", "depth", "hit", "num_samples", "overflow"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
