"""Whole-slice parity of the PyTorch port against the JAX package: fuse +
staged render (bake, block march, tail stages, oct secant refine,
analytic-model blend, pull-push fill) on the verify scene with
brick_size=0.2 and a 96x80 camera (the block path with the oct hit table),
plus unit parity of the march and the hole fill, and of each configuration
value of the variants: the camera-influence and normal-weighted blends and
the chunked march on seeded inputs, per-block brackets and the profiling
switches by rendering the JAX package's state in both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.calib import sensors as jax_sensors
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import holefill as jax_holefill
from rgbd_recon_tpu.ops import raymarch as jax_raymarch
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.sensors import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
    derive_projection_models,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.ops import holefill as port_holefill
from rgbd_recon_tpu_torch.ops import raymarch as port_raymarch
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import (
    TsdfPipeline as PortPipeline,
)
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

from test_torch_parity import capturing_fills, jax_arrays, shared_hits

torch.set_num_threads(2)

# each package builds its own box and configs from the same arguments
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
CAM = dict(width=96, height=80, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0))
BASE_CFG = dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=0.02, num_lods=5)


def _cfg(**kw):
    return PipelineConfig(**BASE_CFG, **kw)


def _pcfg(**kw):
    return PortConfig(**BASE_CFG, **kw)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def port_setup():
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    calib = port_calibration(rig, PBBOX, cv_res=(24, 32, 24),
                             inv_res=(40, 44, 40), device="cpu")
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    return calib, frames


@pytest.fixture(scope="module")
def runs(port_setup):
    """JAX and port renders of the same scene, default config and with the
    pull-push fill off; ``prefill`` holds both renders' pre-fill planes."""
    rig = default_test_rig(num_sensors=4, bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    pcalib, pframes = port_setup
    out = {"prefill": {}}
    jfill, pfill = capturing_fills(out["prefill"])
    for name, kw in (("default", {}), ("nofill", {"colorfill": False})):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_holefill, "fill_colors_planar", jfill)
            mp.setattr(port_holefill, "fill_colors_planar", pfill)
            pipe = TsdfPipeline(calib, _cfg(**kw), BBOX)
            vol, maps, counts = pipe.fuse(frames)
            jax_out = pipe.make_renderer(ViewCamera(**CAM))(vol, maps, counts)
            jax.block_until_ready(jax_out)
            jax.effects_barrier()
            ppipe = PortPipeline(pcalib, _pcfg(**kw), PBBOX)
            pvol, pmaps, pcounts = ppipe.fuse(pframes)
            port_out = ppipe.make_renderer(port_raymarch.ViewCamera(**CAM))(
                pvol, pmaps, pcounts)
        out[name] = (jax_out, port_out)
        if name == "default":
            out["jax_state"] = (pipe, vol, maps, counts)
    return out


@pytest.mark.parametrize("mode", ["default", "nofill"])
def test_hit_masks_match(runs, mode):
    """Hit masks equal except at most 0.5% of pixels (knife edges)."""
    jax_out, port_out = runs[mode]
    hj, hp = _np(jax_out.hit), _np(port_out.hit)
    assert hj.sum() > 300
    assert (hj != hp).sum() <= 0.005 * hj.size


@pytest.mark.parametrize("mode", ["default", "nofill"])
def test_depth_matches(runs, mode):
    """Window depth at tests/test_golden.py's atol 2e-4 on shared hits."""
    jax_out, port_out = runs[mode]
    m = shared_hits(jax_out, port_out)
    np.testing.assert_allclose(_np(port_out.depth)[m], _np(jax_out.depth)[m],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("mode", ["default", "nofill"])
def test_overflow_and_samples_equal(runs, mode):
    """Capacity overflow counters and per-pixel march step counts equal."""
    jax_out, port_out = runs[mode]
    np.testing.assert_array_equal(_np(port_out.overflow),
                                  _np(jax_out.overflow))
    np.testing.assert_array_equal(_np(port_out.num_samples),
                                  _np(jax_out.num_samples))


def test_color_matches_before_fill(runs):
    """Blended, shaded hit colors without the pull-push fill: atol 1e-3 on
    shared hits (tests/test_golden.py's color tolerance)."""
    jax_out, port_out = runs["nofill"]
    m = shared_hits(jax_out, port_out)
    np.testing.assert_allclose(_np(port_out.color)[m], _np(jax_out.color)[m],
                               rtol=0, atol=1e-3)


def test_color_matches(runs):
    """Final colors with the default pull-push fill: atol 1e-3 on every
    shared hit except one named class, hits whose blend fell back to
    inverse-distance weights (alpha -1). Those take their color from the
    pyramid, whose pull keeps samples with depth >= the window mean: a
    knife edge where the depths are equal, which the JAX compiler rounds
    differently inside the fused render program than in the fill alone
    (test_fill_on_render_matches holds the port's fill to JAX's fill alone
    at 1e-6 on these same planes). The class is the same in both packages
    (96 of 675 shared hits); at most 8 of its pixels (8 today) leave 1e-3,
    and none leaves 2e-2."""
    jax_out, port_out = runs["default"]
    pre = runs["prefill"]
    m = shared_hits(jax_out, port_out)
    fallback = pre["jax"][3] == -1.0
    np.testing.assert_array_equal((pre["port"][3] == -1.0)[m], fallback[m])
    cls = m & fallback
    assert 0 < cls.sum() <= 100
    cp, cj = _np(port_out.color), _np(jax_out.color)
    np.testing.assert_allclose(cp[m & ~cls], cj[m & ~cls], rtol=0, atol=1e-3)
    diff = np.abs(cp[cls] - cj[cls]).max(-1)
    assert (diff > 1e-3).sum() <= 8
    assert diff.max() <= 2e-2


def test_fill_on_render_matches(runs):
    """The port's pull-push on the JAX render's own pre-fill planes (r, g,
    b, alpha, window depth) against the JAX fill run alone on them: the
    tolerances of test_holefill_matches (atol 1e-6, depth exact)."""
    planes = runs["prefill"]["jax"]
    assert (planes[3] == -1.0).any() and (planes[4] < 1.0).sum() > 300
    cj, dj = jax_holefill.fill_colors_planar(
        [jnp.asarray(p) for p in planes[:4]], jnp.asarray(planes[4]), 5)
    cp, dp = port_holefill.fill_colors_planar(
        [torch.from_numpy(p) for p in planes[:4]],
        torch.from_numpy(planes[4]), 5)
    for a, b in zip(cp, cj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(dp), _np(dj))


def test_render_from_carried_state(runs):
    """The port's renderer on the JAX volume and maps carried across: the
    render alone, at the whole-slice tolerances."""
    pipe, vol, maps, counts = runs["jax_state"]
    jax_out, _ = runs["default"]
    ccal = convert.calibration_from_numpy(jax_arrays(pipe.calib),
                                          device="cpu")
    ppipe = PortPipeline(ccal, _pcfg(), PBBOX)
    out = ppipe.make_renderer(port_raymarch.ViewCamera(**CAM))(
        torch.from_numpy(np.array(vol)),
        convert.sensor_maps_from_numpy(jax_arrays(maps),
                                       device="cpu"),
        torch.from_numpy(np.array(counts)))
    hj, hp = _np(jax_out.hit), _np(out.hit)
    assert (hj != hp).sum() <= 0.005 * hj.size
    m = shared_hits(jax_out, out)
    np.testing.assert_allclose(_np(out.depth)[m], _np(jax_out.depth)[m],
                               rtol=0, atol=2e-4)
    np.testing.assert_array_equal(_np(out.overflow), _np(jax_out.overflow))


def test_march_matches(runs):
    """The nearest-tap sentinel march on the JAX bf16 march table: same
    hits and step counts, states to f32 rounding."""
    pipe, vol, maps, counts = runs["jax_state"]
    render_fn, _ = pipe.make_render_fn(ViewCamera(**CAM))
    packed = render_fn.bake(vol, counts, pipe._limit)[0]
    rng = np.random.default_rng(8)
    n = 512
    pos0 = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    pos0[2] = 0.02
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[2] = np.abs(d[2]) + 0.5
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    length = rng.uniform(0.0, 1.2, n).astype(np.float32)
    h_min = 1.0 / 44
    hit_j, _, num_j, st_j = jax_raymarch.march(
        packed, jnp.zeros(3), tuple(jnp.asarray(x) for x in d), pipe._limit,
        60, (tuple(jnp.asarray(x) for x in pos0), jnp.asarray(length)),
        mode="nearest", refine_nearest=False, sentinel_skip=True,
        sentinel_scale=h_min, return_state=True)
    table = torch.from_numpy(
        np.asarray(packed.pairs).view(np.uint16).astype(np.int16)
    ).view(torch.bfloat16).reshape(tuple(vol.shape))
    hit_p, num_p, st_p = port_raymarch.march(
        table, float(pipe._limit), 60,
        (tuple(torch.from_numpy(x) for x in pos0), torch.from_numpy(length)),
        tuple(torch.from_numpy(x) for x in d), sentinel_scale=h_min)
    assert int(_np(hit_j).sum()) > 20
    np.testing.assert_array_equal(_np(hit_p), _np(hit_j))
    np.testing.assert_array_equal(_np(num_p), _np(num_j))
    for a, b in zip(st_p, st_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_holefill_matches():
    """Pull-push on the same random planes: selection matmuls are exact and
    the bilinear resampling agrees to f32 rounding (atol 1e-6)."""
    rng = np.random.default_rng(9)
    H, W = 80, 96
    rgba = rng.random((H, W, 4)).astype(np.float32)
    rgba[..., 3] = np.where(rng.random((H, W)) < 0.3, -1.0, 1.0)
    depth = rng.uniform(0.9, 0.99, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 1.0
    cj, dj = jax_holefill.fill_colors_planar(
        [jnp.asarray(rgba[..., i]) for i in range(4)], jnp.asarray(depth), 5)
    cp, dp = port_holefill.fill_colors_planar(
        [torch.from_numpy(rgba[..., i]) for i in range(4)],
        torch.from_numpy(depth), 5)
    for a, b in zip(cp, cj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(dp), _np(dj))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_shade_matches(mode):
    """Blinn-Phong shading (shading.glsl) on random view-space inputs:
    f32 math in both, powf(x, 20) and norms may differ by ulps (1e-5)."""
    rng = np.random.default_rng(10)
    pos = rng.normal(size=(64, 3)).astype(np.float32) - [0, 0, 3]
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dif = rng.random((64, 3)).astype(np.float32)
    want = jax_raymarch.shade(jnp.asarray(pos), jnp.asarray(nrm),
                              jnp.asarray(dif), shade_mode=mode)
    got = port_raymarch.shade(torch.from_numpy(pos), torch.from_numpy(nrm),
                              torch.from_numpy(dif), shade_mode=mode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hit_set(runs):
    """Seeded hits for the blends: 256 points on the sphere's surface
    (volume-normalized and world) with the negated, normalized volume
    gradient the pipeline passes (the inward normal, in volume space), the
    JAX state's calibration and maps as numpy, and both packages'
    projection models from the same fit."""
    pipe, _, maps, _ = runs["jax_state"]
    rng = np.random.default_rng(31)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    world = np.asarray(SPHERE[0][0]) + d * SPHERE[0][1]
    bmin, bsize = np.asarray(PBBOX.min), np.asarray(PBBOX.size)
    grad = -d * bsize
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    calib = jax_arrays(pipe.calib)
    m = jax_arrays(maps)
    pcalib = convert.calibration_from_numpy(calib, device="cpu")
    models, residual = derive_projection_models(pcalib.cv_xyz, pcalib.cv_uv)
    assert residual < 2e-3
    jmodels = jax_sensors.ProjectionModels(**{
        f.name: jnp.asarray(_np(getattr(models, f.name)))
        for f in dataclasses.fields(models)})
    return dict(
        sample_pos=((world - bmin) / bsize).astype(np.float32),
        world_pos=world.astype(np.float32), grad=grad.astype(np.float32),
        cv_xyz_inv=calib["cv_xyz_inv"], cv_uv=calib["cv_uv"],
        color=m["color"], depth=m["depth"][..., 0], quality=m["quality"],
        normal=m["normal"], models=models, jmodels=jmodels)


def _both(fn_jax, fn_port, *arrays, **kw):
    """(JAX result, port result) as numpy of the same numpy inputs."""
    want = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_port(*(torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays), **kw)
    return np.asarray(want), got


def _check_blend(want, got, alpha_mix=True):
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    if alpha_mix:
        assert 0.05 < (want[:, 3] == 1.0).mean() < 0.95


def _unit_shade_mode_3(runs, hs):
    """blend_cameras: palette weights of the sensors within the band,
    white where none weighs in."""
    want, got = _both(jax_raymarch.blend_cameras,
                      port_raymarch.blend_cameras, hs["sample_pos"],
                      hs["cv_xyz_inv"], hs["depth"], hs["quality"],
                      limit=0.02)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    white = (want == 1.0).all(-1)
    assert 0.05 < white.mean() < 0.95


def _unit_blend(hs, variant, models):
    args = (hs["sample_pos"], hs["world_pos"], hs["grad"])
    maps = (hs["cv_xyz_inv"], hs["cv_uv"], hs["color"], hs["depth"],
            hs["normal"])
    want = jax_raymarch.blend_colors_normal(
        *(jnp.asarray(a) for a in args),
        hs["jmodels"] if models else None,
        *(jnp.asarray(a) for a in maps), 0.02, variant=variant)
    got = port_raymarch.blend_colors_normal(
        *(torch.from_numpy(a) for a in args),
        hs["models"] if models else None,
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in maps), 0.02,
        variant=variant)
    # best_two's two weights are always positive; the deviation weights
    # vanish where no sensor's normal opposes the surface's
    _check_blend(np.asarray(want), got, alpha_mix=variant == "deviation")


def _unit_march_chunk(runs, hs):
    """march_chunked with 8 samples a chunk through a bf16 sentinel table
    of the JAX state's volume, 60 steps, then resumed for 60 more: hits
    and step counts equal, states to f32 rounding."""
    pipe, vol, _, counts = runs["jax_state"]
    render_fn, _ = pipe.make_render_fn(ViewCamera(**CAM))
    packed = render_fn.bake(vol, counts, pipe._limit)[0]
    table = torch.from_numpy(
        np.asarray(packed.pairs).view(np.uint16).astype(np.int16)
    ).view(torch.bfloat16).reshape(tuple(vol.shape))
    rng = np.random.default_rng(32)
    n = 512
    pos0 = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    pos0[2] = 0.02
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[2] = np.abs(d[2]) + 0.5
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    length = rng.uniform(0.0, 1.2, n).astype(np.float32)
    limit, h_min = float(pipe._limit), 1.0 / 44
    jd, jp = tuple(jnp.asarray(x) for x in d), tuple(jnp.asarray(x)
                                                    for x in pos0)
    td, tp = tuple(torch.from_numpy(x) for x in d), tuple(
        torch.from_numpy(x) for x in pos0)
    resume_j = resume_p = None
    for steps in (60, 60):
        hj, nj, sj = jax_raymarch.march_chunked(
            packed, jp, jd, pipe._limit, steps, jnp.asarray(length), chunk=8,
            sentinel_skip=True, sentinel_scale=h_min, resume=resume_j)
        hp, nump, sp = port_raymarch.march_chunked(
            table, limit, steps, (tp, torch.from_numpy(length)), td, chunk=8,
            sentinel_skip=True, sentinel_scale=h_min, resume=resume_p)
        np.testing.assert_array_equal(_np(hp), np.asarray(hj))
        np.testing.assert_array_equal(_np(nump), np.asarray(nj))
        for a, b in zip(sp, sj):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        resume_j, resume_p = sj[:3], sp[:3]
    assert int(np.asarray(hj).sum()) > 20


UNIT_CASES = {
    ("march_chunk", 8): _unit_march_chunk,
    ("blend_mode", "best_two"):
        lambda runs, hs: _unit_blend(hs, "best_two", models=True),
    ("blend_mode", "normal_deviation"):
        lambda runs, hs: _unit_blend(hs, "deviation", models=False),
    ("shade_mode", 3): _unit_shade_mode_3,
}


@pytest.mark.parametrize("field,value", list(UNIT_CASES))
def test_config_value_unit_matches(runs, hit_set, field, value):
    """The function behind each value against the JAX package's on seeded
    inputs: march_chunked on rays through the sentinel table,
    blend_colors_normal (best_two through the projection models,
    deviation through the calibration volumes) and blend_cameras on hits
    on the sphere (rgba to 1e-5; both alpha classes present where the
    weights can vanish)."""
    UNIT_CASES[(field, value)](runs, hit_set)


@pytest.mark.parametrize("field,value", [
    ("bracket_per_block", True),
    ("debug_skip", "blend,refine"),
    ("debug_skip", "grad"),
])
def test_config_value_render_matches(runs, field, value):
    """The JAX package's fused state rendered with the value by both
    packages, without the pull-push fill: hit masks equal except at 0.5%
    of pixels, depth to 2e-4 and color to 1e-3 on shared hits, overflow
    and step counts equal."""
    pipe, vol, maps, counts = runs["jax_state"]
    kw = {field: value, "colorfill": False}
    jpipe = TsdfPipeline(pipe.calib, _cfg(**kw), BBOX)
    want = jpipe.make_renderer(ViewCamera(**CAM))(vol, maps, counts)
    ccal = convert.calibration_from_numpy(jax_arrays(pipe.calib),
                                          device="cpu")
    ppipe = PortPipeline(ccal, _pcfg(**kw), PBBOX)
    got = ppipe.make_renderer(port_raymarch.ViewCamera(**CAM))(
        torch.from_numpy(np.array(vol)),
        convert.sensor_maps_from_numpy(jax_arrays(maps), device="cpu"),
        torch.from_numpy(np.array(counts)))
    hj, hp = _np(want.hit), _np(got.hit)
    assert hj.sum() > 300
    assert (hj != hp).sum() <= 0.005 * hj.size
    m = shared_hits(want, got)
    np.testing.assert_allclose(_np(got.depth)[m], _np(want.depth)[m],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(got.color)[m], _np(want.color)[m],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(_np(got.overflow), _np(want.overflow))
    np.testing.assert_array_equal(_np(got.num_samples),
                                  _np(want.num_samples))
    if "blend" in str(value):
        np.testing.assert_allclose(_np(got.color)[hp], 0.7, rtol=0,
                                   atol=1e-6)
