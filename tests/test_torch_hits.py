"""The port's hit path (ops/hits.py refine_hits_plain and shade_hits_plain,
the plain twins of csrc/hits.cu) against the JAX package's refines and
TsdfPipeline._shade_hits, on the CPU.

Each case renders the verify scene on the port (CPU) under its config and
records the hit sets the render hands to ops.hits.refine_hits and
shade_hits: the compacted hits of the block march (padded past the live
hits) or the full screen of render_dense. Both packages then refine and
shade the same numpy inputs. Tolerances are tests/test_torch_parity.py's:
refined positions and window depth atol 1e-6 (its refine's), rgba atol
1e-5 (its gradient's and blend's); alpha and the hit mask's zeros exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import sensors as jax_sensors
from rgbd_recon_tpu.ops import preprocess as jax_preprocess
from rgbd_recon_tpu.ops import raymarch as jax_raymarch
from rgbd_recon_tpu.recon import tsdf_pipeline as jax_pipeline
from rgbd_recon_tpu_torch.ops import hits

from hit_cases import record_hits
from test_torch_parity import (
    BBOX,
    CAM,
    PARITY,
    PBBOX,
    SPHERE,
    _cfg,
    _np,
    _pcfg,
    port_calibration,
    port_synthetic,
)

from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

torch.set_num_threads(2)

# each variant of the hit kernels, by the config that takes it on top of
# the verify scene's: the oct table with the widened bracket (the fast
# path) and without it; the bf16 sentinel table's refine with the clamp
# floor and its nearest normal; the parity path (the f32 raw table, the
# trilinear normal, the calibration volumes' trilinear blend); the
# volumes' nearest blend; bilinear depth/quality taps; f32 oct and
# sentinel tables; the full-screen render (nearest march: refine on the raw
# volume, nearest normal without floor)
CASES = {
    "fast": {},
    "oct_no_widen": dict(refine_widen_steps=0.0),
    "no_oct": dict(oct_hit_table=False),
    "parity": PARITY,
    "no_proj": dict(projection_model=False),
    "bilinear_taps": dict(integrate_taps="bilinear"),
    "f32_tables": dict(march_dtype="float32"),
    "dense_nearest": dict(ray_compaction=0.0),
}
# shade modes 1 and 2 on the three normals: oct, nearest, trilinear
SHADED = [(name, mode) for name in ("fast", "no_oct", "parity")
          for mode in (1, 2)]
POS_ATOL = 1e-6
DEPTH_ATOL = 1e-6
RGBA_ATOL = 1e-5


@pytest.fixture(scope="module")
def recorded():
    """{case: (port pipeline, {"refine": (args, kwargs), "shade": (args,
    kwargs)})}: what one CPU render of the verify scene under each case's
    config hands to the hit path."""
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    calib = port_calibration(rig, PBBOX, cv_res=(24, 32, 24),
                             inv_res=(40, 44, 40), device="cpu")
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    out = {}
    for name, kw in CASES.items():
        pipe = TsdfPipeline(calib, _pcfg(**kw), PBBOX)
        volume, maps, counts = pipe.fuse(frames)
        render = pipe.make_renderer(ViewCamera(**CAM))
        calls = record_hits(lambda: render(volume, maps, counts))
        assert set(calls) == {"refine", "shade"}, name
        out[name] = (pipe, calls)
    return out


def _j(x):
    """A port tensor (bf16 included) as a JAX array of its dtype."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(_np(x.float())).astype(jnp.bfloat16)
    return jnp.asarray(_np(x))


def _jax_oct(oct):
    """The JAX package's OctVolume of the port's table (its slots are (B,
    2) pairs of the slot)."""
    s = _np(oct.slots)
    return jax_raymarch.OctVolume(rows=_j(oct.rows),
                                  slots=jnp.asarray(np.stack([s, s], -1)),
                                  shape=oct.shape, brick_vox=oct.brick_vox)


def _fields(container):
    return {f.name: _j(getattr(container, f.name))
            for f in dataclasses.fields(container)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_refine_hits_match_jax(recorded, name):
    """refine_hits_plain against oct_refine_crossing (the oct table, with
    and without the widened bracket) and refine_crossing (the march table,
    with and without the clamp floor) of the JAX package."""
    pipe, calls = recorded[name]
    args, kwargs = calls["refine"]
    pos0, dn, lo_t, hi_t, hit, hit_pos, limit = args
    got = hits.refine_hits_plain(*args, **kwargs)
    jpos0 = tuple(_j(x) for x in pos0)
    jdn = tuple(_j(x) for x in dn)
    if kwargs.get("oct") is not None:
        want = jax_raymarch.oct_refine_crossing(
            _jax_oct(kwargs["oct"]), jpos0, jdn, _j(lo_t), _j(hi_t), _j(hit),
            _j(hit_pos), limit, widen_steps=kwargs["widen_steps"],
            widen_samples=kwargs["widen_samples"])
    else:
        want = jax_raymarch.refine_crossing(
            jax_raymarch.PackedVolume.from_volume(_j(kwargs["table"])),
            jpos0, jdn, _j(lo_t), _j(hi_t), _j(hit), _j(hit_pos),
            clamp_floor=kwargs.get("clamp_floor"))
    live = _np(hit)
    assert live.sum() > 300
    if name not in ("parity", "dense_nearest"):
        assert not live.all()                   # padded hit ids
    if name != "parity":
        # the refine moves hits (the trilinear march's own secant is the
        # refine's on the raw volume)
        assert (_np(got) != _np(hit_pos)).any(-1).sum() > 100
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=POS_ATOL)


def _shade_both(pipe, calls, mode):
    """(port (rgba, depth), JAX (rgba, depth)) of the recorded hits in
    shade mode ``mode``."""
    args, kwargs = calls["shade"]
    (config, calib, bbox, hit, hit_pos, maps, proj_models, cam, near, far,
     limit, table, clamp_floor, oct) = args
    config = dataclasses.replace(config, shade_mode=mode)
    got = hits.shade_hits_plain(config, *args[1:], **kwargs)
    jcfg = _cfg(**{f.name: getattr(config, f.name)
                   for f in dataclasses.fields(config)})
    jpipe = jax_pipeline.TsdfPipeline(
        jax_sensors.CalibrationSet(**_fields(calib)), jcfg, BBOX)
    jmodels = (None if proj_models is None else
               jax_sensors.ProjectionModels(**_fields(proj_models)))
    jcam = jax_pipeline.CamParams(eye_w=_j(cam.eye_w), rot=_j(cam.rot),
                                  eye_vol=_j(cam.eye_vol))
    want = jpipe._shade_hits(
        _j(table), _j(hit), _j(hit_pos),
        jax_preprocess.SensorMaps(**_fields(maps)), jpipe.calib, jmodels,
        jcam, near, far, limit=limit, clamp_floor=clamp_floor,
        oct=None if oct is None else _jax_oct(oct))
    return got, want


def _check_shade(got, want, hit):
    rgba, depth = (_np(x) for x in got)
    jrgba, jdepth = (np.asarray(x) for x in want)
    live = _np(hit)
    np.testing.assert_allclose(depth, jdepth, rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_array_equal(rgba[..., 3], jrgba[..., 3])
    np.testing.assert_allclose(rgba, jrgba, rtol=0, atol=RGBA_ATOL)
    assert (rgba[~live] == 0.0).all() and (depth[~live] == 1.0).all()
    alpha = rgba[live][..., 3]
    assert (alpha == 1.0).mean() > 0.5 and (alpha == -1.0).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_hits_match_jax(recorded, name):
    """shade_hits_plain against the JAX package's _shade_hits in shade mode
    0: each normal (oct, nearest with and without the floor, trilinear),
    each blend (analytic with nearest and bilinear depth/quality taps, the
    volumes' trilinear and nearest), bf16 and f32 tables."""
    pipe, calls = recorded[name]
    got, want = _shade_both(pipe, calls, 0)
    _check_shade(got, want, calls["shade"][0][3])


@pytest.mark.parametrize("name,mode", SHADED)
def test_shade_modes_match_jax(recorded, name, mode):
    """Shade modes 1 (Blinn-Phong) and 2 (normals) on the oct, nearest and
    trilinear normals, against the JAX package's _shade_hits."""
    pipe, calls = recorded[name]
    got, want = _shade_both(pipe, calls, mode)
    _check_shade(got, want, calls["shade"][0][3])
