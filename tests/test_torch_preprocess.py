"""Preprocess parity of the PyTorch port against the JAX package, including
kernels 1-2 (the 13x13 bilateral and quality stencils). The JAX side runs
its Pallas kernels in interpret mode (``use_pallas=True`` off-TPU); the port
runs the plain twins of its CUDA kernels (CPU tensors)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.calib.sensors import derive_pixel_models
from rgbd_recon_tpu.core import BoundingBox
from rgbd_recon_tpu.ops import preprocess as jax_pre
from rgbd_recon_tpu.ops import stencil_pallas
from rgbd_recon_tpu.sensors import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch.ops import preprocess as port_pre
from rgbd_recon_tpu_torch.ops import stencil13

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    """2 sensors at 48x40 (tests/test_preprocess.py's parity scene)."""
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(24, 28, 24))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig)
    pm, _ = derive_pixel_models(calib.cv_xyz, calib.cv_uv, (40, 48))
    return calib, frames, pm


def test_stencil13_plain_matches_pallas(scene):
    """Kernels 1-2: the port's plain folds against bilateral13_tpu and
    quality13_tpu in interpret mode. Same taps in the same order (dy outer,
    dx inner). The JAX CPU compiler contracts multiply-adds into FMAs and
    folds 0.35*d/4.5 into d*(0.35/4.5), so the bilateral sums agree to a
    few f32 ulps: atol 1e-5 plus rtol 1e-6 (the sums reach a few hundred,
    where one ulp is up to 3e-5). The quality census has no such rewrites
    and is held at atol 1e-5."""
    calib, frames, _ = scene
    d_m = jax_pre.morph_dilate(frames.depths[0])[None]
    d_m = jnp.concatenate([d_m, jax_pre.morph_dilate(frames.depths[1])[None]])
    want = stencil_pallas.bilateral13_tpu(d_m, calib.depth_limits,
                                          interpret=True)
    got = stencil13.bilateral13_plain(_t(d_m), _t(calib.depth_limits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)
    near = calib.depth_limits[:, 0][:, None, None]
    far = calib.depth_limits[:, 1][:, None, None]
    dn = (d_m - near) / (far - near)
    want = stencil_pallas.quality13_tpu(dn, interpret=True)
    got = stencil13.quality13_plain(_t(dn))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _tiny_patch_map(tiny):
    """(2, 40, 48) normalized depth in [-0.2, 1.2) with a 6 x 8 patch of
    tiny * (1 +- 20%) in each map: centres whose neighbours are non-border
    taps."""
    rng = np.random.default_rng(0)
    d = rng.uniform(-0.2, 1.2, (2, 40, 48))
    d[:, 10:16, 12:20] = tiny * (1.0 + rng.uniform(-0.2, 0.2, (2, 6, 8)))
    return d.astype(np.float32)


@pytest.mark.parametrize("tiny", [2.0 ** -45, 2.0 ** -70, 2.0 ** -100,
                                  2.0 ** -120])
def test_quality13_plain_matches_pallas_tiny(tiny):
    """Normalized depths below 2^-40, where the CUDA kernel leaves its
    hoisted reciprocal for the full division: the plain fold (which the
    kernel matches bit for bit on the card) against quality13_tpu in
    interpret mode, bit for bit."""
    d = _tiny_patch_map(tiny)
    want = stencil_pallas.quality13_tpu(jnp.asarray(d), interpret=True)
    got = stencil13.quality13_plain(_t(d))
    assert float(got[1][:, 10:16, 12:20].min()) > 0.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("tiny", [2.0 ** -126, 2.0 ** -140])
def test_quality13_plain_matches_pallas_subnormal(tiny):
    """Subnormal normalized depths (or a subnormal 0.35 d). XLA's CPU
    backend flushes subnormal operands to zero, as a TPU does; PyTorch and
    the CUDA kernel keep them (IEEE). So the two agree bit for bit on every
    pixel whose centre is not in (0, 2^-100) (a tiny neighbour is a border
    tap of any other centre), and differ at the tiny centres themselves
    (ROADMAP, port divergences)."""
    d = _tiny_patch_map(tiny)
    want = stencil_pallas.quality13_tpu(jnp.asarray(d), interpret=True)
    got = stencil13.quality13_plain(_t(d))
    tiny_centre = (d > 0.0) & (d < 2.0 ** -100)
    assert tiny_centre.sum() == 96
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy().view(np.int32)[~tiny_centre],
            np.asarray(w).view(np.int32)[~tiny_centre])


@pytest.fixture(scope="module",
                params=["pixel_models", "volumes", "passes_off"])
def maps_pair(request, scene):
    """(JAX maps with Pallas interpret, port maps) for one lookup mode —
    pixel models (the default), calibration-volume lookups, or pixel models
    with the morph, bilateral and refine passes switched off. The pixel
    models are carried across so both chains use the same fit."""
    calib, frames, pm = scene
    use_pm = request.param != "volumes"
    on = request.param != "passes_off"
    kw = dict(cv_xyz=calib.cv_xyz, cv_uv=calib.cv_uv,
              bbox_min=calib.bbox_min, bbox_max=calib.bbox_max,
              depth_limits=calib.depth_limits,
              camera_positions=calib.camera_positions)
    m_jax = jax_pre.preprocess_frames(
        frames.depths, frames.colors, **kw, morph=on, bilateral=on,
        refine=on, pixel_models=pm if use_pm else None, use_pallas=True)
    pm_t = (convert.pixel_models_from_numpy(jax_arrays(pm),
                                            device="cpu")
            if use_pm else None)
    m_port = port_pre.preprocess_frames(
        _t(frames.depths), _t(frames.colors),
        **{k: _t(v) for k, v in kw.items()}, morph=on, bilateral=on,
        refine=on, pixel_models=pm_t)
    return m_jax, m_port


@pytest.mark.parametrize("field,atol", [
    ("depth", 1e-5),        # tolerances of tests/test_preprocess.py:315-323
    ("quality", 1e-5),
    ("silhouette", 1e-6),
    ("raw_depth", 1e-6),    # 3x3 morph means in f32
    ("lab", 1e-4),          # pow in two libraries; LAB values of order 1
    ("normal", 1e-4),       # unit vectors from cross products of f32
                            # differences (cancellation amplifies ulps)
])
def test_preprocess_matches(maps_pair, field, atol):
    m_jax, m_port = maps_pair
    np.testing.assert_allclose(getattr(m_port, field).numpy(),
                               np.asarray(getattr(m_jax, field)),
                               rtol=0, atol=atol)
