"""Setup parity of the PyTorch port against the JAX package: synthetic
calibration and frames, the calibration fits, the state converters, and the
sampling/color primitives. Inputs are made from seeds with numpy and fed to
both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration as jax_calib
from rgbd_recon_tpu.calib.sensors import (
    derive_pixel_models as jax_pixel_models,
    derive_projection_models as jax_projection_models,
)
from rgbd_recon_tpu.core import BoundingBox
from rgbd_recon_tpu.ops import color as jax_color
from rgbd_recon_tpu.ops import sampling as jax_sampling
from rgbd_recon_tpu.sensors import SyntheticScene as JaxScene
from rgbd_recon_tpu.sensors import default_test_rig as jax_rig
from rgbd_recon_tpu.sensors import render_rig_frames as jax_frames

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch.calib import sensors as port_sensors
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.ops import color as port_color
from rgbd_recon_tpu_torch.ops import sampling as port_sampling
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

# each package builds its own box from the same arguments
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
CV_RES, INV_RES = (24, 32, 24), (40, 44, 40)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def both():
    rig_j = jax_rig(num_sensors=4, bbox=BBOX)
    rig_p = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    return dict(
        rig_j=rig_j, rig_p=rig_p,
        calib_j=jax_calib(rig_j, BBOX, cv_res=CV_RES, inv_res=INV_RES),
        calib_p=port_sensors.build_synthetic_calibration(
            rig_p, PBBOX, cv_res=CV_RES, inv_res=INV_RES, device="cpu"),
        frames_j=jax_frames(JaxScene(spheres=SPHERE), rig_j),
        frames_p=port_synthetic.render_rig_frames(
            port_synthetic.SyntheticScene(spheres=SPHERE), rig_p,
            device="cpu"),
    )


@pytest.mark.parametrize("field", [
    "cv_xyz", "cv_uv", "cv_xyz_inv", "depth_limits", "camera_positions",
    "bbox_min", "bbox_max",
])
def test_synthetic_calibration_equal(both, field):
    """Same numpy bake on both sides: exact (atol 0)."""
    np.testing.assert_array_equal(_np(getattr(both["calib_p"], field)),
                                  _np(getattr(both["calib_j"], field)))


@pytest.mark.parametrize("field", ["colors", "depths", "timestamp"])
def test_synthetic_frames_equal(both, field):
    np.testing.assert_array_equal(_np(getattr(both["frames_p"], field)),
                                  _np(getattr(both["frames_j"], field)))


def test_rig_equal(both):
    """The port's rig (its own copy of core/camera.py) holds the JAX
    package's values field for field."""
    assert type(both["rig_p"]) is not type(both["rig_j"])
    assert (dataclasses.asdict(both["rig_p"])
            == dataclasses.asdict(both["rig_j"]))


def test_pixel_models_match(both):
    """The torch fit against the jitted JAX fit. The ray model (a, b) agrees
    to 1e-6 (f32 rounding of values of order 1). The rational color-uv fit
    (p, q, r) is ill-conditioned wherever a texcoord hardly varies with
    depth: there a last-bit difference in its trilinear samples (the JAX
    CPU compiler contracts multiply-adds into FMAs) flips the singular-fit
    fallback, so the raw coefficients are not comparable. What the chain
    consumes is the evaluated texcoord: it agrees to 1e-6 over the
    interpolated depth range and to 5e-6 at the extrapolated ends."""
    cj = both["calib_j"]
    mj, rj = jax_pixel_models(cj.cv_xyz, cj.cv_uv, (56, 64))
    cp = both["calib_p"]
    mp, rp = port_sensors.derive_pixel_models(cp.cv_xyz, cp.cv_uv, (56, 64))
    for name in ("ray_a", "ray_b"):
        np.testing.assert_allclose(_np(getattr(mp, name)),
                                   _np(getattr(mj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    z_far = 1.0 - 0.5 / CV_RES[2]
    for d in np.linspace(0.05, z_far, 12):
        want = ((_np(mj.uv_p) + _np(mj.uv_q) * d)
                / (1.0 + _np(mj.uv_r) * d))
        got = _np((mp.uv_p + mp.uv_q * d) / (1.0 + mp.uv_r * d))
        tol = 1e-6 if 0.2 <= d <= 0.8 else 5e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"d={d}")
    assert rp <= 2e-3 and rj <= 2e-3
    assert abs(rp - rj) <= 1e-5


def test_projection_models_equal(both):
    """Same float64 numpy least squares on both sides: exact."""
    cj, cp = both["calib_j"], both["calib_p"]
    mj, rj = jax_projection_models(cj.cv_xyz, cj.cv_uv)
    mp, rp = port_sensors.derive_projection_models(cp.cv_xyz, cp.cv_uv)
    for f in dataclasses.fields(port_sensors.ProjectionModels):
        np.testing.assert_array_equal(_np(getattr(mp, f.name)),
                                      _np(getattr(mj, f.name)))
    assert rp == rj


def test_convert_carries_state(both):
    """JAX containers carried across as numpy equal the port's own."""
    calib = convert.calibration_from_numpy(
        jax_arrays(both["calib_j"]), device="cpu")
    frames = convert.frames_from_numpy(jax_arrays(both["frames_j"]),
                                       device="cpu")
    for src, dst in ((calib, both["calib_p"]), (frames, both["frames_p"])):
        for f in dataclasses.fields(dst):
            assert torch.equal(getattr(src, f.name), getattr(dst, f.name))
    with pytest.raises(KeyError):
        convert.frames_from_numpy({"colors": np.zeros(1)}, device="cpu")


def _coords(rng, shape, k):
    # normalized coords incl. out-of-range values that exercise the clamps
    return rng.uniform(-0.2, 1.2, shape + (k,)).astype(np.float32)


@pytest.mark.parametrize("fn", ["trilinear_3d", "bilinear_2d", "nearest_2d"])
def test_sampling_matches(fn):
    """GL sampling with edge clamp: identical taps and weights, so
    agreement to f32 rounding (1e-6 on values in [0, 1])."""
    rng = np.random.default_rng(3)
    if fn == "trilinear_3d":
        vol = rng.random((5, 6, 7, 3)).astype(np.float32)
        crd = _coords(rng, (50,), 3)
    else:
        vol = rng.random((6, 7, 3)).astype(np.float32)
        crd = _coords(rng, (50,), 2)
    want = getattr(jax_sampling, fn)(jnp.asarray(vol), jnp.asarray(crd))
    got = getattr(port_sampling, fn)(torch.from_numpy(vol),
                                     torch.from_numpy(crd))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


def test_rgb_to_lab_matches():
    """pow/cbrt may differ by an ulp between the two libraries: 1e-5
    relative to LAB values of order 1."""
    rng = np.random.default_rng(4)
    rgb = rng.random((64, 3)).astype(np.float32)
    want = np.asarray(jax_color.rgb_to_lab(jnp.asarray(rgb)))
    got = _np(port_color.rgb_to_lab(torch.from_numpy(rgb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
