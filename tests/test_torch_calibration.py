"""The port's calibration leftovers against the JAX package: the scattered
interpolators (calib/scattered.py, a numpy copy, bit for bit) and the
brute-force inverter (calib/inverter.py invert_calibration_bruteforce, in
torch on the CPU here), with tests/test_calibration.py:130-199's
assertions. The brute force is held against invert_calibration_knn (f64
kd-tree) and invert_calibration_bruteforce_jax at
tests/test_calibration.py:140's tolerances (rtol 1e-3, atol 1e-4) on the
valid texels, with the valid masks equal."""

import numpy as np
import pytest
import torch

from rgbd_recon_tpu.calib import scattered as jax_scattered
from rgbd_recon_tpu.calib.inverter import invert_calibration_bruteforce_jax

from rgbd_recon_tpu_torch.calib import inverter, scattered
from rgbd_recon_tpu_torch.calib.bake import bake_cv_xyz
from rgbd_recon_tpu_torch.calib.inverter import (
    invert_calibration_bruteforce,
    invert_calibration_knn,
)
from rgbd_recon_tpu_torch.core import BoundingBox
from rgbd_recon_tpu_torch.sensors.synthetic import default_test_rig

torch.set_num_threads(2)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def _cv_xyz(res):
    return bake_cv_xyz(default_test_rig(num_sensors=2, bbox=BBOX).sensors[0],
                       res=res)


def _close(a, b):
    np.testing.assert_array_equal(a[..., 3] > 0, b[..., 3] > 0)
    valid = a[..., 3] > 0
    np.testing.assert_allclose(a[valid], b[valid], rtol=1e-3, atol=1e-4)
    return int(valid.sum())


# cv_xyz and target sizes of tests/test_calibration.py:130 and :113
@pytest.mark.parametrize("cv_res,res", [((12, 14, 12), (6, 6, 6)),
                                        ((40, 48, 40), (16, 18, 16))])
def test_bruteforce_inversion_matches_knn(cv_res, res):
    cv = _cv_xyz(cv_res)
    got = invert_calibration_bruteforce(cv, BBOX, res, k=8, device="cpu")
    assert got.shape == (res[2], res[1], res[0], 4)
    assert got.dtype == np.float32
    assert _close(invert_calibration_knn(cv, BBOX, res, k=8), got) > 50
    assert (got[got[..., 3] <= 0] == -1.0).all()


def test_bruteforce_inversion_matches_jax():
    cv = _cv_xyz((12, 14, 12))
    got = invert_calibration_bruteforce(cv, BBOX, (6, 6, 6), k=8,
                                        device="cpu")
    want = invert_calibration_bruteforce_jax(cv, BBOX, (6, 6, 6), k=8)
    assert _close(want, got) > 50


def test_bruteforce_inversion_chunks_agree(monkeypatch):
    """Chunks of one target and of all targets give the same volume."""
    cv = _cv_xyz((12, 14, 12))
    whole = invert_calibration_bruteforce(cv, BBOX, (6, 6, 6), device="cpu")
    monkeypatch.setattr(inverter, "_CHUNK_BYTES", 1)
    one = invert_calibration_bruteforce(cv, BBOX, (6, 6, 6), device="cpu")
    np.testing.assert_array_equal(one, whole)


def test_idw_interpolate_exact_at_samples():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (60, 3))
    val = rng.uniform(-1, 1, (60, 2))
    out = scattered.idw_interpolate(pos, val, pos, k=4)
    np.testing.assert_allclose(out, val, atol=1e-4)
    np.testing.assert_array_equal(
        out, jax_scattered.idw_interpolate(pos, val, pos, k=4))


def test_mls_reproduces_linear_field():
    """Linear precision: the property of Sibson natural-neighbour
    interpolation that IDW lacks."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 1, (200, 3))
    A = np.array([[1.0, -2.0, 0.5], [0.0, 3.0, 1.0]])
    val = pos @ A.T + np.array([0.3, -0.1])
    q = rng.uniform(0.2, 0.8, (50, 3))
    out = scattered.mls_interpolate(pos, val, q, k=16)
    np.testing.assert_allclose(out, q @ A.T + np.array([0.3, -0.1]),
                               atol=1e-3)
    np.testing.assert_array_equal(
        out, jax_scattered.mls_interpolate(pos, val, q, k=16))


@pytest.mark.parametrize("method", ["mls", "idw"])
def test_build_lookup_volume_shape_and_values(method):
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 1, (300, 3))
    val = pos[:, :1] * 2.0  # linear field
    kw = dict(res=(8, 6, 4), space_min=np.zeros(3), space_max=np.ones(3),
              method=method)
    vol = scattered.build_lookup_volume(pos, val, **kw)
    assert vol.shape == (4, 6, 8, 1)
    # texel at x-center ~0.5+ carries ~2x
    assert abs(vol[2, 3, 4, 0] - 2.0 * (4.5 / 8)) < 0.1
    np.testing.assert_array_equal(
        vol, jax_scattered.build_lookup_volume(pos, val, **kw))
