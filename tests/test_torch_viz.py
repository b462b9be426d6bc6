"""The port's viz and calibration-file modules against the JAX package's:
stereo cameras and compositions, PNG output (decoded bytes against what the
JAX package writes through PIL), the map colorizations, the Kinect .yml
parser, calibration-volume files and the k-NN inverter.

Tolerances: stereo eye positions and the colorizations are the same numpy
arithmetic (exact); compositions exact; decoded PNG bytes exact; parsed
calibration fields exact; the inverter (the same numpy and scipy calls)
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib.bake import bake_cv_xyz
from rgbd_recon_tpu.calib.inverter import invert_calibration_knn as jax_invert
from rgbd_recon_tpu.calib.kinect_yml import parse_kinect_yml as jax_parse_yml
from rgbd_recon_tpu.calib.volume_io import (
    read_calibration_volume as jax_read_volume,
)
from rgbd_recon_tpu.calib.volume_io import (
    write_calibration_volume as jax_write_volume,
)
from rgbd_recon_tpu.core import BoundingBox
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.sensors.synthetic import default_test_rig
from rgbd_recon_tpu.viz import render as jax_render
from rgbd_recon_tpu.viz import stereo as jax_stereo

from rgbd_recon_tpu_torch.calib.inverter import invert_calibration_knn
from rgbd_recon_tpu_torch.calib.kinect_yml import parse_kinect_yml
from rgbd_recon_tpu_torch.calib.volume_io import (
    read_calibration_volume,
    write_calibration_volume,
)
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.viz import render as port_render
from rgbd_recon_tpu_torch.viz import stereo as port_stereo

from test_app import YML

torch.set_num_threads(2)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
CAM = dict(width=32, height=24, eye=(0.3, 1.3, 2.6), target=(0.0, 1.1, 0.0))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _images(seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 3)).astype(np.float32),
            rng.random((h, w, 3)).astype(np.float32))


# ---- stereo ----------------------------------------------------------------

@pytest.mark.parametrize("sep", [port_stereo.DEFAULT_EYE_SEPARATION, 0.2])
def test_stereo_eyes_match(sep):
    jcam = jax_stereo.StereoCamera(ViewCamera(**CAM), eye_separation=sep)
    pcam = port_stereo.StereoCamera(PortCamera(**CAM), eye_separation=sep)
    for side in ("left", "right"):
        j, p = getattr(jcam, side), getattr(pcam, side)
        assert p.eye == j.eye and p.target == j.target
        np.testing.assert_array_equal(p.rotation(), j.rotation())
    # the eyes sit sep apart along the cyclops' right axis
    d = np.subtract(pcam.right.eye, pcam.left.eye)
    np.testing.assert_allclose(d, PortCamera(**CAM).rotation()[:, 0] * sep,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("compose", ["compose_anaglyph",
                                     "compose_side_by_side"])
def test_compositions_match(compose):
    left, right = _images(1)
    want = getattr(jax_stereo, compose)(jnp.asarray(left), jnp.asarray(right))
    got = getattr(port_stereo, compose)(torch.from_numpy(left),
                                        torch.from_numpy(right))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["mono", "anaglyph", "side-by-side"])
def test_stereo_renderer_matches(mode):
    """Both wrappers around a renderer whose image encodes its camera's
    eye: the same cameras reach it and the same image comes out."""
    def factory(lib):
        def make_renderer(cam):
            def render(scale):
                img = np.broadcast_to(np.asarray(cam.eye, np.float32) * scale,
                                      (24, 32, 3)).copy()
                return (lib(img),)
            return render
        return make_renderer

    want = jax_stereo.make_stereo_renderer(
        factory(jnp.asarray),
        jax_stereo.StereoCamera(ViewCamera(**CAM)), mode=mode)(2.0)
    got = port_stereo.make_stereo_renderer(
        factory(torch.from_numpy),
        port_stereo.StereoCamera(PortCamera(**CAM)), mode=mode)(2.0)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_stereo_renderer_rejects_unknown_mode():
    with pytest.raises(ValueError, match="stereo mode"):
        port_stereo.make_stereo_renderer(
            lambda cam: None, port_stereo.StereoCamera(PortCamera(**CAM)),
            mode="top-bottom")


# ---- PNG output and colorizations -------------------------------------------

@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgb", "float_gray",
                                  "out_of_range"])
def test_save_image_matches_pil(tmp_path, kind):
    """The standard-library PNG decodes (through PIL) to the bytes the JAX
    package's PIL writer stores: clip, *255, truncate."""
    from PIL import Image

    rng = np.random.default_rng(2)
    img = {
        "float_rgb": rng.random((23, 31, 3)).astype(np.float32),
        "uint8_rgb": rng.integers(0, 256, (23, 31, 3)).astype(np.uint8),
        "float_gray": rng.random((23, 31)).astype(np.float32),
        "out_of_range": rng.uniform(-0.5, 1.5, (23, 31, 3)).astype(
            np.float32),
    }[kind]
    jax_render.save_image(tmp_path / "jax.png", img)
    port_render.save_image(tmp_path / "port.png", torch.from_numpy(img))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == (23, 31, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_colorizations_match():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.0, 1.0, (24, 32)).astype(np.float32)
    depth[rng.random((24, 32)) < 0.2] = 0.0
    normals = rng.normal(size=(24, 32, 3)).astype(np.float32)
    vol = rng.uniform(-0.02, 0.02, (6, 7, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        port_render.colorize_depth(torch.from_numpy(depth)),
        jax_render.colorize_depth(depth))
    np.testing.assert_array_equal(
        port_render.colorize_depth(depth, lo=0.2, hi=0.8),
        jax_render.colorize_depth(depth, lo=0.2, hi=0.8))
    np.testing.assert_array_equal(
        port_render.colorize_normals(torch.from_numpy(normals)),
        jax_render.colorize_normals(normals))
    for axis in range(3):
        np.testing.assert_array_equal(
            port_render.tsdf_slice_image(torch.from_numpy(vol), axis=axis,
                                         limit=0.01),
            jax_render.tsdf_slice_image(vol, axis=axis, limit=0.01))


def test_sensor_map_gallery_matches(tmp_path):
    """The six map PNGs of one sensor, decoded, equal the JAX package's."""
    from PIL import Image

    from rgbd_recon_tpu_torch.ops.preprocess import SensorMaps

    rng = np.random.default_rng(4)
    fields = dict(
        depth=rng.random((2, 12, 16, 2)), lab=rng.random((2, 12, 16, 3)),
        silhouette=(rng.random((2, 12, 16)) > 0.5),
        normal=rng.normal(size=(2, 12, 16, 3)),
        quality=rng.random((2, 12, 16)), raw_depth=rng.random((2, 12, 16)),
        color=rng.random((2, 20, 24, 3)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    maps = SensorMaps(**{k: torch.from_numpy(v) for k, v in fields.items()})

    class JaxMaps:     # the attributes sensor_map_gallery reads
        pass
    jmaps = JaxMaps()
    for k, v in fields.items():
        setattr(jmaps, k, jnp.asarray(v))
    want = jax_render.sensor_map_gallery(jmaps, tmp_path / "jax", sensor=1)
    got = port_render.sensor_map_gallery(maps, tmp_path / "port", sensor=1)
    assert [p.name for p in got] == [p.name for p in want]
    for p, q in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(q)))


# ---- calibration files -------------------------------------------------------

def test_kinect_yml_matches(tmp_path):
    p = tmp_path / "23.yml"
    p.write_text(YML)
    (tmp_path / "23.ext").write_text("0.5 1.0 -0.25\n1 0 0\n0 0 -1\n0 1 0\n")
    (tmp_path / "23.ext2").write_text("0.1 0.2 0.3\n0 1 0\n1 0 0\n0 0 1\n")
    (tmp_path / "23.local").write_text("0.01 0.02 0.03 5 10 15\n")
    (tmp_path / "23.serial").write_text("012345678947\n")
    (tmp_path / "23.bbx").write_text("-1 0 -1 1 2 1 -0.2 0 -0.2 0.2 0.5 0.2\n")
    want, got = jax_parse_yml(p), parse_kinect_yml(p)
    for name in want.__dataclass_fields__:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert got.compressed_rgb == 5 and got.serial == "012345678947"
    assert got.neg_max is not None
    assert got.to_rgbd_sensor() == want.to_rgbd_sensor()


def test_volume_io_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(5, 6, 7, 4)).astype(np.float32)
    write_calibration_volume(tmp_path / "a.cv_xyz_inv", vol, (0.5, 4.5))
    got, lim = read_calibration_volume(tmp_path / "a.cv_xyz_inv")
    np.testing.assert_array_equal(got, vol)
    assert lim == (0.5, 4.5)
    # files cross between the packages both ways, byte for byte
    jax_write_volume(tmp_path / "b.cv_uv", vol[..., :2], (0.5, 4.5))
    got2, lim2 = read_calibration_volume(tmp_path / "b.cv_uv", channels=2)
    np.testing.assert_array_equal(got2, vol[..., :2])
    write_calibration_volume(tmp_path / "c.cv_uv", vol[..., :2], lim2)
    assert ((tmp_path / "c.cv_uv").read_bytes()
            == (tmp_path / "b.cv_uv").read_bytes())
    np.testing.assert_array_equal(
        jax_read_volume(tmp_path / "a.cv_xyz_inv", channels=4)[0], vol)


def test_invert_matches():
    rig = default_test_rig(num_sensors=1, bbox=BBOX)
    cv = np.asarray(bake_cv_xyz(rig.sensors[0], res=(16, 20, 16)))
    want = jax_invert(cv, BBOX, (8, 9, 8))
    got = invert_calibration_knn(cv, BBOX, (8, 9, 8))
    assert got.shape == (8, 9, 8, 4)
    assert (got[..., 3] > 0).any() and (got[..., 3] < 0).any()
    np.testing.assert_array_equal(got, want)
