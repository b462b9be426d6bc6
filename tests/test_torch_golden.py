"""The port's reference-exact dense path against the committed golden
fixture of the independent NumPy pipeline (tests/golden/golden_small.npz,
made by scripts/make_golden.py with its SCENE and config: dense integrate
with bilinear taps, render_dense with the trilinear march, calibration-
volume blend, pull-push), at tests/test_golden.py's tolerances. The port
preprocesses its own frames of the same scene."""

import os
import sys

import numpy as np
import pytest
import torch

from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
from rgbd_recon_tpu_torch.sensors import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "golden", "golden_small.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))

from make_golden import SCENE  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def port_run():
    s = SCENE
    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = synthetic.default_test_rig(
        num_sensors=s["num_sensors"], depth_size=s["depth_size"],
        color_size=s["color_size"], bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=s["cv_res"],
                                        inv_res=s["inv_res"], device="cpu")
    frames = synthetic.render_rig_frames(
        synthetic.SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig,
        device="cpu")
    cfg = PipelineConfig(
        voxel_size=s["voxel_size"], brick_size=s["brick_size"],
        tsdf_limit=s["tsdf_limit"], num_lods=s["num_lods"],
        bricking=False, skip_space=False, march_mode="trilinear",
        march_empty_skip=False, integrate_taps="bilinear",
        projection_model=False, march_dtype="float32", mark_stride=1,
    )
    pipe = TsdfPipeline(calib, cfg, bbox)
    assert not pipe.compact
    maps, counts = pipe.preprocess(frames)
    volume = pipe.integrate(maps, counts)
    camera = ViewCamera(
        width=s["width"], height=s["height"], eye=s["eye"],
        target=s["target"], fov_y=s["fov_y"], near=s["near"], far=s["far"])
    render, _ = pipe.make_render_fn(camera)
    assert not render.use_blocks
    out = pipe.make_renderer(camera)(volume, maps, counts)
    return maps, volume, out


def test_port_maps_match_fixture(golden, port_run):
    maps, _, _ = port_run
    np.testing.assert_allclose(maps.depth[..., 0].numpy(),
                               golden["maps_depth"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(maps.quality.numpy(), golden["maps_quality"],
                               rtol=1e-4, atol=1e-6)


def test_port_volume_matches_fixture(golden, port_run):
    _, volume, _ = port_run
    np.testing.assert_allclose(volume.numpy(), golden["volume"], rtol=1e-4,
                               atol=1e-6)


def test_port_render_matches_fixture(golden, port_run):
    _, _, out = port_run
    hit_p = out.hit.numpy()
    hit_n = golden["hit"]
    assert hit_n.sum() > 10
    assert (hit_p != hit_n).sum() <= max(2, int(0.02 * hit_n.sum()))
    both = hit_p & hit_n
    np.testing.assert_allclose(out.depth.numpy()[both], golden["depth"][both],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(out.color.numpy()[both], golden["color"][both],
                               rtol=0, atol=1e-3)
