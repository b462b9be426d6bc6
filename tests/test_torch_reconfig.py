"""Runtime reconfiguration of the port's TsdfPipeline: tests/test_reconfig.py's
first two tests on the port alone, with their assertions (the JAX
package's are the oracle; where they count jit traces, the port's
counterpart is that no renderer rebuilds), then what callers see besides:
a renderer handle made before a change renders with the changed grid,
config and calibration; unknown fields raise; fuse_single_program is fuse;
and the eight methods take the JAX package's arguments.

Scene (tests/test_reconfig.py's): 2 sensors at 48x40 depth / 64x48 color,
cv_res (16, 24, 16), inv_res (32, 36, 32), one sphere, a 64x48 camera."""

import dataclasses
import inspect

import pytest
import torch

from rgbd_recon_tpu.recon import TsdfPipeline as JaxPipeline

from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.recon import TsdfPipeline
from rgbd_recon_tpu_torch.refine.pose_ba import apply_pose_corrections
from rgbd_recon_tpu_torch.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

torch.set_num_threads(2)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
CAM = ViewCamera(width=64, height=48, eye=(0.0, 1.3, 2.6),
                 target=(0.0, 1.1, 0.0))


@pytest.fixture(scope="module")
def setup():
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32), device="cpu")
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig, device="cpu")
    return calib, frames


def _cfg(**kw):
    return PipelineConfig(**{**dict(voxel_size=0.05, brick_size=0.25,
                                    tsdf_limit=0.02, num_lods=4), **kw})


def test_voxel_size_flip_keeps_frames_flowing(setup):
    """set_voxel_size re-derives the grids and bakes; the renderer handle
    made before keeps working, and flipping back renders the first image's
    hit mask again."""
    calib, frames = setup
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    renderer = pipe.make_renderer(CAM)

    v1, m1, c1 = pipe.fuse(frames)
    out1 = renderer(v1, m1, c1)
    shape1 = tuple(v1.shape)
    assert int(out1.hit.sum()) > 50

    pipe.set_voxel_size(0.025)          # 2x finer mid-run
    v2, m2, c2 = pipe.fuse(frames)
    assert tuple(v2.shape) != shape1
    assert tuple(v2.shape) == pipe.volume_grid.shape
    out2 = renderer(v2, m2, c2)         # same handle, rebuilt
    assert int(out2.hit.sum()) > 50

    pipe.set_voxel_size(0.05)           # flip back
    v3, m3, c3 = pipe.fuse(frames)
    assert tuple(v3.shape) == shape1
    out3 = renderer(v3, m3, c3)
    assert torch.equal(out3.hit, out1.hit)


def test_tsdf_limit_swap_without_rebuild(setup):
    """set_tsdf_limit re-integrates at the new band and rebuilds nothing
    (the reference's slider re-integrates only; the JAX package asserts no
    retrace, here the generation renderers follow stays)."""
    calib, frames = setup
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    v1, m1, c1 = pipe.fuse(frames)
    gen = pipe._generation

    pipe.set_tsdf_limit(0.04)
    v2, _, _ = pipe.fuse(frames)
    assert pipe._generation == gen, "limit change rebuilt the renderers"
    # a doubled truncation band genuinely changes the fused field
    assert float((v2 - v1).abs().max()) > 1e-4
    assert float(v2.max()) > float(v1.max()) + 1e-3


def test_renderer_handle_follows_changes(setup):
    """One handle across a change of shape, a change of config and a
    calibration swap renders what a handle made after each change renders
    (a closure that kept the old grid, config or cv_xyz_inv would not);
    set_tsdf_limit keeps the handle's march step bound."""
    calib, frames = setup
    pipe = TsdfPipeline(calib, _cfg(projection_model=False), BBOX)
    handle = pipe.make_renderer(CAM)
    handle(*pipe.fuse(frames))

    def same_as_new():
        state = pipe.fuse(frames)
        got, want = handle(*state), pipe.make_renderer(CAM)(*state)
        for f in ("color", "depth", "hit", "num_samples", "overflow"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        return got

    pipe.set_brick_size(0.2)
    assert pipe.brick_vox == 4
    same_as_new()
    pipe.reconfigure(shade_mode=2, march_chunk=4)
    same_as_new()
    poses = torch.zeros((2, 6))
    poses[1] = torch.tensor([0.0, 0.03, 0.0, 0.02, 0.0, -0.01])
    before = same_as_new()
    pipe.update_calibration(apply_pose_corrections(pipe.calib, poses))
    after = same_as_new()
    assert not torch.equal(after.color, before.color)
    # a limit change rebuilds nothing: the handle keeps its build's march
    # step bound and marches at the new limit
    gen = pipe._generation
    pipe.set_tsdf_limit(0.03)
    assert pipe._generation == gen
    assert int(handle(*pipe.fuse(frames)).hit.sum()) > 50


def test_reconfigure_unknown_field_raises(setup):
    calib, _ = setup
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    with pytest.raises(AttributeError, match="no_such_field"):
        pipe.reconfigure(no_such_field=1)
    with pytest.raises(AttributeError, match="from_conf"):
        pipe.reconfigure(from_conf=None)


def test_fuse_single_program_is_fuse(setup):
    calib, frames = setup
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    for a, b in zip(pipe.fuse_single_program(frames), pipe.fuse(frames)):
        got = a if isinstance(a, torch.Tensor) else a.depth
        want = b if isinstance(b, torch.Tensor) else b.depth
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", [
    "integrate_dense", "update_calibration", "refine_sensor_poses",
    "fuse_single_program", "set_tsdf_limit", "set_voxel_size",
    "set_brick_size", "reconfigure"])
def test_method_signatures_match(name):
    """The port's method takes the JAX package's parameters, with the same
    defaults."""
    def params(cls):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(getattr(cls, name)).parameters.values()]
    assert params(TsdfPipeline) == params(JaxPipeline)


def test_integrate_dense_caches_its_projections(setup):
    """integrate_dense bakes the per-voxel projections once (a brick-
    compact pipeline has none of its own) and drops them on a calibration
    swap and a change of shape."""
    calib, frames = setup
    pipe = TsdfPipeline(calib, _cfg(brick_size=0.2), BBOX)
    assert pipe.compact
    _, maps, _ = pipe.fuse(frames)
    v1 = pipe.integrate_dense(maps, limit=0.04)
    baked = pipe._dense_projections
    assert baked is not None
    v2, obs = pipe.integrate_dense(maps, limit=0.04, return_observers=True)
    assert pipe._dense_projections is baked
    assert torch.equal(v1, v2) and float(obs.max()) >= 1.0
    pipe.update_calibration(dataclasses.replace(pipe.calib))
    assert pipe._dense_projections is None
    pipe.integrate_dense(maps)
    pipe.set_voxel_size(0.1)
    assert pipe._dense_projections is None
