"""Reconstruction modes 0, 2, 3 and 4 of the PyTorch port against the JAX
package: the splat primitives, the four renderers fed the JAX package's
own SensorMaps (converted, so each test holds the renderer alone), the
camera helpers they use, ``CamParams.from_matrix``, ``diagnostics``, and a
``TsdfPipeline`` built with ``recon_mode=0`` (it fuses in every mode).

Scene (tests/test_recon_modes.py's): 2 sensors at 48x40 depth / 64x48
color, cv_res (16, 24, 16), inv_res (32, 36, 32), 6.25 cm voxels, one
sphere of radius 0.55 m, a 96x80 camera.

Tolerances:
- covered masks equal except at most KNIFE_EDGE_PIXELS pixels: XLA's CPU
  compiler contracts the calibration lookup and the projection into FMAs
  (ROADMAP §3), which moves a fragment's rounded pixel or its splat-radius
  and epsilon tests by an ulp;
- color atol COLOR_ATOL and window depth atol DEPTH_ATOL on the pixels
  both cover;
- the splat units, fed identical fragments: the z-buffer exact (a min),
  the accumulations atol 1e-6 (the same float adds);
- projected pixel coordinates atol 1e-4 px, view depth rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import splat as jax_splat
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import (
    CalibVisPipeline,
    MvtPipeline,
    PointsPipeline,
    TrigridPipeline,
    TsdfPipeline,
)
from rgbd_recon_tpu.recon.tsdf_pipeline import CamParams as JaxCamParams
from rgbd_recon_tpu.recon.tsdf_pipeline import RenderOutput as JaxOutput
from rgbd_recon_tpu.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch import recon as port_recon
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.core import VolumeGrid as PortGrid
from rgbd_recon_tpu_torch.ops import splat as port_splat
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import CamParams, RenderOutput

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

KNIFE_EDGE_PIXELS = 8
COLOR_ATOL = 1e-4
DEPTH_ATOL = 1e-5

# each package builds its own box, grid and configs from the same arguments
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
CAM = dict(width=96, height=80, eye=(0.0, 1.2, 2.5), target=(0.0, 1.1, 0.0))
# the test grid is ~10x coarser than the reference's 512 px grid, so the
# triangle cull's min_length scales up (tests/test_recon_modes.py)
MIN_LENGTH = 0.15


BASE_CFG = dict(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02)


def _cfg(**kw):
    return PipelineConfig(**BASE_CFG, **kw)


def _pcfg(**kw):
    return PortConfig(**BASE_CFG, **kw)


def _pgrid(grid):
    """The port's VolumeGrid with the JAX grid's arguments."""
    return PortGrid(bbox=PortBox(min=grid.bbox.min, max=grid.bbox.max),
                    voxel_size=grid.voxel_size)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def setup():
    """The JAX package's calibration, fused volume and maps, and their
    conversions into the port."""
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig)
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    volume, maps, counts = pipe.fuse(frames)
    return dict(
        calib=calib, frames=frames, pipe=pipe, volume=volume, maps=maps,
        counts=counts,
        pcalib=convert.calibration_from_numpy(jax_arrays(calib),
                                              device="cpu"),
        pmaps=convert.sensor_maps_from_numpy(jax_arrays(maps),
                                             device="cpu"),
        pvolume=torch.from_numpy(np.array(volume)),
        pcounts=torch.from_numpy(np.array(counts)),
    )


def assert_renders_match(jax_out, port_out, min_covered=50):
    img_j, depth_j, cov_j = (np.asarray(x) for x in jax_out)
    img_p, depth_p, cov_p = (_np(x) for x in port_out)
    assert img_p.shape == img_j.shape and depth_p.shape == depth_j.shape
    assert cov_j.sum() >= min_covered
    assert (cov_j != cov_p).sum() <= KNIFE_EDGE_PIXELS
    both = cov_j & cov_p
    np.testing.assert_allclose(img_p[both], img_j[both], rtol=0,
                               atol=COLOR_ATOL)
    np.testing.assert_allclose(depth_p[both], depth_j[both], rtol=0,
                               atol=DEPTH_ATOL)
    # elsewhere the z-buffer (a zero-weight fragment leaves a depth on an
    # uncovered pixel) differs only at the knife edges
    off = np.abs(depth_p - depth_j) > DEPTH_ATOL
    assert (off & ~both).sum() <= KNIFE_EDGE_PIXELS
    assert (img_p[~cov_p] == 0.0).all()


# ---- splat units -----------------------------------------------------------

def _fragments(seed, n=600):
    """Random world points around the sphere with out-of-view and
    behind-camera cases, random radii and a random valid mask."""
    rng = np.random.default_rng(seed)
    world = rng.uniform([-1.2, 0.3, -1.0], [1.2, 2.0, 1.0],
                        (n, 3)).astype(np.float32)
    world[: n // 10, 2] = rng.uniform(2.6, 4.0, n // 10)   # behind the eye
    world[n // 10: n // 5, 0] = rng.uniform(3.0, 6.0, n // 10)  # off-screen
    radius = rng.uniform(0.0, 2.5, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    values = rng.random((n, 3)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return world, radius, valid, values, weights


def _projected(seed):
    """The JAX projection of _fragments (shared by both packages' scatter
    calls, so the units hold the scatters alone)."""
    world, radius, valid, values, weights = _fragments(seed)
    xy, z = jax_splat.project_points(jnp.asarray(world), ViewCamera(**CAM))
    xy, z = np.array(xy), np.array(z)
    valid = valid & (z > 0.1)
    # in-view fragments exactly on a rounding tie, which both packages
    # round half to even
    xy[200:210] = np.floor(xy[200:210]) + 0.5
    return xy, z, valid, radius, values, weights


def test_project_points_matches():
    world = _fragments(1)[0]
    xy_j, z_j = jax_splat.project_points(jnp.asarray(world),
                                         ViewCamera(**CAM))
    xy_p, z_p = port_splat.project_points(torch.from_numpy(world),
                                          PortCamera(**CAM))
    z_j = np.asarray(z_j)
    assert (z_j < 0).sum() > 20          # behind-camera cases present
    np.testing.assert_allclose(_np(z_p), z_j, rtol=1e-6, atol=1e-7)
    front = z_j > 0.1
    np.testing.assert_allclose(_np(xy_p)[front], np.asarray(xy_j)[front],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("radius,max_radius", [
    ("none", 2), ("random", 2), ("random", 1)])
def test_zbuffer_min_matches(radius, max_radius):
    xy, z, valid, rad, _, _ = _projected(2)
    rad_j = None if radius == "none" else jnp.asarray(rad)
    rad_p = None if radius == "none" else torch.from_numpy(rad)
    want = jax_splat.zbuffer_min(jnp.asarray(xy), jnp.asarray(z),
                                 jnp.asarray(valid), (80, 96), rad_j,
                                 max_radius=max_radius)
    got = port_splat.zbuffer_min(torch.from_numpy(xy), torch.from_numpy(z),
                                 torch.from_numpy(valid), (80, 96), rad_p,
                                 max_radius=max_radius)
    want = np.asarray(want)
    assert np.isfinite(want).sum() > 100 and np.isinf(want).sum() > 100
    np.testing.assert_array_equal(_np(got), want)


def test_accumulate_epsilon_matches():
    xy, z, valid, rad, values, weights = _projected(3)
    zbuf = jax_splat.zbuffer_min(jnp.asarray(xy), jnp.asarray(z),
                                 jnp.asarray(valid), (80, 96),
                                 jnp.asarray(rad))
    acc_j, w_j = jax_splat.accumulate_epsilon(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(valid),
        jnp.asarray(values), jnp.asarray(weights), zbuf, 0.3,
        radius=jnp.asarray(rad))
    acc_p, w_p = port_splat.accumulate_epsilon(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(valid),
        torch.from_numpy(values), torch.from_numpy(weights),
        torch.from_numpy(np.array(zbuf)), 0.3,
        radius=torch.from_numpy(rad))
    assert (np.asarray(w_j) > 0).sum() > 100
    np.testing.assert_allclose(_np(acc_p), np.asarray(acc_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(w_p), np.asarray(w_j), rtol=0, atol=1e-6)


def test_resolve_winners_matches():
    xy, z, valid, rad, values, _ = _projected(4)
    zbuf = jax_splat.zbuffer_min(jnp.asarray(xy), jnp.asarray(z),
                                 jnp.asarray(valid), (80, 96),
                                 jnp.asarray(rad))
    img_j, cov_j = jax_splat.resolve_winners(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(valid),
        jnp.asarray(values), zbuf, radius=jnp.asarray(rad), z_tol=1e-4)
    img_p, cov_p = port_splat.resolve_winners(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(valid),
        torch.from_numpy(values), torch.from_numpy(np.array(zbuf)),
        radius=torch.from_numpy(rad), z_tol=1e-4)
    np.testing.assert_array_equal(_np(cov_p), np.asarray(cov_j))
    np.testing.assert_allclose(_np(img_p), np.asarray(img_j), rtol=0,
                               atol=1e-6)


# ---- camera helpers ---------------------------------------------------------

def test_world_to_view_and_window_depth_match():
    rng = np.random.default_rng(5)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    jcam, pcam = ViewCamera(**CAM), PortCamera(**CAM)
    np.testing.assert_allclose(_np(pcam.world_to_view(torch.from_numpy(p))),
                               np.asarray(jcam.world_to_view(jnp.asarray(p))),
                               rtol=0, atol=1e-6)
    # across the near clamp (n * 1.001) and the far clip
    z = np.concatenate([rng.uniform(0.0, 0.2, 32), rng.uniform(0.2, 30, 32),
                        [0.1, 0.1001, 20.0]]).astype(np.float32)
    np.testing.assert_allclose(_np(pcam.window_depth(torch.from_numpy(z))),
                               np.asarray(jcam.window_depth(jnp.asarray(z))),
                               rtol=0, atol=1e-7)


def test_cam_params_from_matrix_matches():
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = q
    mat[:3, 3] = [0.3, 1.4, 2.2]
    want = JaxCamParams.from_matrix(mat, BBOX)
    got = CamParams.from_matrix(mat, PBBOX, device="cpu")
    for f in ("eye_w", "rot", "eye_vol"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


# ---- the four renderers on the JAX maps ------------------------------------

@pytest.mark.parametrize("shade_mode", [0, 1, 2, 3])
def test_points_matches(setup, shade_mode):
    want = PointsPipeline(setup["calib"], _cfg(shade_mode=shade_mode)
                          ).make_renderer(ViewCamera(**CAM))(setup["maps"])
    got = port_recon.PointsPipeline(setup["pcalib"],
                                    _pcfg(shade_mode=shade_mode)
                                    ).make_renderer(
        PortCamera(**CAM))(setup["pmaps"])
    assert_renders_match(want, got)


@pytest.mark.parametrize("epsilon", [0.075, 1e-4])
def test_trigrid_matches(setup, epsilon):
    want = TrigridPipeline(setup["calib"], _cfg(), min_length=MIN_LENGTH,
                           epsilon=epsilon).make_renderer(
        ViewCamera(**CAM))(setup["maps"])
    got = port_recon.TrigridPipeline(
        setup["pcalib"], _pcfg(), min_length=MIN_LENGTH,
        epsilon=epsilon).make_renderer(PortCamera(**CAM))(setup["pmaps"])
    assert_renders_match(want, got)


@pytest.mark.parametrize("bilateral", [True, False])
def test_mvt_matches(setup, bilateral):
    want = MvtPipeline(setup["calib"], _cfg(bilateral=bilateral),
                       min_length=MIN_LENGTH
                       ).make_renderer(ViewCamera(**CAM))(setup["maps"])
    got = port_recon.MvtPipeline(setup["pcalib"], _pcfg(bilateral=bilateral),
                                 min_length=MIN_LENGTH
                                 ).make_renderer(PortCamera(**CAM))(
        setup["pmaps"])
    assert_renders_match(want, got)


@pytest.mark.parametrize("max_points,stride", [(1 << 20, 1), (8192, 2)])
def test_calibvis_matches(setup, max_points, stride):
    grid = setup["pipe"].volume_grid
    want = CalibVisPipeline(grid, 0.02, max_points=max_points).make_renderer(
        ViewCamera(**CAM))(setup["volume"])
    pipe = port_recon.CalibVisPipeline(_pgrid(grid), 0.02,
                                       max_points=max_points)
    # ceil((32 * 36 * 32 / max_points)^(1/3))
    assert pipe.stride == stride
    got = pipe.make_renderer(PortCamera(**CAM))(setup["pvolume"])
    assert_renders_match(want, got, min_covered=50 // stride ** 2)
    img = _np(got[0])[_np(got[2])]
    # red and green voxels present (the fused volume has none at +limit)
    assert all((img.argmax(-1) == c).any() for c in range(2))


def test_calibvis_color_classes_match(setup):
    """Calib-vis on a random volume holding all four classes (red, green,
    blue at >= +limit, discarded at <= -limit)."""
    grid = setup["pipe"].volume_grid
    rng = np.random.default_rng(7)
    vol = rng.uniform(-0.03, 0.03, grid.shape).astype(np.float32)
    vol[rng.random(grid.shape) < 0.7] = -0.02      # mostly discarded
    want = CalibVisPipeline(grid, 0.02).make_renderer(ViewCamera(**CAM))(
        jnp.asarray(vol))
    got = port_recon.CalibVisPipeline(_pgrid(grid), 0.02).make_renderer(
        PortCamera(**CAM))(torch.from_numpy(vol))
    assert_renders_match(want, got)
    img = _np(got[0])[_np(got[2])]
    assert all((img.argmax(-1) == c).any() for c in range(3))
    assert (img == [0.0, 0.0, 1.0]).all(-1).any()


# ---- the pipeline: repair of the recon_mode check, diagnostics --------------

def test_recon_mode_0_fuses_same_volume(setup):
    """A TsdfPipeline built with recon_mode=0 fuses (the app fuses in every
    mode) the JAX volume at tests/test_torch_fuse.py's tolerance."""
    jvol, _, jcounts = TsdfPipeline(setup["calib"], _cfg(recon_mode=0),
                                    BBOX).fuse(setup["frames"])
    pframes = convert.frames_from_numpy(
        jax_arrays(setup["frames"]), device="cpu")
    pvol, _, pcounts = port_recon.TsdfPipeline(
        setup["pcalib"], _pcfg(recon_mode=0), PBBOX).fuse(pframes)
    np.testing.assert_array_equal(_np(pcounts), np.asarray(jcounts))
    np.testing.assert_allclose(_np(pvol), np.asarray(jvol), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("overflow", [None, (3, 0, 7, 1)])
def test_diagnostics_match(setup, overflow):
    jpipe = setup["pipe"]
    ppipe = port_recon.TsdfPipeline(setup["pcalib"], _pcfg(), PBBOX)
    # a brick capacity below the occupancy, so bricks_dropped is nonzero
    occ = int((np.asarray(setup["counts"]) > _cfg().min_voxels_per_brick
               ).sum())
    cap = dict(brick_capacity=max(occ - 5, 1))
    jpipe_c = TsdfPipeline(setup["calib"], _cfg(**cap), BBOX)
    ppipe_c = port_recon.TsdfPipeline(setup["pcalib"], _pcfg(**cap), PBBOX)
    jout = pout = None
    if overflow is not None:
        z = np.zeros((4, 4), np.float32)
        jout = JaxOutput(color=jnp.zeros((4, 4, 3)), depth=jnp.asarray(z),
                         hit=jnp.asarray(z > 0), num_samples=jnp.asarray(z),
                         overflow=jnp.asarray(overflow, jnp.int32))
        pout = RenderOutput(color=torch.zeros(4, 4, 3),
                            depth=torch.from_numpy(z),
                            hit=torch.from_numpy(z > 0),
                            num_samples=torch.from_numpy(z),
                            overflow=torch.tensor(overflow,
                                                  dtype=torch.int32))
    for jp, pp in ((jpipe, ppipe), (jpipe_c, ppipe_c)):
        want = jp.diagnostics(setup["counts"], jout)
        got = pp.diagnostics(setup["pcounts"], pout)
        assert got == want
    assert want["bricks_dropped"] == (5 if occ > 5 else 0)


def test_shade_mode_3_in_the_pipeline(setup):
    """shade_mode=3 (the camera-influence view) in a TsdfPipeline: the same
    hits and window depth as the default render (it changes color only),
    colors that differ from it, and PointsPipeline takes the value too."""
    pframes = convert.frames_from_numpy(jax_arrays(setup["frames"]),
                                        device="cpu")
    renders = []
    for kw in ({}, {"shade_mode": 3}):
        pipe = port_recon.TsdfPipeline(setup["pcalib"], _pcfg(**kw), PBBOX)
        volume, maps, counts = pipe.fuse(pframes)
        renders.append(pipe.make_renderer(PortCamera(**CAM))(volume, maps,
                                                             counts))
    base, cams = renders
    assert int(cams.hit.sum()) > 100
    assert torch.equal(cams.hit, base.hit)
    assert torch.equal(cams.depth, base.depth)
    assert not torch.equal(cams.color, base.color)
    port_recon.PointsPipeline(setup["pcalib"],
                              dataclasses.replace(_pcfg(), shade_mode=3))


def test_calibvis_interface_matches():
    """CalibVisPipeline's constructor (volume_grid, tsdf_limit,
    active_kinect, max_points), positionally as by keyword, and its two
    setters, against the JAX package's."""
    import inspect

    from rgbd_recon_tpu.core import VolumeGrid

    params = list(inspect.signature(
        port_recon.CalibVisPipeline.__init__).parameters)
    assert params == list(inspect.signature(
        CalibVisPipeline.__init__).parameters)
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.0625)
    want = CalibVisPipeline(grid, 0.03, 2, 4096)
    got = port_recon.CalibVisPipeline(_pgrid(grid), 0.03, 2, 4096)
    for name in ("tsdf_limit", "active_kinect", "stride"):
        assert getattr(got, name) == getattr(want, name), name
    for pipe in (want, got):
        pipe.set_active_kinect(3)
        pipe.set_tsdf_limit(0.05)
    assert (got.active_kinect, got.tsdf_limit) == (
        want.active_kinect, want.tsdf_limit) == (3, 0.05)
