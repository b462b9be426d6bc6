"""Sensor-pose refinement of the port (rgbd_recon_tpu_torch/refine and
TsdfPipeline.refine_sensor_poses) against the JAX package on the CPU, stage
by stage and then whole, on tests/test_refine.py's small rig: 4 sensors at
48x40 depth / 64x48 color, sensor 1 calibrated 4 cm off in x, 4 cm voxels,
limit 0.03, bricking and the three filters off. The JAX package's state
(calibration, maps, volumes) is carried across as numpy, so each stage sees
the same inputs; the whole runs compare the outcome. Then
tests/test_refine.py's two recovery tests on the port alone, with their
assertions.

Tolerances (all f32 on both sides; the sums run in another order):
- rotation and apply_pose: 1e-6 abs (values), 2e-6 (Jacobians);
- volumes rtol 1e-4 (tests/test_golden.py's), with atol JIT_ATOL where
  the JAX side is its jitted dense integrate (TsdfPipeline.integrate,
  integrate_dense): inside the jit the CPU compiler contracts the
  calibration lookups into FMAs, which moves ~1 voxel in 10^4 by up to
  ~4e-6 (its eager integrate agrees with the port at atol 1e-6); observer
  counts equal except at
  OBS_KNIFE_EDGE voxels (the same contraction can move |sdist| across the
  band's edge);
- normal equations rtol 1e-4 of their largest entry; the mean |r| 1e-6;
- residual stats 1e-6; calibrations after corrections 2e-6 abs, but
  cv_xyz_inv WARP_ATOL: the warp samples it at R^T (p - t), and the slope
  of its validity channel (-1 to 1 across one texel) multiplies the last-ulp
  differences of that position;
- poses after LM: POSE_ATOL (about a thousandth of the 4 cm correction);
  the LM accept/reject sequence and the worst sensor are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_recon_tpu.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu.core.camera import RGBDSensor, SensorRig
from rgbd_recon_tpu.core.config import PipelineConfig
from rgbd_recon_tpu.core.grid import BoundingBox
from rgbd_recon_tpu.ops import tsdf as jax_tsdf
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.refine import pose_ba as jax_ba
from rgbd_recon_tpu.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

import jax

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.core.camera import RGBDSensor as PortSensor
from rgbd_recon_tpu_torch.core.camera import SensorRig as PortRig
from rgbd_recon_tpu_torch.ops import tsdf as port_tsdf
from rgbd_recon_tpu_torch.recon import TsdfPipeline as PortPipeline
from rgbd_recon_tpu_torch.refine import pose_ba as port_ba
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
CFG = dict(voxel_size=0.04, brick_size=0.25, tsdf_limit=0.03, bricking=False,
           bilateral=False, morph=False, refine=False)
LIMIT = 0.03
OBS_KNIFE_EDGE = 8
JIT_ATOL = 1e-5
WARP_ATOL = 5e-5
POSE_ATOL = 5e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _offset_rig(sensors_mod, rig, offset):
    """``rig`` with sensor 1's depth camera moved by ``offset``."""
    s1 = rig.sensors[1]
    moved = dataclasses.replace(
        s1.depth, t_cw=tuple((np.asarray(s1.depth.t_cw) + offset).tolist()))
    return sensors_mod[1](sensors=(
        rig.sensors[0],
        sensors_mod[0](depth=moved, color=s1.color, serial=s1.serial),
        rig.sensors[2], rig.sensors[3]))


@pytest.fixture(scope="module")
def rig():
    """JAX state of test_refine.py's first rig (fused with the bad
    calibration) and the port's pipeline on the same calibration and
    maps, carried across."""
    good = default_test_rig(num_sensors=4, depth_size=(48, 40),
                            color_size=(64, 48), bbox=BBOX)
    bad = _offset_rig((RGBDSensor, SensorRig), good,
                      np.array([0.04, 0.0, 0.0], np.float32))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), good)
    calib = build_synthetic_calibration(bad, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(40, 44, 40))
    jpipe = TsdfPipeline(calib, PipelineConfig(**CFG), BBOX)
    volume, maps, counts = jpipe.fuse(frames)
    pcalib = convert.calibration_from_numpy(jax_arrays(calib), device="cpu")
    ppipe = PortPipeline(pcalib, PortConfig(**CFG), PBBOX)
    return dict(
        frames=frames, calib=calib, jpipe=jpipe, volume=volume, maps=maps,
        counts=counts, pcalib=pcalib, ppipe=ppipe,
        pframes=convert.frames_from_numpy(jax_arrays(frames), device="cpu"),
        pmaps=convert.sensor_maps_from_numpy(jax_arrays(maps), device="cpu"),
        pcounts=_t(counts), pvolume=_t(volume))


@pytest.fixture(scope="module")
def loo(rig):
    """Leave-one-out volumes with observer counts at the nominal band, in
    both packages, from the same maps."""
    jv, jo = jax_ba.leave_one_out_volumes(rig["jpipe"], rig["maps"],
                                          rig["counts"],
                                          return_observers=True)
    pv, po = port_ba.leave_one_out_volumes(rig["ppipe"], rig["pmaps"],
                                           rig["pcounts"],
                                           return_observers=True)
    return jv, jo, pv, po


# ---- rotation and pose ------------------------------------------------------

@pytest.mark.parametrize("w", [(0.0, 0.0, 0.0), (0.1, -0.2, 0.05),
                               (1e-7, 0.0, -2e-7)])
def test_rodrigues_and_apply_pose_match(w):
    """_rodrigues and apply_pose at w = 0, away from it, and inside the
    small-angle branch, with their forward-mode Jacobians."""
    w = np.asarray(w, np.float32)
    np.testing.assert_allclose(
        _np(port_ba._rodrigues(_t(w))),
        np.asarray(jax_ba._rodrigues(jnp.asarray(w))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(torch.func.jacfwd(port_ba._rodrigues)(_t(w))),
        np.asarray(jax.jacfwd(jax_ba._rodrigues)(jnp.asarray(w))),
        rtol=0, atol=2e-6)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.0, 2.0, (64, 3)).astype(np.float32)
    center = np.array([0.0, 1.1, 0.0], np.float32)
    p = np.concatenate([w, [0.01, -0.02, 0.03]]).astype(np.float32)

    def port_fn(q):
        return port_ba.apply_pose(q, _t(pts), _t(center))

    def jax_fn(q):
        return jax_ba.apply_pose(q, jnp.asarray(pts), jnp.asarray(center))

    np.testing.assert_allclose(_np(port_fn(_t(p))),
                               np.asarray(jax_fn(jnp.asarray(p))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(torch.func.jacfwd(port_fn)(_t(p))),
                               np.asarray(jax.jacfwd(jax_fn)(jnp.asarray(p))),
                               rtol=0, atol=2e-6)


def test_apply_pose_identity_translation_rotation():
    """tests/test_refine.py's first two tests on the port."""
    pts = _t(np.random.default_rng(0).normal(size=(10, 3)).astype(
        np.float32))
    np.testing.assert_allclose(_np(port_ba.apply_pose(torch.zeros(6), pts)),
                               _np(pts), atol=1e-6)
    out = port_ba.apply_pose(torch.tensor([0, 0, 0, 0.1, -0.2, 0.3]), pts)
    np.testing.assert_allclose(_np(out), _np(pts) + [0.1, -0.2, 0.3],
                               atol=1e-6)
    rot = port_ba.apply_pose(torch.tensor([0, 0, np.pi / 2, 0, 0, 0]),
                             torch.tensor([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(_np(rot)[0], [0.0, 1.0, 0.0], atol=1e-6)


# ---- dense integration with observers, leave-one-out volumes ---------------

def test_integrate_observers_match(rig):
    """ops/tsdf.py integrate(return_observers=True): the volume at rtol
    1e-4, the observer counts equal except at OBS_KNIFE_EDGE voxels."""
    m = rig["maps"]
    shape = rig["jpipe"].volume_grid.shape
    args = [np.asarray(m.depth[..., 0]), np.asarray(m.quality),
            np.asarray(m.silhouette)]
    jv, jo = jax_tsdf.integrate(shape, rig["calib"].cv_xyz_inv,
                                *(jnp.asarray(a) for a in args), LIMIT,
                                return_observers=True)
    pv, po = port_tsdf.integrate(shape, rig["pcalib"].cv_xyz_inv,
                                 *(_t(a) for a in args), LIMIT,
                                 return_observers=True)
    assert float(np.asarray(jo).max()) >= 2.0
    np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-4,
                               atol=1e-6)
    assert (_np(po) != np.asarray(jo)).sum() <= OBS_KNIFE_EDGE


@pytest.mark.parametrize("observers", [True, False])
def test_leave_one_out_volumes_match(rig, loo, observers):
    """Volume i without sensor i: with observer counts (dense) and without
    (the pipeline's integrate)."""
    if observers:
        jv, jo, pv, po = loo
        assert (_np(po) != np.asarray(jo)).sum() <= OBS_KNIFE_EDGE
    else:
        jv = jax_ba.leave_one_out_volumes(rig["jpipe"], rig["maps"],
                                          rig["counts"])
        pv = port_ba.leave_one_out_volumes(rig["ppipe"], rig["pmaps"],
                                           rig["pcounts"])
    assert pv.shape == (4,) + rig["ppipe"].volume_grid.shape
    np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-4,
                               atol=JIT_ATOL)


# ---- one sensor's normal equations, one LM iteration ------------------------

def _common(rig):
    calib = rig["calib"]
    bmin = np.asarray(calib.bbox_min)
    bsize = np.asarray(calib.bbox_max) - bmin
    return bmin, bsize, (bmin + 0.5 * bsize).astype(np.float32)


@pytest.mark.parametrize("pose", ["zero", "moved"])
def test_normal_equations_match(rig, loo, pose):
    """Sensor 1's (J^T W J, J^T W r, mean |r|) against its leave-one-out
    volume with observer weights and the half-band mask floor, at the zero
    pose and at a moved one."""
    jv, jo, pv, po = loo
    bmin, bsize, center = _common(rig)
    params = np.zeros(6, np.float32)
    if pose == "moved":
        params[:] = [0.01, -0.02, 0.005, -0.02, 0.003, 0.004]
    pts, w = jax_ba._surface_points(rig["calib"], rig["maps"], 1, 2)
    want = jax_ba._normal_equations(
        jnp.asarray(params), pts, w, jv[1], jnp.asarray(bmin),
        jnp.asarray(bsize), LIMIT, jnp.asarray(center), -LIMIT * 0.999,
        observers=jo[1], min_observers=2.0)
    ppts, pw = port_ba._surface_points(rig["pcalib"], rig["pmaps"], 1, 2)
    np.testing.assert_allclose(_np(ppts), np.asarray(pts), rtol=0,
                               atol=1e-6)
    got = port_ba._normal_equations(
        _t(params), ppts, pw, pv[1], _t(bmin), _t(bsize), LIMIT,
        _t(center), -LIMIT * 0.999, observers=po[1], min_observers=2.0)
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=0,
                               atol=1e-6)


def _accepts(history):
    """Per iteration and sensor (all but the last iteration): whether the
    step was taken. A rejected step leaves the pose, and so the next
    iteration's mean |r|, exactly as it was."""
    h = _np(history)
    return h[1:] != h[:-1]


@pytest.mark.parametrize("iters", [1, 6])
def test_refine_poses_match(rig, loo, iters):
    """refine_poses against the leave-one-out volumes with observers: one
    iteration (one lm_update per sensor, its accept test) and six; the
    per-iteration mean |r| to 1e-6, the same accept/reject sequence, the
    poses to POSE_ATOL."""
    jv, jo, pv, po = loo
    kw = dict(iters=iters, mask_floor=-LIMIT * 0.999, min_observers=2.0)
    jp, jh = jax_ba.refine_poses(rig["calib"], rig["maps"], None, LIMIT,
                                 volumes=jv, observers=jo, **kw)
    pp, ph = port_ba.refine_poses(rig["pcalib"], rig["pmaps"], None, LIMIT,
                                  volumes=pv, observers=po, **kw)
    assert ph.shape == (iters, 4)
    np.testing.assert_allclose(_np(ph), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_accepts(ph), _accepts(jh))
    assert float(np.abs(np.asarray(jp)[1, 3:]).max()) > 0.002
    np.testing.assert_allclose(_np(pp), np.asarray(jp), rtol=0,
                               atol=POSE_ATOL)


def test_refine_poses_mesh_is_not_ported(rig, loo):
    """refine_poses(mesh=...) runs: over 7 CPU shards (each sensor's 480
    points padded with zero-weight points to 483), against the leave-one-out
    volumes with their observer counts, 2 LM iterations give the
    single-device poses bit for bit (the shards' sums add in f64 and the
    gradient trim takes the whole point set's mean)."""
    from rgbd_recon_tpu_torch.dist import make_mesh

    _, _, pv, po = loo
    kw = dict(iters=2, volumes=pv, observers=po, mask_floor=-LIMIT * 0.999)
    single, _ = port_ba.refine_poses(rig["pcalib"], rig["pmaps"], None,
                                     LIMIT, **kw)
    mesh, hist = port_ba.refine_poses(rig["pcalib"], rig["pmaps"], None,
                                      LIMIT, mesh=make_mesh(7, device="cpu"),
                                      **kw)
    assert tuple(hist.shape) == (2, 4)
    assert float(single.abs().max()) > 1e-3
    assert torch.equal(mesh, single)


# ---- residual stats, applying corrections -----------------------------------

@pytest.mark.parametrize("observers", [False, True])
def test_pose_residual_stats_match(rig, loo, observers):
    """Saturation-aware mean |TSDF| per sensor at a moved pose, against
    the leave-one-out volumes, with and without the observer mask."""
    jv, jo, pv, po = loo
    poses = np.zeros((4, 6), np.float32)
    poses[1] = [0.0, 0.01, 0.0, -0.03, 0.0, 0.005]
    want = jax_ba.pose_residual_stats(
        rig["calib"], rig["maps"], None, LIMIT, poses=jnp.asarray(poses),
        volumes=jv, observers=jo if observers else None)
    got = port_ba.pose_residual_stats(
        rig["pcalib"], rig["pmaps"], None, LIMIT, poses=_t(poses),
        volumes=pv, observers=po if observers else None)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_apply_pose_corrections_match(rig):
    """cv_xyz and the camera positions transformed, cv_xyz_inv resampled,
    cv_uv and the rest carried, on the calibration's device."""
    poses = np.zeros((4, 6), np.float32)
    poses[1] = [0.0, 0.02, -0.01, -0.04, 0.01, 0.0]
    poses[3] = [0.005, 0.0, 0.0, 0.0, 0.0, 0.02]
    want = jax_ba.apply_pose_corrections(rig["calib"], jnp.asarray(poses))
    got = port_ba.apply_pose_corrections(rig["pcalib"], _t(poses))
    for f in ("cv_xyz", "camera_positions", "cv_xyz_inv", "cv_uv",
              "depth_limits", "bbox_min", "bbox_max"):
        np.testing.assert_allclose(
            _np(getattr(got, f)), np.asarray(getattr(want, f)), rtol=0,
            atol=WARP_ATOL if f == "cv_xyz_inv" else 2e-6, err_msg=f)
    assert got.device == rig["pcalib"].device


# ---- the pipeline's refinement loop -------------------------------------------

def test_refine_sensor_poses_estimate_matches(rig):
    """apply=False over the default band schedule's last round: the same
    worst sensor (the only nonzero row) and poses to POSE_ATOL; the
    calibration is left alone."""
    jp, jh = rig["jpipe"].refine_sensor_poses(rig["maps"], rig["counts"],
                                              iters=6, apply=False)
    ppipe = PortPipeline(rig["pcalib"], PortConfig(**CFG), PBBOX)
    pp, ph = ppipe.refine_sensor_poses(rig["pmaps"], rig["pcounts"],
                                       iters=6, apply=False)
    nz_j = np.flatnonzero(np.abs(np.asarray(jp)).sum(1))
    nz_p = np.flatnonzero(np.abs(_np(pp)).sum(1))
    assert list(nz_p) == list(nz_j) == [ppipe.refine_report[0]["worst"]]
    np.testing.assert_array_equal(_accepts(ph), _accepts(jh))
    np.testing.assert_allclose(_np(pp), np.asarray(jp), rtol=0,
                               atol=POSE_ATOL)
    assert ppipe.calib is rig["pcalib"]


def test_refine_sensor_poses_apply_matches(rig):
    """apply=True, two rounds with a re-fuse between them, each pipeline
    from its own fuse of the same frames: the same sensor applied in each
    round, and the final calibrations to 1e-4 (a re-fuse compounds the two
    packages' ulp differences of the maps)."""
    jpipe = TsdfPipeline(rig["calib"], PipelineConfig(**CFG), BBOX)
    _, jmaps, jcounts = jpipe.fuse(rig["frames"])
    ppipe = PortPipeline(rig["pcalib"], PortConfig(**CFG), PBBOX)
    _, pmaps, pcounts = ppipe.fuse(rig["pframes"])
    jpipe.refine_sensor_poses(jmaps, jcounts, iters=6, rounds=2,
                              frames=rig["frames"])
    ppipe.refine_sensor_poses(pmaps, pcounts, iters=6, rounds=2,
                              frames=rig["pframes"])
    applied = [r["applied"] for r in ppipe.refine_report]
    assert applied[0] is not None, ppipe.refine_report
    moved = np.abs(np.asarray(jpipe.calib.cv_xyz)
                   - np.asarray(rig["calib"].cv_xyz)).max(axis=(1, 2, 3, 4))
    # the JAX package applied the same sensors: only they moved
    assert sorted(set(a for a in applied if a is not None)) == list(
        np.flatnonzero(moved > 0))
    for f in ("cv_xyz", "camera_positions", "cv_xyz_inv"):
        np.testing.assert_allclose(_np(getattr(ppipe.calib, f)),
                                   np.asarray(getattr(jpipe.calib, f)),
                                   rtol=0, atol=1e-4, err_msg=f)


# ---- tests/test_refine.py's recovery tests, on the port alone ----------------

def _port_rig(**kw):
    return port_synthetic.default_test_rig(
        num_sensors=4, depth_size=(48, 40), color_size=(64, 48), bbox=PBBOX,
        **kw)


def test_port_recovers_perturbed_pose():
    """Sensor 1 calibrated 4 cm off in x: the leave-one-out refinement
    lowers its residual by 10% and corrects it by more than 5 mm, in -x."""
    rig = _port_rig()
    bad = _offset_rig((PortSensor, PortRig), rig,
                      np.array([0.04, 0.0, 0.0], np.float32))
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]),
        rig, device="cpu")
    calib = port_calibration(bad, PBBOX, cv_res=(16, 24, 16),
                             inv_res=(40, 44, 40), device="cpu")
    pipe = PortPipeline(calib, PortConfig(**CFG), PBBOX)
    volume, maps, counts = pipe.fuse(frames)
    vols = port_ba.leave_one_out_volumes(pipe, maps, counts)
    before = _np(port_ba.pose_residual_stats(calib, maps, volume, LIMIT,
                                             volumes=vols))
    poses, _ = port_ba.refine_poses(calib, maps, volume, LIMIT, iters=6,
                                    volumes=vols)
    after = _np(port_ba.pose_residual_stats(calib, maps, volume, LIMIT,
                                            poses, volumes=vols))
    assert after[1] < before[1] * 0.9, (before, after)
    t = _np(poses[1, 3:])
    assert np.linalg.norm(t) > 0.005
    assert t[0] < 0.0


def test_port_recovers_rotation_and_translation_and_applies():
    """2 degrees about y plus (3, 0, 1) cm on sensor 1, three spheres, 2.5
    cm voxels: the refinement reaches the residual floor of the true
    correction, and applying it and re-fusing lowers sensor 1's residual
    and keeps every sensor inside the band."""
    rig = _port_rig()
    th = np.radians(2.0)
    E_rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]], np.float32)
    E_t = np.array([0.03, 0.0, 0.01], np.float32)
    s1 = rig.sensors[1]
    bad_depth = dataclasses.replace(
        s1.depth,
        r_cw=tuple(map(tuple, (E_rot @ np.asarray(s1.depth.R)).tolist())),
        t_cw=tuple((E_rot @ np.asarray(s1.depth.t_cw) + E_t).tolist()))
    bad = PortRig(sensors=(
        rig.sensors[0],
        PortSensor(depth=bad_depth, color=s1.color, serial=s1.serial),
        rig.sensors[2], rig.sensors[3]))
    scene = port_synthetic.SyntheticScene(
        spheres=[((0.0, 1.25, 0.0), 0.45), ((0.45, 0.55, 0.25), 0.28),
                 ((-0.5, 0.75, -0.2), 0.22)])
    frames = port_synthetic.render_rig_frames(scene, rig, device="cpu")
    calib = port_calibration(bad, PBBOX, cv_res=(16, 24, 16),
                             inv_res=(48, 52, 48), device="cpu")
    cfg = PortConfig(voxel_size=0.025, brick_size=0.125, tsdf_limit=0.02,
                     bricking=False, bilateral=False, morph=False,
                     refine=False)
    pipe = PortPipeline(calib, cfg, PBBOX)
    volume, maps, counts = pipe.fuse(frames)
    vols = port_ba.leave_one_out_volumes(pipe, maps, counts)
    before = _np(port_ba.pose_residual_stats(calib, maps, volume, 0.02,
                                             volumes=vols))
    # the true correction about the bbox center c: t = E_rot^T (c - E_t) - c
    c = (np.asarray(PBBOX.min) + np.asarray(PBBOX.max)) * 0.5
    truth = np.zeros((4, 6), np.float32)
    truth[1, 1] = -th
    truth[1, 3:] = E_rot.T @ (c - E_t) - c
    res_truth = _np(port_ba.pose_residual_stats(
        calib, maps, volume, 0.02, poses=_t(truth), volumes=vols))
    poses, _ = pipe.refine_sensor_poses(maps, counts, iters=10, apply=False)
    res_gn = _np(port_ba.pose_residual_stats(calib, maps, volume, 0.02,
                                             poses=poses, volumes=vols))
    assert res_gn[1] < before[1] * 0.9, (before, res_gn)
    assert res_gn[1] < res_truth[1] * 1.05, (res_truth, res_gn)

    pipe.update_calibration(port_ba.apply_pose_corrections(pipe.calib, poses))
    volume2, maps2, counts2 = pipe.fuse(frames)
    vols2 = port_ba.leave_one_out_volumes(pipe, maps2, counts2)
    after = _np(port_ba.pose_residual_stats(pipe.calib, maps2, volume2, 0.02,
                                            volumes=vols2))
    assert after[1] < before[1], (before, after)
    assert (after < 0.02).all()
