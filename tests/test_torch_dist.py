"""The port's multi-device layer (rgbd_recon_tpu_torch/dist and the mesh
form of refine_poses) on 8 CPU shards, against the JAX package on the
8-device CPU mesh of tests/conftest.py and against the port's own single
device: tests/test_dist.py's five tests (the sensor-sharded preprocess is
in tests/test_torch_dist_cases.py, with the port's own cases: a surface at
the z faces, padding with the dense step), then the halo's faces, the
collectives and the mesh.

Scene: tests/test_dist.py's small setup (2 sensors at 48x40, 6.25 cm
voxels in 25 cm bricks, bilinear integrate taps, skip_fine_rounds=3 so the
JAX bake takes its halo path at 8 shards, a 48x32 camera); the JAX state
crosses to the port as numpy.

Tolerances:
- halo exchange at halo = 1: bit-equal to the JAX package's;
- sharded step against the JAX sharded step: volume rtol 1e-5 / atol 1e-6,
  colour rtol 1e-4 / atol 1e-5, hit masks equal (tests/test_dist.py's);
  against the port's single device: volume, hit and depth bit-equal, and
  the colour too (the TSDF path has no atomics);
- poses from the psum'd normal equations: atol 3e-4 against the JAX
  package's mesh form (tests/test_dist.py: the shards' f32 sums
  reassociate, and near-degenerate eigenvectors of J^T W J amplify that);
  bit-equal to the port's single device (its sums add in f64);
- sensor-sharded preprocess: counts equal, maps at tests/test_dist.py's
  tolerances (depth, quality, silhouette 1e-6, normal 1e-5, lab 2e-4,
  rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_recon_tpu.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu.core.config import PipelineConfig
from rgbd_recon_tpu.core.grid import BoundingBox
from rgbd_recon_tpu import dist as jax_dist
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.refine import pose_ba as jax_ba
from rgbd_recon_tpu.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert, dist
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.dist import collectives
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.recon import TsdfPipeline as PortPipeline
from rgbd_recon_tpu_torch.refine import pose_ba as port_ba

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
CFG = dict(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02,
           integrate_taps="bilinear", skip_fine_rounds=3, num_lods=4)
CAM = dict(width=48, height=32, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0))
CPU8 = dict(device="cpu")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _setup(box, num_sensors=2, sizes=((48, 40), (64, 48)),
           cv_res=(16, 24, 16), inv_res=(32, 36, 32), **cfg):
    """Both packages' pipelines (the port's on the JAX calibration) and
    frames of one scene."""
    bbox = BoundingBox(**box)
    rig = default_test_rig(num_sensors=num_sensors, depth_size=sizes[0],
                           color_size=sizes[1], bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=cv_res,
                                        inv_res=inv_res)
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    jpipe = TsdfPipeline(calib, PipelineConfig(**cfg), bbox)
    ppipe = PortPipeline(
        convert.calibration_from_numpy(jax_arrays(calib), device="cpu"),
        PortConfig(**cfg), PortBox(**box))
    pframes = convert.frames_from_numpy(jax_arrays(frames), device="cpu")
    return jpipe, frames, ppipe, pframes


@pytest.fixture(scope="module")
def small():
    """tests/test_dist.py's small setup: both packages' single-device fuse
    + render and 8-shard steps, each computed once."""
    jpipe, frames, ppipe, pframes = _setup(BOX, **CFG)
    vol, maps, counts = jpipe.fuse(frames)
    jout = jpipe.make_renderer(ViewCamera(**CAM))(vol, maps, counts)
    jvol_sh, jout_sh = jax_dist.shard_pipeline_step(
        jpipe, ViewCamera(**CAM), jax_dist.make_mesh(8))(frames)
    pvol, pmaps, pcounts = ppipe.fuse(pframes)
    pout = ppipe.make_renderer(PortCamera(**CAM))(pvol, pmaps, pcounts)
    step = dist.shard_pipeline_step(ppipe, PortCamera(**CAM),
                                    dist.make_mesh(8, **CPU8))
    pvol_sh, pout_sh = step(pframes)
    return dict(jpipe=jpipe, frames=frames, vol=vol, maps=maps, jout=jout,
                jvol_sh=jvol_sh, jout_sh=jout_sh, ppipe=ppipe,
                pframes=pframes, pvol=pvol, pmaps=pmaps, pcounts=pcounts,
                pout=pout, pvol_sh=pvol_sh, pout_sh=pout_sh, step=step)


# ---- tests/test_dist.py's tests ---------------------------------------------

def _slabs(x, n):
    return tuple(torch.chunk(torch.from_numpy(np.asarray(x)), n))


def test_halo_exchange_z_matches_jax():
    """halo = 1 over 4 shards: the port's extended slabs are the JAX
    package's, bit for bit; the crop inverts."""
    vol = np.arange(16 * 2 * 2, dtype=np.float32).reshape(16, 2, 2)
    want = np.asarray(jax_dist.halo_exchange_z(
        jnp.asarray(vol), jax_dist.make_mesh(4), halo=1))
    ext = dist.halo_exchange_z(_slabs(vol, 4), halo=1)
    assert [tuple(e.shape) for e in ext] == [(6, 2, 2)] * 4
    np.testing.assert_array_equal(torch.cat(ext).numpy(), want)
    np.testing.assert_array_equal(
        torch.cat(dist.crop_halo_z(ext, halo=1)).numpy(), vol)


def test_sharded_step_matches_jax_and_single_device(small):
    s = small
    vol_sh = s["pvol_sh"].gather()
    np.testing.assert_allclose(_np(vol_sh), _np(s["jvol_sh"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(s["pout_sh"].color),
                               _np(s["jout_sh"].color), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(s["pout_sh"].hit),
                                  _np(s["jout_sh"].hit))
    assert int(s["pout"].hit.sum()) > 20
    # the port's sharded step is its single-device step, bit for bit
    assert torch.equal(vol_sh, s["pvol"])
    for field in ("hit", "depth", "color", "num_samples", "overflow"):
        assert torch.equal(getattr(s["pout_sh"], field),
                           getattr(s["pout"], field)), field


def test_sharded_volume_actually_sharded(small):
    """Eight brick z-slabs of whole bricks, in z order, gathering to the
    (Z, Y, X) volume; each shard reports its bricks."""
    vol_sh = small["pvol_sh"]
    Z, Y, X = small["ppipe"].volume_grid.shape
    v = small["ppipe"].brick_vox
    assert len(vol_sh.slabs) == 8
    Bz = -(-Z // v)
    for slab in vol_sh.slabs:
        assert tuple(slab.shape) == (-(-Bz // 8) * v, Y, X)
    assert tuple(vol_sh.gather().shape) == (Z, Y, X)
    diag = small["step"].diagnostics()
    assert len(diag) == 8
    assert sum(d["occupied_bricks"] for d in diag) == int(
        (small["pcounts"] > small["ppipe"].config.min_voxels_per_brick).sum())
    assert all(d["bricks_dropped"] == 0 for d in diag)


def test_refine_poses_psum_matches(small):
    """The psum'd normal equations over 8 shards give the single-device
    corrections bit for bit, and the JAX package's mesh form's."""
    s = small
    limit = s["ppipe"].config.tsdf_limit
    want, _ = jax_ba.refine_poses(s["jpipe"].calib, s["maps"], s["vol"],
                                  limit, iters=2, mesh=jax_dist.make_mesh(8))
    single, _ = port_ba.refine_poses(s["ppipe"].calib, s["pmaps"], s["pvol"],
                                     limit, iters=2)
    mesh, hist = port_ba.refine_poses(
        s["ppipe"].calib, s["pmaps"], s["pvol"], limit, iters=2,
        mesh=dist.make_mesh(8, **CPU8))
    assert tuple(hist.shape) == (2, 2)
    assert float(single.abs().max()) > 1e-3
    assert torch.equal(mesh, single)
    np.testing.assert_allclose(_np(mesh), _np(want), atol=3e-4)


# ---- the port's own cases ---------------------------------------------------

def test_halo_faces_repeat_the_edge_slab():
    """halo > 1: beyond the global faces the ghosts repeat the edge row
    (the JAX package's docstring), or hold ``fill``. The JAX body fills
    them with the shard's first / last ``halo`` rows instead (ROADMAP.md
    §3); the two agree only at halo = 1."""
    vol = np.arange(16, dtype=np.float32)
    ext = dist.halo_exchange_z(_slabs(vol, 4), halo=3)
    assert ext[0].tolist() == [0, 0, 0, 0, 1, 2, 3, 4, 5, 6]
    assert ext[1].tolist() == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    assert ext[3].tolist() == [9, 10, 11, 12, 13, 14, 15, 15, 15, 15]
    filled = dist.halo_exchange_z(_slabs(vol, 4), halo=3, fill=-1.0)
    assert filled[0][:3].tolist() == [-1.0] * 3
    assert filled[3][-3:].tolist() == [-1.0] * 3
    assert torch.equal(filled[2], ext[2])
    jax_ext = np.asarray(jax_dist.halo_exchange_z(
        jnp.asarray(vol), jax_dist.make_mesh(4), halo=3)).reshape(4, 10)
    assert jax_ext[0].tolist() == [0, 1, 2, 0, 1, 2, 3, 4, 5, 6]
    with pytest.raises(ValueError, match="halo"):
        dist.halo_exchange_z(_slabs(vol, 4), halo=5)


def test_collectives_count_bytes():
    """On one device a collective copies nothing; the bytes it hands from
    one shard to another count all the same (shards 1-3 of 4, 12 bytes
    each, in the gather and the sum; a halo of one row crosses each of the
    3 interior faces both ways). The psum adds in shard order."""
    collectives.reset_bytes()
    cpu = torch.device("cpu")
    parts = [torch.full((3,), float(i)) for i in range(4)]
    assert collectives.psum(parts, cpu).tolist() == [6.0] * 3
    assert collectives.all_gather(parts, cpu).shape == (12,)
    dist.halo_exchange_z([p.reshape(3, 1) for p in parts], halo=1)
    moved = collectives.bytes_moved()
    assert moved["between_devices"] == dict.fromkeys(collectives.BYTES, 0)
    assert moved["between_shards"] == dict(all_gather=36, psum=36, halo=24,
                                           broadcast=0, scatter=0)


def test_make_mesh_places_shards(small):
    """Shards on the devices asked for; by default the CUDA devices, and
    without one a RuntimeError rather than CPU shards; the pipeline must
    live on the mesh's first device."""
    mesh = dist.make_mesh(3, **CPU8)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_name == "z" and mesh.size == 3
    assert dist.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        dist.make_mesh(3, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.make_mesh()
    with pytest.raises(ValueError, match="first device"):
        dist.shard_compact_step(small["ppipe"], PortCamera(**CAM),
                                dist.make_mesh(2, device="meta"))
