"""The rest of the port's multi-device tests (see tests/test_torch_dist.py
for the setup and the tolerances): tests/test_dist.py's sensor-sharded
preprocess against the JAX package's, then the port's own cases: a surface
at the z faces, where the sharded step is bit-equal to the single device
(and the JAX package's halo field is not), and a dense step whose slabs
are padded."""

import dataclasses

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
from rgbd_recon_tpu.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert, dist
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.dist.mesh import _bake_slabs
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.recon import TsdfPipeline as PortPipeline

from test_torch_dist import BOX, CAM, CFG, CPU8, SPHERE, _np, _setup
from test_torch_parity import jax_arrays

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

# z faces at +-0.45 m cut the sphere: positive voxels 2 rows from each face
FACE_BOX = dict(min=(-1.0, 0.0, -0.45), max=(1.0, 2.2, 0.45))


@pytest.fixture(scope="module")
def eight_sensors():
    box = BoundingBox(**BOX)
    rig = default_test_rig(num_sensors=8, depth_size=(32, 24),
                           color_size=(40, 32), bbox=box)
    calib = build_synthetic_calibration(rig, box, cv_res=(12, 16, 12),
                                        inv_res=(16, 18, 16))
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    kw = dict(voxel_size=0.125, brick_size=0.25, tsdf_limit=0.04)
    jpipe = TsdfPipeline(calib, PipelineConfig(**kw), box)
    want = jax_dist.shard_preprocess(jpipe, jax_dist.make_mesh(8))(frames)
    ppipe = PortPipeline(
        convert.calibration_from_numpy(jax_arrays(calib), device="cpu"),
        PortConfig(**kw), PortBox(**BOX))
    pframes = convert.frames_from_numpy(jax_arrays(frames), device="cpu")
    return want, ppipe, pframes


MAP_TOLS = (("depth", 1e-6), ("quality", 1e-6), ("silhouette", 1e-6),
            ("normal", 1e-5), ("lab", 2e-4))


@pytest.mark.parametrize("shards", [8, 4, 2])
def test_sensor_sharded_preprocess_matches(eight_sensors, shards):
    """8 sensors over 8, 4 and 2 shards: the brick counts equal to the JAX
    package's sensor-sharded counts and to the port's replicated chain,
    the maps within tests/test_dist.py's tolerances of both."""
    (jmaps, jcounts), ppipe, pframes = eight_sensors
    maps, counts = dist.shard_preprocess(
        ppipe, dist.make_mesh(shards, **CPU8))(pframes)
    ref_maps, ref_counts = ppipe.preprocess(pframes)
    np.testing.assert_array_equal(_np(counts), _np(jcounts))
    assert torch.equal(counts, ref_counts)
    for name, atol in MAP_TOLS:
        for want in (getattr(jmaps, name), getattr(ref_maps, name)):
            np.testing.assert_allclose(_np(getattr(maps, name)), _np(want),
                                       rtol=1e-4, atol=atol, err_msg=name)
    assert torch.equal(maps.color, ref_maps.color)


@pytest.fixture(scope="module")
def face():
    """The sphere cut by the z faces at +-0.45 m: both pipelines fused
    once (the JAX package's with the JAX render's bake parts)."""
    jpipe, frames, ppipe, pframes = _setup(FACE_BOX, **CFG)
    vol, _, _ = jpipe.fuse(frames)
    return jpipe, vol, ppipe, pframes


@pytest.mark.parametrize("rounds", [3, 4, 6, 16])
@pytest.mark.parametrize("shards", [8, 3])
def test_surface_at_z_face_bit_equal(face, rounds, shards):
    """Positive voxels 2 rows from each z face: the sharded step's volume,
    march table, surface bricks, clearance, hits and depth are bit-equal to
    the single device's, over 8 shards (Bz = 4: four slabs of padding) and
    3 (Bz_pad = 6), with the kernel bake's one-brick halo (K <= 4), the
    plain bake's K-row halo (K = 6) and its gathered field (K = 16 >= the
    8-row slab)."""
    _, _, ppipe0, pframes = face
    ppipe = PortPipeline(ppipe0.calib, dataclasses.replace(
        ppipe0.config, skip_fine_rounds=rounds), ppipe0.bbox)
    cam = PortCamera(**CAM)
    vol, maps, counts = ppipe.fuse(pframes)
    pos_rows = (vol > 0).sum(dim=(1, 2))
    assert int(pos_rows[:3].sum()) > 0 and int(pos_rows[-3:].sum()) > 0
    ref = ppipe.make_renderer(cam)(vol, maps, counts)
    step = dist.shard_compact_step(ppipe, cam, dist.make_mesh(shards, **CPU8))
    vol_sh, out = step(pframes)
    assert torch.equal(vol_sh.gather(), vol)
    for field in ("hit", "depth", "color"):
        assert torch.equal(getattr(out, field), getattr(ref, field)), field
    render, _ = ppipe.make_render_fn(cam)
    want = render.bake(vol, counts)
    got = _bake_slabs(render, vol_sh.slabs, vol_sh.shape, ppipe.brick_vox,
                      ppipe._limit, torch.device("cpu"))
    for name, g, w in zip(("table", "oct", "occ", "bsafe"), got, want):
        if name == "oct":
            # Z = 15 is no whole number of bricks: no oct table
            assert g is None and w is None
        else:
            assert torch.equal(g, w), name


def test_jax_halo_fine_field_differs_at_a_face(face):
    """The recorded fault of the reference (ROADMAP.md §3): on the face
    scene at 8 shards the JAX sharded bake's fine clearance, computed on
    its halo (its ghosts beyond the faces are the shard's first rows),
    differs from its single-device field near the faces; the port's slab
    field is the single-device one (test_surface_at_z_face_bit_equal)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    jpipe, vol, _, _ = face
    K = jpipe.config.skip_fine_rounds
    v = jpipe.brick_vox
    Z = vol.shape[0]
    Zp = -(-(-(-Z // v)) // 8) * 8 * v
    render, _ = jpipe.make_render_fn(ViewCamera(**CAM))
    pos = jnp.pad(vol > 0.0, ((0, Zp - Z), (0, 0), (0, 0)))
    mesh = jax_dist.make_mesh(8)
    ext = jax_dist.halo_exchange_z(pos, mesh, halo=K)
    sharded = shard_map(lambda e: render.fine_safe_field(e)[K:-K],
                        mesh=mesh, in_specs=(P("z"),), out_specs=P("z"),
                        check_rep=False)(ext)
    single = render.fine_safe_field(pos)
    diff_rows = np.nonzero(np.any(np.asarray(sharded) != np.asarray(single),
                                  axis=(1, 2)))[0]
    assert diff_rows.size > 0 and diff_rows.min() < K


def test_dense_step_pads_the_slabs():
    """A non-compact grid (7 cm voxels in 25 cm bricks, Z = 29) over 3 and
    8 shards (Z padded to 30 and 32): bit-equal to the port's single
    device; held against the JAX package's dense sharded step at the
    slice tolerances (its jitted dense integrate contracts multiply-adds,
    tests/test_torch_refine.py)."""
    kw = dict(CFG, voxel_size=0.07)
    jpipe, frames, ppipe, pframes = _setup(BOX, **kw)
    assert not ppipe.compact and ppipe.volume_grid.shape[0] == 29
    cam = PortCamera(**CAM)
    vol, maps, counts = ppipe.fuse(pframes)
    ref = ppipe.make_renderer(cam)(vol, maps, counts)
    for shards in (3, 8):
        vol_sh, out = dist.shard_pipeline_step(
            ppipe, cam, dist.make_mesh(shards, **CPU8))(pframes)
        assert [tuple(s.shape)[0] for s in vol_sh.slabs] == [
            -(-29 // shards)] * shards
        assert torch.equal(vol_sh.gather(), vol)
        for field in ("hit", "depth", "color"):
            assert torch.equal(getattr(out, field), getattr(ref, field))
    jvol, jout = jax_dist.shard_pipeline_step(
        jpipe, ViewCamera(**CAM), jax_dist.make_mesh(8))(frames)
    np.testing.assert_allclose(_np(vol), _np(jvol), rtol=1e-4, atol=1e-5)
    assert (_np(out.hit) != _np(jout.hit)).sum() <= 0.005 * out.hit.numel()
