"""Fuse parity of the PyTorch port against the JAX package (preprocess ->
brick marking -> brick-compact integration), and kernels 3-4 (the render's
march-volume bake) against the Pallas kernels in interpret mode and against
the jnp form the JAX pipeline runs off-TPU.

Scene: 4 synthetic sensors at 64x56, cv_res (24, 32, 24), inv_res
(40, 44, 40), 5 cm voxels, brick_size=0.2 (so brick_vox=4 divides the
(40, 44, 40) volume and the render takes the port's oct-table branch),
tsdf_limit 0.02, num_lods 5, one sphere of radius 0.55 m."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import bake_pallas
from rgbd_recon_tpu.ops import bricks as jax_bricks
from rgbd_recon_tpu.ops import tsdf as jax_tsdf
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.sensors import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.ops import bake as port_bake
from rgbd_recon_tpu_torch.ops import bricks as port_bricks
from rgbd_recon_tpu_torch.ops import tsdf as port_tsdf
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import (
    TsdfPipeline as PortPipeline,
)
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

from test_torch_parity import jax_arrays

torch.set_num_threads(2)

# each package builds its own box and config from the same arguments
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
CAM = dict(width=96, height=80, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0))
BASE_CFG = dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=0.02, num_lods=5)


def _cfg():
    return PipelineConfig(**BASE_CFG)


def _pcfg():
    return PortConfig(**BASE_CFG)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _bits(x):
    """bf16 array (jax/ml_dtypes or torch) -> uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.fixture(scope="module")
def jax_run():
    rig = default_test_rig(num_sensors=4, bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    pipe = TsdfPipeline(calib, _cfg(), BBOX)
    volume, maps, counts = pipe.fuse(frames)
    render_fn, _ = pipe.make_render_fn(ViewCamera(**CAM))
    baked = render_fn.bake(volume, counts, pipe._limit)
    return dict(pipe=pipe, volume=volume, maps=maps, counts=counts,
                baked=baked)


@pytest.fixture(scope="module")
def port_run():
    rig = port_synthetic.default_test_rig(num_sensors=4, bbox=PBBOX)
    calib = port_calibration(rig, PBBOX, cv_res=(24, 32, 24),
                             inv_res=(40, 44, 40), device="cpu")
    frames = port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=SPHERE), rig, device="cpu")
    pipe = PortPipeline(calib, _pcfg(), PBBOX)
    volume, maps, counts = pipe.fuse(frames)
    return dict(pipe=pipe, volume=volume, maps=maps, counts=counts)


def test_brick_counts_equal(jax_run, port_run):
    """Exact integer histograms (bincount vs the one-hot matmul)."""
    np.testing.assert_array_equal(_np(port_run["counts"]),
                                  _np(jax_run["counts"]))
    assert int((port_run["counts"] > 10).sum()) == 60


def test_volume_matches(jax_run, port_run):
    """tests/test_golden.py's volume tolerance."""
    np.testing.assert_allclose(_np(port_run["volume"]),
                               _np(jax_run["volume"]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("field,atol", [
    ("depth", 1e-5), ("quality", 1e-5), ("silhouette", 1e-6),
])
def test_fused_maps_match(jax_run, port_run, field, atol):
    """Each side fits its own pixel models here; the maps still agree at the
    preprocess tolerances of tests/test_preprocess.py."""
    np.testing.assert_allclose(_np(getattr(port_run["maps"], field)),
                               _np(getattr(jax_run["maps"], field)),
                               rtol=0, atol=atol)


def test_integrate_from_carried_maps(jax_run, port_run):
    """Integration alone: the JAX maps and counts carried across give the
    JAX volume (same fold in f32; rtol 1e-4 as tests/test_golden.py)."""
    maps = convert.sensor_maps_from_numpy(
        jax_arrays(jax_run["maps"]), device="cpu")
    counts = torch.from_numpy(np.array(jax_run["counts"]))
    vol = port_run["pipe"].integrate(maps, counts)
    np.testing.assert_allclose(_np(vol), _np(jax_run["volume"]), rtol=1e-4,
                               atol=1e-6)


def test_mark_bricks_matches():
    """Brick histogram incl. the neighbor rule with its x-only border test:
    exact counts on random world points."""
    rng = np.random.default_rng(5)
    pts = rng.uniform([-1.1, -0.1, -1.1], [1.1, 2.3, 1.1],
                      (3, 40, 50, 3)).astype(np.float32)
    valid = rng.random((3, 40, 50)) < 0.8
    bmin = np.array(BOX["min"], np.float32)
    want = jax_bricks.mark_bricks(jnp.asarray(pts), jnp.asarray(valid),
                                  jnp.asarray(bmin), 0.2, (10, 11, 10))
    got = port_bricks.mark_bricks(torch.from_numpy(pts),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(bmin), 0.2, (10, 11, 10))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_mark_bricks_through_volumes(jax_run, port_run):
    """The pipeline's stride-3 marking with calibration-volume lookups (the
    path taken when the pixel-model fit is off or too coarse) on the JAX
    maps: exact counts."""
    maps_j = jax_run["maps"]
    want = jax_run["pipe"]._mark_bricks(jax_run["pipe"].calib, None, maps_j)
    maps = convert.sensor_maps_from_numpy(jax_arrays(maps_j),
                                          device="cpu")
    got = port_run["pipe"]._mark_bricks(None, maps)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("capacity", [7, 40, 1200])
def test_occupied_brick_ids_match(capacity):
    """First-capacity ascending ids padded with num_bricks (both the
    compaction and the capacity >= num_bricks branch of the reference)."""
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 30, (8, 10, 12)).astype(np.int32)
    want = jax_tsdf.occupied_brick_ids(jnp.asarray(counts), 10, capacity)
    got = port_tsdf.occupied_brick_ids(torch.from_numpy(counts), 10,
                                       capacity)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.fixture(scope="module")
def random_volume():
    """(24, 32, 40) TSDF-like volume with sparse positives, brick_vox=8,
    and a random integer brick clearance scaled by brick_vox."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(-0.02, 0.02, (24, 32, 40)).astype(np.float32)
    vol[rng.random(vol.shape) < 0.97] = -0.02
    bs = (rng.integers(0, 4, (3, 4, 5)) * 8).astype(np.float32)
    return vol, bs


def test_surface_occ_plain_matches_pallas(random_volume):
    """Kernel 3's plain twin against surface_occ_tpu (interpret): exact."""
    vol, _ = random_volume
    want = bake_pallas.surface_occ_tpu(jnp.asarray(vol), 8, interpret=True)
    got = port_bake.surface_occ(torch.from_numpy(vol), 8)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_sentinel_bake_plain_matches_pallas(random_volume):
    """Kernel 4's plain twin against sentinel_bake_tpu (interpret): bit for
    bit in bf16."""
    vol, bs = random_volume
    want = bake_pallas.sentinel_bake_tpu(jnp.asarray(vol), jnp.asarray(bs),
                                         8, 6, interpret=True)
    got = port_bake.sentinel_bake(torch.from_numpy(vol),
                                  torch.from_numpy(bs), 8, 6)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("rounds", [1, 6])
def test_sentinel_bake_f32_matches_pallas(random_volume, rounds):
    """Kernel 4's plain twin with an f32 table against sentinel_bake_tpu
    with out_dtype=float32 (interpret, as the JAX pipeline calls it for
    march_dtype="float32"): bit for bit."""
    vol, bs = random_volume
    want = bake_pallas.sentinel_bake_tpu(jnp.asarray(vol), jnp.asarray(bs),
                                         8, rounds, out_dtype=jnp.float32,
                                         interpret=True)
    got = port_bake.sentinel_bake(torch.from_numpy(vol),
                                  torch.from_numpy(bs), 8, rounds,
                                  torch.float32)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_array_equal(_np(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("part", ["occ", "bsafe", "table", "oct_rows",
                                  "oct_slots"])
def test_bake_matches_jnp_form(jax_run, port_run, part):
    """The port's render bake (surface_occ + brick clearance +
    sentinel_bake + oct table) on the JAX fused volume against the JAX
    pipeline's off-TPU bake (_surface_brick_mask, fine_safe_field +
    sentinel_volume + the bf16 PackedVolume, build_oct_bricks): exact."""
    pipe = port_run["pipe"]
    render_fn, _ = pipe.make_render_fn(PortCamera(**CAM))
    vol = torch.from_numpy(np.array(jax_run["volume"]))
    counts = torch.from_numpy(np.array(jax_run["counts"]))
    table, oct, occ, bsafe = render_fn.bake(vol, counts)
    packed, oct_j, occ_j, bsafe_j, _ = jax_run["baked"]
    if part == "occ":
        np.testing.assert_array_equal(_np(occ), _np(occ_j))
    elif part == "bsafe":
        np.testing.assert_array_equal(_np(bsafe), _np(bsafe_j))
    elif part == "table":
        want = _bits(packed.pairs).reshape(tuple(vol.shape))
        np.testing.assert_array_equal(_bits(table), want)
    elif part == "oct_rows":
        # every capacity row: the padding slots hold the last brick's
        # corners in both tables
        assert oct.rows.shape == tuple(oct_j.rows.shape)
        np.testing.assert_array_equal(_bits(oct.rows), _bits(oct_j.rows))
    else:
        np.testing.assert_array_equal(_np(oct.slots), _np(oct_j.slots)[:, 0])
