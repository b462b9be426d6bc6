"""The fuse's brick marking and brick-compact integration as the port runs
them (ops/bricks.py mark_pixels, ops/tsdf.py integrate_compact; on the
card one csrc/fuse.cu launch each) against the JAX package, on the CPU,
where the dispatch runs the plain versions:

- the marking of the verify scene's fused maps (4 sensors at 64x56) at
  strides 1 and 3, through the pixel models and through the calibration
  volumes, against the JAX pipeline's _mark_bricks on the same maps, and
  on tests/fuse_cases.py's seeded pixels (world points on brick faces,
  points outside the box, 5 cm bricks) against the JAX package's
  mark_bricks: exactly equal counts;
- the integration on fuse_cases' seeded maps and projections against the
  JAX package's occupied_brick_ids + integrate_bricks (nearest and
  bilinear taps; a capacity above and below the occupied bricks; the
  phantom hull; carve thresholds 1.0 and 0.5; a volume of padded bricks;
  the sharded step's z-slab), at tests/test_golden.py's volume tolerance
  (rtol 1e-4), and the plain version bit-equal to the two calls it
  replaces in the pipeline;
- the dispatch on CPU tensors (no launch), and the wrappers' refusals of
  CPU tensors and of bad arguments (no card needed).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import bricks as jax_bricks
from rgbd_recon_tpu.ops import tsdf as jax_tsdf
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.sensors import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from rgbd_recon_tpu_torch import convert, kernels
from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.kernels import fuse as kfuse
from rgbd_recon_tpu_torch.ops import bricks as port_bricks
from rgbd_recon_tpu_torch.ops import tsdf as port_tsdf
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import (
    TsdfPipeline as PortPipeline,
)
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

import fuse_cases
from test_torch_parity import jax_arrays

torch.set_num_threads(2)

BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
SPHERE = [((0.0, 1.1, 0.0), 0.55)]
BASE_CFG = dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=0.02, num_lods=5)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def scene():
    """The JAX pipeline's fused maps and pixel models of the verify scene,
    and the port's pipeline on the same calibration arguments."""
    bbox = BoundingBox(**BOX)
    rig = default_test_rig(num_sensors=4, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(SyntheticScene(spheres=SPHERE), rig)
    pipe = TsdfPipeline(calib, PipelineConfig(**BASE_CFG), bbox)
    _, maps, _ = pipe.fuse(frames)
    pm = pipe._get_pixel_models(frames.depths.shape[1:3])
    pbox = PortBox(**BOX)
    prig = port_synthetic.default_test_rig(num_sensors=4, bbox=pbox)
    pcalib = port_calibration(prig, pbox, cv_res=(24, 32, 24),
                              inv_res=(40, 44, 40), device="cpu")
    ppipe = PortPipeline(pcalib, PortConfig(**BASE_CFG), pbox)
    return dict(
        pipe=pipe, maps=maps, pm=pm, ppipe=ppipe,
        pmaps=convert.sensor_maps_from_numpy(jax_arrays(maps), device="cpu"),
        ppm=convert.pixel_models_from_numpy(jax_arrays(pm), device="cpu"))


def _with_stride(pipe, stride):
    """``pipe`` with its config's mark_stride set (the marking reads
    nothing else that the stride changes)."""
    p = copy.copy(pipe)
    p.config = dataclasses.replace(pipe.config, mark_stride=stride)
    return p


@pytest.mark.parametrize("models", [True, False])
@pytest.mark.parametrize("stride", [1, 3])
def test_mark_pixels_matches_jax_pipeline(scene, stride, models):
    """The pipeline's marking (mark_pixels on CPU tensors) on the JAX
    maps, through the JAX pixel models carried across or through the
    calibration volumes, against the JAX pipeline's _mark_bricks: equal
    counts, and no launch."""
    s = scene
    jpipe = _with_stride(s["pipe"], stride)
    want = jpipe._mark_bricks(jpipe.calib, s["pm"] if models else None,
                              s["maps"])
    ppipe = _with_stride(s["ppipe"], stride)
    kernels.reset_launch_counts()
    got = ppipe._mark_bricks(s["ppm"] if models else None, s["pmaps"])
    assert not any(kernels.launch_counts().values())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))
    assert int((got > 10).sum()) > 20


def _jax_mark(c):
    """The JAX package's marking of a fuse_cases.mark_case: its world
    points (ray_a + ray_b * d from the models, per component as the JAX
    pipeline forms them) through mark_bricks, times stride^2."""
    s = c["stride"]
    d = jnp.asarray(c["depth"][..., 0])[:, s // 2::s, s // 2::s]
    valid = (d > 0.0) & (d < 1.0)
    if c["worlds"] is None:
        ra = jnp.asarray(c["ray_a"])[:, s // 2::s, s // 2::s]
        rb = jnp.asarray(c["ray_b"])[:, s // 2::s, s // 2::s]
        worlds = jnp.stack([ra[..., j] + rb[..., j] * d for j in range(3)],
                           axis=-1)
    else:
        worlds = jnp.asarray(c["worlds"])
    counts = jax_bricks.mark_bricks(worlds, valid, jnp.asarray(c["bbox_min"]),
                                    c["brick_size"], c["brick_res"])
    return counts * (s * s)


def _port_mark_args(c):
    t = {k: (torch.from_numpy(c[k]) if c[k] is not None else None)
         for k in ("ray_a", "ray_b", "worlds", "bbox_min")}
    # the normalized depth as the pipeline passes it: channel 0 of the
    # (N, H, W, 2) map, a strided view
    depth = torch.from_numpy(c["depth"])[..., 0]
    return (depth, t["bbox_min"], c["brick_size"], c["brick_res"],
            c["stride"]), dict(ray_a=t["ray_a"], ray_b=t["ray_b"],
                               worlds=t["worlds"])


@pytest.mark.parametrize("name", sorted(fuse_cases.MARK_CASES))
def test_mark_pixels_cases_match_jax(name):
    """mark_pixels on fuse_cases' seeded pixels (points outside the box,
    on brick faces; 10 and 5 cm bricks; strides 1-3) against the JAX
    package's mark_bricks of the same world points: equal counts."""
    c = fuse_cases.mark_case(name)
    args, kwargs = _port_mark_args(c)
    got = port_bricks.mark_pixels(*args, **kwargs)
    want = _jax_mark(c)
    bx, by, bz = c["brick_res"]
    assert tuple(got.shape) == (bz, by, bx)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("name", sorted(fuse_cases.MARK_CASES))
def test_mark_pixels_plain_is_mark_bricks(name):
    """The plain marking is mark_bricks of the sampled pixels' world
    points (ray_a + ray_b * d a component at a time), times stride^2, bit
    for bit; the dispatch on CPU tensors is the plain version."""
    c = fuse_cases.mark_case(name)
    args, kwargs = _port_mark_args(c)
    depth, bmin, bs, res, s = args
    d = depth[:, s // 2::s, s // 2::s]
    worlds = kwargs["worlds"]
    if worlds is None:
        ra = kwargs["ray_a"][:, s // 2::s, s // 2::s]
        rb = kwargs["ray_b"][:, s // 2::s, s // 2::s]
        worlds = torch.stack([ra[..., j] + rb[..., j] * d for j in range(3)],
                             dim=-1)
    want = port_bricks.mark_bricks(worlds, (d > 0.0) & (d < 1.0), bmin, bs,
                                   res) * (s * s)
    kernels.reset_launch_counts()
    assert torch.equal(port_bricks.mark_pixels_plain(*args, **kwargs), want)
    assert torch.equal(port_bricks.mark_pixels(*args, **kwargs), want)
    assert not any(kernels.launch_counts().values())


def _port_integrate_args(c):
    keys = ("proj_bricks", "counts", "min_voxels", "capacity", "depths",
            "qualities", "silhouettes", "limit", "vol_shape", "brick_vox")
    args = [torch.from_numpy(c[k]) if isinstance(c[k], np.ndarray) else c[k]
            for k in keys]
    return args, dict(carve_sil_threshold=c["carve_sil_threshold"],
                      phantom_hull=c["phantom_hull"], taps=c["taps"])


@pytest.mark.parametrize("name", sorted(fuse_cases.INTEGRATE_CASES))
def test_integrate_compact_matches_jax(name):
    """integrate_compact on CPU tensors against the JAX package's
    occupied_brick_ids + integrate_bricks on the same seeded inputs: the
    volume within rtol 1e-4 (tests/test_golden.py's), no launch."""
    c = fuse_cases.integrate_case(name)
    args, kwargs = _port_integrate_args(c)
    kernels.reset_launch_counts()
    got = port_tsdf.integrate_compact(*args, **kwargs)
    assert not any(kernels.launch_counts().values())
    ids = jax_tsdf.occupied_brick_ids(jnp.asarray(c["counts"]),
                                      c["min_voxels"], c["capacity"])
    want = jax_tsdf.integrate_bricks(
        jnp.asarray(c["proj_bricks"]), ids, jnp.asarray(c["depths"]),
        jnp.asarray(c["qualities"]), jnp.asarray(c["silhouettes"]),
        c["limit"], c["vol_shape"], c["brick_vox"],
        carve_sil_threshold=c["carve_sil_threshold"],
        phantom_hull=c["phantom_hull"], taps=c["taps"])
    assert tuple(got.shape) == tuple(c["vol_shape"])
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6)
    # the case reaches every branch of the fold: voxels in the band,
    # cleared ones, and (capacity below) occupied bricks dropped
    vol = _np(got)
    assert (np.abs(vol) < c["limit"]).sum() > 50
    assert (vol == -c["limit"]).sum() > 50
    if c["capacity"] < c["occupied"]:
        assert c["capacity"] > 0


@pytest.mark.parametrize("name", sorted(fuse_cases.INTEGRATE_CASES))
def test_integrate_compact_plain_is_the_two_calls(name):
    """integrate_compact_plain bit-equal to occupied_brick_ids then
    integrate_bricks (the pipeline's two calls before it)."""
    c = fuse_cases.integrate_case(name, seed=1)
    args, kwargs = _port_integrate_args(c)
    proj, counts, mv, cap, d, q, s, lim, shape, v = args
    ids = port_tsdf.occupied_brick_ids(counts, mv, cap)
    want = port_tsdf.integrate_bricks(proj, ids, d, q, s, lim, shape, v,
                                      **kwargs)
    got = port_tsdf.integrate_compact_plain(*args, **kwargs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_integrate_compact_capacity_drops_the_last_bricks():
    """Below the occupied count the integration keeps the first capacity
    occupied bricks in ascending order and clears the rest, as
    occupied_brick_ids drops them."""
    c = fuse_cases.integrate_case("nearest_capacity_below")
    args, kwargs = _port_integrate_args(c)
    got = _np(port_tsdf.integrate_compact(*args, **kwargs))
    v = c["brick_vox"]
    occ = np.flatnonzero(c["counts"].reshape(-1) > c["min_voxels"])
    Bz, By, Bx = c["counts"].shape
    Z, Y, X = c["vol_shape"]
    pad = np.full((Bz * v, By * v, Bx * v), np.nan, np.float32)
    pad[:Z, :Y, :X] = got
    bricks = pad.reshape(Bz, v, By, v, Bx, v).transpose(0, 2, 4, 1, 3, 5)
    bricks = bricks.reshape(Bz * By * Bx, -1)
    for b in occ[c["capacity"]:]:
        vals = bricks[b][~np.isnan(bricks[b])]
        assert (vals == -c["limit"]).all(), b
    kept = occ[:c["capacity"]]
    assert any((bricks[b] != -c["limit"]).any() for b in kept)


def test_pipeline_integrate_dispatches_integrate_compact(scene, monkeypatch):
    """TsdfPipeline.integrate's brick-compact branch goes through
    integrate_compact (the card's path) with the config's arguments."""
    s = scene
    seen = []
    real = port_tsdf.integrate_compact

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_tsdf, "integrate_compact", spy)
    counts = s["ppipe"]._mark_bricks(s["ppm"], s["pmaps"])
    vol = s["ppipe"].integrate(s["pmaps"], counts)
    assert len(seen) == 1
    cfg = s["ppipe"].config
    args, kwargs = seen[0]
    assert args[2:4] == (cfg.min_voxels_per_brick, cfg.brick_capacity)
    assert kwargs["taps"] == cfg.integrate_taps
    want = port_tsdf.integrate_compact_plain(*args, **kwargs)
    assert torch.equal(vol, want)


@pytest.mark.parametrize("n", range(1, 12))
def test_sampled_size_is_the_slice_length(n):
    for s in range(1, 6):
        assert kfuse.sampled_size(n, s) == torch.zeros(n)[s // 2::s].numel()


@pytest.mark.parametrize("brick_size", [0.1, 0.05, 0.2, 0.25, 0.3, 0.07])
def test_mark_scalars_are_torch_cuda_scalars(brick_size):
    """The kernel's scalars: f32(1) / f32(brick_size) (PyTorch's CUDA x / c
    by a Python c), f32(brick_size) and the f32 of the double product
    brick_size * 0.1 (how a Python product meets an f32 tensor)."""
    inv, bs, border = kfuse.mark_scalars(brick_size)
    assert inv == float(np.float32(1.0) / np.float32(brick_size))
    assert bs == float(np.float32(brick_size))
    assert border == float(np.float32(brick_size * 0.1))
    x = torch.tensor([brick_size * 0.1], dtype=torch.float32)
    assert float(x[0]) == border


def test_fuse_wrappers_refuse_cpu_tensors():
    """On CPU tensors the wrappers raise (the dispatch runs the plain
    versions there) and count no launch."""
    c = fuse_cases.mark_case("stride3_models")
    args, kwargs = _port_mark_args(c)
    ic = fuse_cases.integrate_case("nearest_whole")
    iargs, ikw = _port_integrate_args(ic)
    B = iargs[0].shape[1]
    slot = torch.full((B,), -1, dtype=torch.int32)
    ids = torch.full((iargs[3],), B, dtype=torch.int64)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kfuse.brick_mark_cuda(*args, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        kfuse.brick_integrate_cuda(iargs[0], ids, slot, *iargs[4:], **ikw)
    assert not any(kernels.launch_counts().values())


# each bad argument of the mark wrapper and the words of its refusal
MARK_REFUSALS = {
    "float64": "float32", "both": "not both", "neither": "pixel models",
    "worlds_shape": "worlds must be", "stride0": "stride",
    "ray_shape": "ray_b must be", "bbox": "bbox_min",
}


@pytest.mark.parametrize("bad", sorted(MARK_REFUSALS))
def test_brick_mark_refuses_bad_arguments(bad):
    """The mark wrapper's argument checks, which run before its check of
    the device (so on CPU tensors here), and count no launch."""
    c = fuse_cases.mark_case("stride3_models")
    args, kwargs = _port_mark_args(c)
    depth, bmin, bs, res, s = args
    if bad == "float64":
        depth = depth.double()
    elif bad == "both":
        kwargs["worlds"] = torch.zeros((4, 14, 19, 3))
    elif bad == "neither":
        kwargs["ray_a"] = None
    elif bad == "worlds_shape":
        kwargs = dict(worlds=torch.zeros((4, 13, 19, 3)))
    elif bad == "stride0":
        s = 0
    elif bad == "ray_shape":
        kwargs["ray_b"] = kwargs["ray_b"][:, :-1]
    else:
        bmin = bmin[:2]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=MARK_REFUSALS[bad]):
        kfuse.brick_mark_cuda(depth, bmin, bs, res, s, **kwargs)
    assert not any(kernels.launch_counts().values())


INTEGRATE_REFUSALS = {
    "taps": "taps", "brick_vox": "brick_vox", "vol_shape": "bricks",
    "slot": "slot", "maps": "qualities", "unaligned": "16-byte",
    "layout": "contiguous", "sensor_stride": "whole number",
    "ids": "ids",
}


@pytest.mark.parametrize("bad", sorted(INTEGRATE_REFUSALS))
def test_brick_integrate_refuses_bad_arguments(bad):
    """The integrate wrapper's argument checks, before its check of the
    device."""
    c = fuse_cases.integrate_case("nearest_whole")
    args, kw = _port_integrate_args(c)
    proj, _, _, _, d, q, s, lim, shape, v = args
    slot = torch.full((proj.shape[1],), -1, dtype=torch.int32)
    ids = torch.full((c["capacity"],), proj.shape[1], dtype=torch.int64)
    if bad == "taps":
        kw["taps"] = "trilinear"
    elif bad == "brick_vox":
        v = 3
    elif bad == "vol_shape":
        shape = (shape[0] + 4, shape[1], shape[2])
    elif bad == "slot":
        slot = slot[:-1]
    elif bad == "maps":
        q = q[:, :-1]
    elif bad == "unaligned":
        n = proj.numel()
        proj = torch.zeros(n + 1)[1:].view(proj.shape)
    elif bad == "ids":
        ids = ids.to(torch.int32)
    elif bad == "layout":
        proj = proj.transpose(1, 2)
    else:
        # each sensor's rows 2 floats after the last one's end
        N, B, V, _ = proj.shape
        proj = torch.zeros((N, B * V * 4 + 2))[:, :B * V * 4].view(N, B, V,
                                                                   4)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=INTEGRATE_REFUSALS[bad]):
        kfuse.brick_integrate_cuda(proj, ids, slot, d, q, s, lim, shape, v,
                                   **kw)
    assert not any(kernels.launch_counts().values())


def test_fuse_split_exits_without_a_card(monkeypatch, capsys):
    """bench/fuse_split.py needs the card: exit 1 before any work."""
    from rgbd_recon_tpu_torch.bench import fuse_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fuse_split.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
