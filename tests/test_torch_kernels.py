"""The port's hand-written CUDA kernels against their plain PyTorch twins,
and the CPU dispatch rules of their wrappers.

Imports torch only (no jax), so the CUDA tests run on a GPU machine without
the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a CUDA device the ``cuda`` tests skip; the CPU tests always run.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.bench import kernel_inputs
from rgbd_recon_tpu_torch.ops import bake, holefill, stencil13
from rgbd_recon_tpu_torch.ops.stage_calls import (
    STAGES,
    all_bits_equal,
    bits_equal,
    plain_stages,
    record_stages,
    replay,
)

import bake_chain_cases
import bracket_cases
import fuse_cases
import hit_gather_cases
from hit_cases import record_hits
from holefill_cases import fill_planes
import preprocess_cases
from scan_cases import SCAN_CASES, scan_case
import setup_refine_cases

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _depth_maps(rng, n, h, w):
    """Metric depth with smooth regions, edges, invalid zeros and
    out-of-range values (numpy, from a seed)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = 1.5 + np.sin(xx * 7.0)[None] * 0.6 + (yy > 0.5)[None] * 1.2
    d = base + rng.normal(0, 0.02, (n, h, w))
    d[rng.random((n, h, w)) < 0.05] = 0.0
    d[rng.random((n, h, w)) < 0.01] = 4.8
    return d.astype(np.float32)


# tiny normalized depths of the quality census: below the kernel's 2^-40
# guard (full division), across it (2^-40 x 0.8..1.2), inside it (2^-39),
# the smallest normal and a subnormal
_TINY = (2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 2.0 ** -126, 2.0 ** -140)


def _quality_maps(rng, n, h, w):
    """Normalized depth for the quality census: _depth_maps normalized to
    [0.5, 4.5] (the zeros become negative, 4.8 becomes > 1), exact 0s and
    1s, and one 9 x 9 patch of each _TINY value t, t x (1 +- 20%): centres
    whose neighbours are non-border taps."""
    d = (_depth_maps(rng, n, h, w) - 0.5) / 4.0
    d[rng.random(d.shape) < 0.02] = 0.0
    d[rng.random(d.shape) < 0.02] = 1.0
    ph, pw = min(9, h), min(9, w)
    for i, t in enumerate(_TINY):
        y = rng.integers(0, h - ph + 1)
        x = rng.integers(0, w - pw + 1)
        d[i % n, y: y + ph, x: x + pw] = t * (1.0 + rng.uniform(
            -0.2, 0.2, (ph, pw)))
    return d.astype(np.float32)


def _volume(rng, shape, limit=0.01):
    """TSDF-like volume: a sphere band at +-limit plus sparse noise."""
    Z, Y, X = shape
    z, y, x = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    r = np.sqrt((x - X / 2) ** 2 + (y - Y / 2) ** 2 + (z - Z / 2) ** 2)
    vol = np.clip((min(shape) * 0.3 - r) * limit * 0.5, -limit, limit)
    vol[rng.random(shape) < 1e-4] = limit * 0.5
    return vol.astype(np.float32)


# ---- CPU: dispatch rules --------------------------------------------------

def test_cpu_tensors_take_plain_path_and_count_nothing():
    """On CPU tensors each wrapper runs its plain twin; no launch counter
    moves and no kernel is built."""
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    d = torch.from_numpy(_depth_maps(rng, 2, 20, 24))
    lim = torch.tensor([[0.5, 4.5]] * 2)
    got = stencil13.bilateral13(d, lim)
    want = stencil13.bilateral13_plain(d, lim)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dn = torch.clamp((d - 0.5) / 4.0, -0.1, 1.1)
    got = stencil13.quality13(dn)
    for g, w in zip(got, stencil13.quality13_plain(dn)):
        assert torch.equal(g, w)
    vol = torch.from_numpy(_volume(rng, (16, 24, 20)))
    assert torch.equal(bake.surface_occ(vol, 4), bake.surface_occ_plain(vol, 4))
    bs = torch.from_numpy(rng.integers(0, 3, (4, 6, 5)).astype(np.float32))
    assert torch.equal(bake.sentinel_bake(vol, bs, 4, 3),
                       bake.sentinel_bake_plain(vol, bs, 4, 3))
    got = bake.sentinel_bake(vol, bs, 4, 3, torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, bake.sentinel_bake_plain(vol, bs, 4, 3,
                                                     torch.float32))
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_cpu_pipeline_launches_no_kernel():
    """A whole CPU fuse + render runs every plain twin and no kernel."""
    from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
    from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
    from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
    from rgbd_recon_tpu_torch.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=2, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(20, 22, 20), device="cpu")
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig, device="cpu")
    cfg = PipelineConfig(voxel_size=0.1, brick_size=0.2, tsdf_limit=0.04,
                         num_lods=3)
    kernels.reset_launch_counts()
    pipe = TsdfPipeline(calib, cfg, bbox)
    volume, maps, counts = pipe.fuse(frames)
    out = pipe.make_renderer(ViewCamera(width=32, height=24))(volume, maps,
                                                               counts)
    assert out.color.shape == (24, 32, 3)
    assert bool(torch.isfinite(out.color).all())
    assert all(n == 0 for n in kernels.launch_counts().values())


def _small_scene(device, brick_size=0.4, num_sensors=2, **cfg):
    """A sphere scene of ``num_sensors`` sensors fused on ``device``:
    (pipeline, volume, maps, counts, camera, frames), 10 cm voxels in 40 cm
    bricks (4 voxels) unless ``brick_size`` says otherwise."""
    from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
    from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
    from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
    from rgbd_recon_tpu_torch.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=num_sensors, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(20, 22, 20), device=device)
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig, device=device)
    pipe = TsdfPipeline(calib, PipelineConfig(
        voxel_size=0.1, brick_size=brick_size, tsdf_limit=0.04, num_lods=3,
        **cfg),
        bbox)
    volume, maps, counts = pipe.fuse(frames)
    return pipe, volume, maps, counts, ViewCamera(width=64, height=48), frames


@pytest.mark.parametrize("brick_size,rounds", [(0.4, 4), (0.4, 5),
                                               (0.4, 16), (2.0, 16),
                                               (2.0, 20)])
def test_bake_dispatch_rule(monkeypatch, brick_size, rounds):
    """The render's bake calls the sentinel_bake wrapper exactly when
    skip_fine_rounds <= brick_vox (the JAX package's rule for its Pallas
    bake), the plain bake otherwise, and the surface_occ wrapper always
    (surface_skip). 40 cm bricks hold 4 voxels, 2 m bricks 20. Wrappers
    stubbed to record their calls."""
    calls = {"surface_occ": 0, "sentinel_bake": 0}

    def recording(name, plain):
        def stub(*args, **kw):
            calls[name] += 1
            return plain(*args, **kw)
        return stub

    monkeypatch.setattr(bake, "surface_occ",
                        recording("surface_occ", bake.surface_occ_plain))
    monkeypatch.setattr(bake, "sentinel_bake",
                        recording("sentinel_bake", bake.sentinel_bake_plain))
    pipe, volume, maps, counts, cam, _ = _small_scene(
        "cpu", brick_size=brick_size, skip_fine_rounds=rounds)
    out = pipe.make_renderer(cam)(volume, maps, counts)
    assert int(out.hit.sum()) > 50
    assert calls == {"surface_occ": 1,
                     "sentinel_bake": int(rounds <= pipe.brick_vox)}
    assert bake.uses_kernel_bake(pipe.brick_vox, rounds) == (
        rounds <= round(brick_size / 0.1))


def _slabs(pipe, volume, shards, device):
    """``volume`` as the sharded step holds it over ``shards`` shards on
    ``device``: brick z-slabs of whole bricks, the rows past Z at the clear
    value."""
    v = pipe.brick_vox
    Z = volume.shape[0]
    Zl = -(-(-(-Z // v)) // shards) * v
    pad = torch.full((Zl * shards - Z,) + tuple(volume.shape[1:]),
                     -pipe._limit, device=volume.device)
    return [s.to(device) for s in torch.cat([volume, pad]).split(Zl)]


@pytest.mark.parametrize("rounds", [3, 4, 6, 16])
@pytest.mark.parametrize("shards", [8, 3])
def test_slab_bake_dispatch_rule(monkeypatch, shards, rounds):
    """The sharded step's slab bake (dist/mesh.py _bake_slabs) calls the
    surface_occ wrapper once per shard, and the sentinel_bake wrapper once
    per shard exactly when the render's rule gives the kernel
    (skip_fine_rounds <= brick_vox = 4); its tables equal the
    single-device bake's. Wrappers stubbed to record their calls."""
    from rgbd_recon_tpu_torch.dist.mesh import _bake_slabs

    calls = {"surface_occ": 0, "sentinel_bake": 0}

    def recording(name, plain):
        def stub(*args, **kw):
            calls[name] += 1
            return plain(*args, **kw)
        return stub

    pipe, volume, maps, counts, cam, _ = _small_scene(
        "cpu", skip_fine_rounds=rounds)
    render, _ = pipe.make_render_fn(cam)
    want = render.bake(volume, counts)
    monkeypatch.setattr(bake, "surface_occ",
                        recording("surface_occ", bake.surface_occ_plain))
    monkeypatch.setattr(bake, "sentinel_bake",
                        recording("sentinel_bake", bake.sentinel_bake_plain))
    got = _bake_slabs(render, _slabs(pipe, volume, shards, "cpu"),
                      tuple(volume.shape), pipe.brick_vox, pipe._limit,
                      torch.device("cpu"))
    assert calls == {"surface_occ": shards,
                     "sentinel_bake": shards * int(rounds <= 4)}
    for g, w in zip(got[::2], want[::2]):     # table, surface bricks
        assert torch.equal(g, w)
    assert torch.equal(got[3], want[3])


def _same_bake_part(got, want) -> bool:
    """A bake output equal bit for bit: a tensor, None, or the oct table (a
    dataclass of tensors)."""
    if isinstance(got, torch.Tensor) and isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    if dataclasses.is_dataclass(got) and type(got) is type(want):
        return all(_same_bake_part(getattr(got, f.name),
                                   getattr(want, f.name))
                   for f in dataclasses.fields(got))
    return got == want


@pytest.mark.parametrize("shards", [8, 3])
def test_slab_bake_with_oct_table(shards):
    """In 2-voxel bricks the (20, 22, 20) volume is brick-aligned, so the
    render builds an oct hit table: the slab bake's, from the gathered raw
    volume, equals the single-device bake's field for field, as do its
    march table, surface bricks and clearance."""
    from rgbd_recon_tpu_torch.dist.mesh import _bake_slabs

    pipe, volume, maps, counts, cam, _ = _small_scene(
        "cpu", brick_size=0.2, skip_fine_rounds=2)
    render, _ = pipe.make_render_fn(cam)
    want = render.bake(volume, counts)
    assert want[1] is not None
    got = _bake_slabs(render, _slabs(pipe, volume, shards, "cpu"),
                      tuple(volume.shape), pipe.brick_vox, pipe._limit,
                      torch.device("cpu"))
    for name, g, w in zip(("table", "oct", "occ", "bsafe"), got, want):
        assert _same_bake_part(g, w), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality13_plain_nonpositive_centres(seed):
    """Every centre d <= 0 (-0.0 too) gives (169, +0.0) exactly in the plain
    fold: drm = 0.35 d <= 0 <= range, and range = drm = 0 needs s = d <= 0,
    a border tap. The CUDA kernel writes that result without a tap for a
    thread whose centres are all <= 0."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.5, 1.5, (2, 30, 34)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = 0.0
    d[rng.random(d.shape) < 0.1] = -0.0
    d[0, 5:12, 5:12] = -(2.0 ** -140)
    d[1, 5:12, 5:12] = 2.0 ** -140
    d = torch.from_numpy(d)
    border, wr = stencil13.quality13_plain(d)
    low = d <= 0.0
    assert int(low.sum()) > 400
    assert bool((border[low] == 169.0).all())
    assert bool((wr[low].view(torch.int32) == 0).all())
    assert bool((border[~low] < 169.0).any())


def test_cuda_wrappers_reject_cpu_tensors():
    from rgbd_recon_tpu_torch.kernels.bake import surface_occ_cuda
    from rgbd_recon_tpu_torch.kernels.stencil13 import quality13_cuda

    with pytest.raises(ValueError, match="CUDA"):
        quality13_cuda(torch.zeros(1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        surface_occ_cuda(torch.zeros(8, 8, 8), 4)


def test_hit_wrappers_reject_cpu_tensors():
    """The hit kernels' wrappers take CUDA tensors only, and the normals,
    blends and shade modes the kernel draws: no fallback, nothing
    counted."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda, shade_cuda

    kernels.reset_launch_counts()
    x = torch.zeros(4)
    hit_pos = torch.zeros(4, 3)
    hit = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        refine_cuda((x, x, x), (x, x, x), x, x, hit, hit_pos, 0.01,
                    table=torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="float32"):
        refine_cuda((x, x, x), (x, x, x), x, x, hit, hit_pos.double(), 0.01,
                    table=torch.zeros(4, 4, 4))
    plane = torch.zeros(1, 4, 4)
    shade = dict(hit=hit, hit_pos=hit_pos, color=torch.zeros(1, 4, 4, 3),
                 depth=plane, quality=plane, normal="nearest",
                 blend="volume_fast", shade_mode=0, limit=0.01, eye=x[:3],
                 rot=torch.eye(3), bbox_min=x[:3], bbox_size=(1.0, 1.0, 1.0),
                 near=0.1, far=20.0, table=torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        shade_cuda(**shade)
    with pytest.raises(ValueError, match="shade modes 0-2"):
        shade_cuda(**dict(shade, shade_mode=3))
    with pytest.raises(ValueError, match="blend"):
        shade_cuda(**dict(shade, blend="normal_deviation"))
    assert all(n == 0 for n in kernels.launch_counts().values())


@pytest.mark.parametrize("config", [{}, dict(oct_hit_table=False),
                                    dict(shade_mode=3)])
def test_hits_cpu_dispatch_takes_the_twins(config):
    """On CPU tensors refine_hits and shade_hits are their plain twins,
    bit for bit, and count no launch."""
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene("cpu", **config)
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    kernels.reset_launch_counts()
    args, kwargs = calls["refine"]
    assert torch.equal(hits.refine_hits(*args, **kwargs),
                       hits.refine_hits_plain(*args, **kwargs))
    args, kwargs = calls["shade"]
    for g, w in zip(hits.shade_hits(*args, **kwargs),
                    hits.shade_hits_plain(*args, **kwargs)):
        assert torch.equal(g, w)
    assert all(n == 0 for n in kernels.launch_counts().values())


# the normal, blend and dq taps the shade kernel draws under each of
# HIT_CONFIGS (ops/hits.py shade_kernel_args)
SHADE_CODES = {
    "fast": ("oct", "analytic", False),
    "oct_no_widen": ("oct", "analytic", False),
    "no_oct": ("nearest", "analytic", False),
    "parity": ("trilinear", "volume", True),
    "no_proj": ("oct", "volume_fast", False),
    "bilinear_taps": ("oct", "analytic", True),
    "f32_tables": ("oct", "analytic", False),
    "dense_nearest": ("nearest", "analytic", False),
    "dense_trilinear": ("trilinear", "volume", False),
}


@pytest.mark.parametrize("name", sorted(SHADE_CODES))
def test_shade_kernel_args_resolve_the_config(name):
    """ops.hits.shade_kernel_args turns each config's shade call into the
    kernel's normal, blend and dq taps, its table (the oct table or the
    march table, never both) and the maps' planes, read in place."""
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene("cpu", **HIT_CONFIGS[name])
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    args, kwargs = calls["shade"]
    k = hits.shade_kernel_args(*args, **kwargs)
    assert (k["normal"], k["blend"], k["dq_bilinear"]) == SHADE_CODES[name]
    assert (k["oct"] is None) == (k["table"] is not None)
    assert (k["oct"] is None) == (k["normal"] != "oct")
    assert (k["proj_models"] is None) == (k["blend"] != "analytic")
    m = args[5]
    assert k["color"] is m.color and k["quality"] is m.quality
    assert k["depth"].data_ptr() == m.depth.data_ptr()
    assert k["depth"].shape == m.depth.shape[:-1]
    assert k["shade_mode"] == args[0].shade_mode
    assert k["bbox_size"] == tuple(pipe.bbox.size)


def test_gauss_space_table_matches_plain():
    """csrc/stencil13.cu's GAUSS_SPACE literals are the plain fold's f32
    gauss_space values, bit for bit."""
    import re

    src = open(os.path.join(REPO, "rgbd_recon_tpu_torch", "csrc",
                            "stencil13.cu")).read()
    body = src[src.index("GAUSS_SPACE[2 * KS + 1][2 * KS + 1] = {"):]
    body = body[body.index("{") + 1: body.index("};")]
    lits = re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f|-?0\.0f", body)
    got = np.array([float.fromhex(t[:-1]) if "x" in t else float(t[:-1])
                    for t in lits], np.float32)
    want = np.array(stencil13._GAUSS_SPACE, np.float32).reshape(-1)
    assert got.size == 169
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sentinel_bake_f32_keeps_values():
    """The f32 table holds the sentinels -(2 + field) and the TSDF values
    unrounded; the bf16 table is that table rounded once."""
    rng = np.random.default_rng(3)
    vol = torch.from_numpy(_volume(rng, (12, 16, 20)))
    bs = torch.from_numpy(rng.integers(0, 2, (3, 4, 5)).astype(np.float32)
                          * 4)
    f32 = bake.sentinel_bake_plain(vol, bs, 4, 6, torch.float32)
    keep = f32 > -1.5
    assert bool(keep.any()) and bool((~keep).any())
    assert torch.equal(f32[keep], vol[keep])
    assert torch.equal(f32[~keep], torch.round(f32[~keep]))
    assert torch.equal(f32.to(torch.bfloat16),
                       bake.sentinel_bake_plain(vol, bs, 4, 6))


def test_port_imports_without_jax():
    """The port imports with jax and flax blocked, and no file of it names
    jax in an import."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import rgbd_recon_tpu_torch, rgbd_recon_tpu_torch.convert\n"
        "import rgbd_recon_tpu_torch.recon.tsdf_pipeline\n"
        "import rgbd_recon_tpu_torch.kernels.stencil13\n"
        "import rgbd_recon_tpu_torch.kernels.bake\n"
        "import rgbd_recon_tpu_torch.kernels.gather\n"
        "import rgbd_recon_tpu_torch.kernels.holefill\n"
        "import rgbd_recon_tpu_torch.kernels.hits\n"
        "import rgbd_recon_tpu_torch.kernels.preprocess\n"
        "import rgbd_recon_tpu_torch.profile_slice\n"
        "import rgbd_recon_tpu_torch.bench.headline\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pkg = os.path.join(REPO, "rgbd_recon_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "import jax" not in text and "from jax" not in text, f


# ---- CUDA: kernel vs plain twin -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 48), (4, 424, 512)])
def test_stencil13_kernels_match_plain(cuda, shape):
    """Kernels 1-2 against the plain fold on one map, bit for bit: built
    without FMA contraction or fast math and folded in the same order."""
    rng = np.random.default_rng(1)
    d = torch.from_numpy(_depth_maps(rng, *shape)).to(cuda)
    lim = torch.tensor([[0.5, 4.5]] * shape[0], device=cuda)
    before = dict(kernels.LAUNCHES)
    got = stencil13.bilateral13(d, lim)
    want = stencil13.bilateral13_plain(d, lim)
    dn = ((d - 0.5) / 4.0).contiguous()
    got_q = stencil13.quality13(dn)
    want_q = stencil13.quality13_plain(dn)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bilateral13"] == before["bilateral13"] + 1
    assert kernels.LAUNCHES["quality13"] == before["quality13"] + 1
    for g, w in zip(got + got_q, want + want_q):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "zero"])
@pytest.mark.parametrize("shape", [(2, 40, 48), (3, 37, 101), (4, 424, 512)])
def test_quality13_kernel_bit_exact(cuda, shape, kind):
    """The redesigned quality census against the plain fold, bit for bit,
    on maps whose sides are not tile multiples: zeros, values >= 1,
    negative values and patches of tiny centres on both sides of the
    kernel's 2^-40 guard, a subnormal among them (_quality_maps); and an
    all-zero map (every thread takes the d <= 0 shortcut)."""
    rng = np.random.default_rng(7)
    if kind == "zero":
        d = torch.zeros(shape, device=cuda)
    else:
        d = torch.from_numpy(_quality_maps(rng, *shape)).to(cuda)
        assert bool((d < 0).any() and (d >= 1).any() and (d == 0).any())
        assert bool(((d > 0) & (d < 2.0 ** -126)).any())
    before = kernels.LAUNCHES["quality13"]
    got = stencil13.quality13(d)
    want = stencil13.quality13_plain(d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quality13"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,brick_vox", [((24, 32, 40), 8),
                                             ((20, 22, 18), 4),
                                             ((200, 220, 200), 10)])
def test_bake_kernels_bit_exact(cuda, shape, brick_vox):
    """Kernels 3-4 against the plain versions: bit-exact."""
    rng = np.random.default_rng(2)
    vol = torch.from_numpy(_volume(rng, shape)).to(cuda)
    occ = bake.surface_occ(vol, brick_vox)
    assert torch.equal(occ, bake.surface_occ_plain(vol, brick_vox))
    grid = occ.shape
    bs = torch.from_numpy(
        rng.integers(0, 4, grid).astype(np.float32) * brick_vox).to(cuda)
    got = bake.sentinel_bake(vol, bs, brick_vox, 6)
    want = bake.sentinel_bake_plain(vol, bs, brick_vox, 6)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["volume", "negative"])
@pytest.mark.parametrize("shape,brick_vox", [((40, 36, 44), 4),
                                             ((70, 48, 40), 8),
                                             ((200, 220, 200), 10),
                                             ((45, 50, 33), 16),
                                             ((37, 29, 53), 7),
                                             ((100, 50, 60), 40)])
def test_surface_occ_kernel_bit_exact(cuda, shape, brick_vox, fill):
    """The redesigned surface-brick mask against the plain version, bit for
    bit: Z not a multiple of 32, X not a multiple of 4 (the scalar pack),
    brick_vox in {4, 8, 10, 16}, 7 not dividing the sides, 40 (a grown z
    range over three words); a TSDF-like volume, and an all-negative one."""
    rng = np.random.default_rng(8)
    if fill == "volume":
        vol = torch.from_numpy(_volume(rng, shape)).to(cuda)
    else:
        vol = torch.full(shape, -0.01, device=cuda)
    before = kernels.LAUNCHES["surface_occ"]
    got = bake.surface_occ(vol, brick_vox)
    want = bake.surface_occ_plain(vol, brick_vox)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["surface_occ"] == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert bool(want.any()) == (fill == "volume")


@pytest.mark.cuda
@pytest.mark.parametrize("brick_vox", [4, 7, 10])
def test_surface_occ_kernel_single_voxels(cuda, brick_vox):
    """One positive voxel at a time, bit for bit against the plain version:
    on each face, edge and corner of brick (1, 1, 1)'s box grown by one
    voxel, just inside it (offsets -1 and v) and just outside (-2 and
    v + 1), and in its middle; then on each face, edge and corner of the
    volume, and next to them."""
    v = brick_vox
    shape = (3 * v + 5, 3 * v + 3, 3 * v + 2)
    offsets = (-2, -1, v // 2, v, v + 1)
    spots = [(v + oz, v + oy, v + ox)
             for oz in offsets for oy in offsets for ox in offsets]
    faces = [(0, 1, s // 2, s - 2, s - 1) for s in shape]
    spots += [(z, y, x) for z in faces[0] for y in faces[1] for x in faces[2]]
    vol = torch.full(shape, -0.01, device=cuda)
    for z, y, x in spots:
        vol[z, y, x] = 0.005
        got = bake.surface_occ(vol, v)
        want = bake.surface_occ_plain(vol, v)
        assert int(want.sum()) >= 1
        assert torch.equal(got, want), (z, y, x)
        vol[z, y, x] = -0.01


@pytest.mark.cuda
@pytest.mark.parametrize("near", ["sensor", "zero"])
@pytest.mark.parametrize("shape", [(2, 40, 48), (3, 37, 101), (4, 424, 512)])
def test_bilateral13_kernel_bit_exact(cuda, shape, near):
    """The redesigned bilateral kernel against the plain fold, bit for bit,
    on maps whose sides are not tile multiples, with zeros and depths
    outside [near, far] (per-sensor limits). A near limit of 0 makes the
    zero depths non-border taps of each other, with a 1e-20 divisor: the
    kernel's full-division path."""
    rng = np.random.default_rng(4)
    d = torch.from_numpy(_depth_maps(rng, *shape)).to(cuda)
    lim = torch.tensor([[(0.5 + 0.4 * i) * (near == "sensor"), 4.5 - 0.3 * i]
                        for i in range(shape[0])], device=cuda)
    assert bool((d > lim[:, 1:, None]).any())
    if near == "sensor":
        assert bool((d < lim[:, :1, None]).any())
    before = kernels.LAUNCHES["bilateral13"]
    got = stencil13.bilateral13(d, lim)
    want = stencil13.bilateral13_plain(d, lim)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bilateral13"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rounds", [0, 1, 6, 7])
@pytest.mark.parametrize("shape,brick_vox", [((24, 32, 40), 8),
                                             ((17, 23, 45), 5),
                                             ((33, 19, 300), 7),
                                             ((300, 21, 33), 7),
                                             ((200, 220, 200), 10)])
def test_sentinel_bake_kernel_bit_exact(cuda, shape, brick_vox, rounds,
                                        out_dtype):
    """The redesigned sentinel bake against the plain version, bit for bit:
    sides that are not tile multiples, brick_vox that does not divide the
    volume, a z side past one register column (300 > 224: chunks of z),
    K in {0, 1, 6, 7}, both output types."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(_volume(rng, shape)).to(cuda)
    grid = tuple(-(-s // brick_vox) for s in shape)
    bs = torch.from_numpy(
        rng.integers(0, 3, grid).astype(np.float32) * brick_vox).to(cuda)
    before = kernels.LAUNCHES["sentinel_bake"]
    got = bake.sentinel_bake(vol, bs, brick_vox, rounds, out_dtype)
    want = bake.sentinel_bake_plain(vol, bs, brick_vox, rounds, out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sentinel_bake"] == before + 1
    assert got.dtype == out_dtype
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rounds", [15, 16, 20, 31, 46, 255])
@pytest.mark.parametrize("shape", [(70, 40, 45), (300, 21, 33)])
def test_sentinel_bake_kernel_most_rounds(cuda, shape, rounds, out_dtype):
    """K = 15, one launch whose tile's core is 2 columns wide, and K past
    it up to MAX_ROUNDS (255), in several dilation launches (8 + 8, 10 +
    10, 11 + 10 + 10, 12 + 12 + 11 + 11, 17 x 15) whose counts add up; a z
    side past one register column (300 > 224) as well. One call counted."""
    from rgbd_recon_tpu_torch.kernels.bake import MAX_ROUNDS

    assert rounds <= MAX_ROUNDS
    rng = np.random.default_rng(6)
    vol = torch.from_numpy(_volume(rng, shape)).to(cuda)
    grid = tuple(-(-n // 10) for n in shape)
    bs = torch.from_numpy(
        rng.integers(0, 3, grid).astype(np.float32) * 10).to(cuda)
    before = kernels.LAUNCHES["sentinel_bake"]
    got = bake.sentinel_bake(vol, bs, 10, rounds, out_dtype)
    want = bake.sentinel_bake_plain(vol, bs, 10, rounds, out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sentinel_bake"] == before + 1
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
def test_sentinel_bake_kernel_rejects_too_many_rounds(cuda):
    from rgbd_recon_tpu_torch.kernels.bake import MAX_ROUNDS

    vol = torch.zeros((8, 8, 8), device=cuda)
    bs = torch.zeros((2, 2, 2), device=cuda)
    with pytest.raises(ValueError, match="rounds"):
        bake.sentinel_bake(vol, bs, 4, MAX_ROUNDS + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("brick_size,rounds", [(0.4, 16), (0.4, 20),
                                               (2.0, 16), (2.0, 20)])
def test_render_bake_rule_on_the_card(cuda, brick_size, rounds):
    """skip_fine_rounds past one kernel launch's 15 rounds on the card: the
    render's bake launches surface_occ, and sentinel_bake exactly when
    skip_fine_rounds <= brick_vox (4-voxel bricks: the plain bake; 20-voxel
    bricks: the kernel, in two launches); either table equals the plain
    bake of the same volume and brick clearance."""
    pipe, volume, maps, counts, cam, _ = _small_scene(
        cuda, brick_size=brick_size, skip_fine_rounds=rounds)
    render_fn, _ = pipe.make_render_fn(cam)
    kernels.reset_launch_counts()
    table, _, occ, bsafe = render_fn.bake(volume, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert launched["surface_occ"] == 1
    assert launched["sentinel_bake"] == int(rounds <= pipe.brick_vox)
    want = bake.sentinel_bake_plain(
        volume, (bsafe * float(pipe.brick_vox)).contiguous(),
        pipe.brick_vox, rounds)
    assert torch.equal(table.view(torch.int16), want.view(torch.int16))
    assert torch.equal(occ, bake.surface_occ_plain(volume, pipe.brick_vox))
    out = pipe.make_renderer(cam)(volume, maps, counts)
    assert int(out.hit.sum()) > 50


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [3, 4, 6])
@pytest.mark.parametrize("shards", [8, 3])
def test_slab_bake_on_the_card(cuda, shards, rounds):
    """The sharded step's slab bake on one card, its shards all on it: the
    kernels (surface_occ per shard; sentinel_bake per shard where
    skip_fine_rounds <= brick_vox) give the tables of the plain twins' slab
    bake on the CPU and of the single-device bake on the card, bit for
    bit."""
    from rgbd_recon_tpu_torch.calib.sensors import CalibrationSet
    from rgbd_recon_tpu_torch.dist.mesh import _bake_slabs
    from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

    pipe, volume, maps, counts, cam, _ = _small_scene(
        cuda, skip_fine_rounds=rounds)
    render, _ = pipe.make_render_fn(cam)
    want = render.bake(volume, counts)
    kernels.reset_launch_counts()
    got = _bake_slabs(render, _slabs(pipe, volume, shards, cuda),
                      tuple(volume.shape), pipe.brick_vox, pipe._limit,
                      volume.device)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert launched["surface_occ"] == shards
    assert launched["sentinel_bake"] == shards * int(rounds <= 4)
    cpu_calib = CalibrationSet(**{
        f.name: getattr(pipe.calib, f.name).cpu()
        for f in dataclasses.fields(CalibrationSet)})
    cpu_render, _ = TsdfPipeline(cpu_calib, pipe.config,
                                 pipe.bbox).make_render_fn(cam)
    plain = _bake_slabs(cpu_render, _slabs(pipe, volume, shards, "cpu"),
                        tuple(volume.shape), pipe.brick_vox, pipe._limit,
                        torch.device("cpu"))
    # no oct table: Y = 22 is no whole number of 4-voxel bricks
    assert got[1] is None and plain[1] is None and want[1] is None
    for name, g, p, w in zip(("table", "occ", "bsafe"), got[::2] + got[3:],
                             plain[::2] + plain[3:], want[::2] + want[3:]):
        assert torch.equal(g, w), name
        assert torch.equal(g.cpu(), p), name


@pytest.mark.cuda
def test_sharded_step_over_the_cards(cuda):
    """With two cards or more, the sharded step with one shard on each
    (the slab bake's kernels launched on each shard's card, the halo,
    gathers and maps copied between cards) is bit-equal to the single
    device's step on the first card."""
    from rgbd_recon_tpu_torch import dist

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    pipe, volume, maps, counts, cam, frames = _small_scene(
        torch.device("cuda", 0))
    ref = pipe.make_renderer(cam)(volume, maps, counts)
    kernels.reset_launch_counts()
    vol_sh, out = dist.shard_compact_step(pipe, cam, dist.make_mesh())(frames)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["surface_occ"] == n
    assert [s.device.index for s in vol_sh.slabs] == list(range(n))
    assert torch.equal(vol_sh.gather(), volume)
    for field in ("hit", "depth", "color"):
        assert torch.equal(getattr(out, field), getattr(ref, field)), field


# ---- the render bake's chain kernels (csrc/bake.cu brick_clearance and
# oct_table) ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rounds", bake_chain_cases.ROUNDS)
@pytest.mark.parametrize("name", bake_chain_cases.CARD_CLEARANCE_CASES)
def test_bake_chain_clearance_matches_twin(cuda, name, rounds):
    """brick_clearance (through its dispatch: one launch) bit for bit
    against brick_clearance_plain on bake_chain_cases' grids at 0, 1, 6
    and 16 rounds."""
    occ = torch.from_numpy(bake_chain_cases.clearance_case(name)).to(cuda)
    kernels.reset_launch_counts()
    got = bake.brick_clearance(occ, rounds, 10)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["brick_clearance"] == 1
    want = bake.brick_clearance_plain(occ, rounds, 10)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _bits_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [254, 30])
def test_bake_chain_clearance_most_rounds(cuda, rounds):
    """The most rounds the kernel takes (a capped distance of 255 in a
    byte) and more rounds than the grid is wide, bit for bit; 255 rounds
    are refused."""
    from rgbd_recon_tpu_torch.kernels.bake import brick_clearance_cuda

    occ = torch.from_numpy(bake_chain_cases.clearance_case("one_brick")).to(
        cuda)
    want = bake.brick_clearance_plain(occ, rounds, 4)
    assert float(want[0].max()) == 3.0
    for g, w in zip(brick_clearance_cuda(occ, rounds, 4), want):
        assert _bits_equal(g, w)
    empty = torch.zeros(3, 4, 5, dtype=torch.bool, device=cuda)
    assert bool((brick_clearance_cuda(empty, rounds, 4)[0] == rounds).all())
    with pytest.raises(ValueError, match="rounds"):
        brick_clearance_cuda(occ, 255, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(bake_chain_cases.CARD_OCT_CASES))
def test_bake_chain_oct_matches_twin(cuda, name, dtype):
    """build_oct_bricks on the card (one compact, one oct_table launch)
    bit for bit against build_oct_plain on the card: every capacity row
    and the slot map; fewer, as many and more set bricks than the
    capacity, none, the cells' 200 x 220 x 200 volume at 768 slots, 20-
    voxel bricks (staged) and 23-voxel bricks (read in place)."""
    from rgbd_recon_tpu_torch.ops import raymarch

    vol, occ, v, capacity = bake_chain_cases.oct_case(name)
    vol = torch.from_numpy(vol).to(cuda)
    occ = torch.from_numpy(occ).to(cuda)
    kernels.reset_launch_counts()
    got = raymarch.build_oct_bricks(vol, occ, v, capacity, dtype)
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    assert launched == {"compact": 1, "oct_table": 1}
    want = raymarch.build_oct_plain(vol, occ, v, capacity, dtype)
    assert got.rows.dtype == dtype and got.rows.shape == want.rows.shape
    assert _bits_equal(got.rows, want.rows)
    assert torch.equal(got.slots, want.slots)


@pytest.mark.cuda
def test_bake_chain_wrappers_refuse(cuda):
    """On CUDA tensors the two wrappers refuse a wrong type, shape, layout
    or device, and count nothing."""
    from rgbd_recon_tpu_torch.kernels.bake import (
        brick_clearance_cuda,
        oct_table_cuda,
    )

    kernels.reset_launch_counts()
    occ = torch.zeros(4, 5, 6, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        brick_clearance_cuda(occ.to(torch.uint8), 6, 4)
    with pytest.raises(ValueError, match="contiguous"):
        brick_clearance_cuda(occ.transpose(0, 2), 6, 4)
    vol = torch.zeros(8, 12, 16, device=cuda)
    ids = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        oct_table_cuda(vol, ids, 5)
    with pytest.raises(ValueError, match="float32"):
        oct_table_cuda(vol.double(), ids, 4)
    with pytest.raises(ValueError, match="int64"):
        oct_table_cuda(vol, ids.int(), 4)
    with pytest.raises(ValueError, match="int64"):
        oct_table_cuda(vol, ids.cpu(), 4)
    with pytest.raises(ValueError, match="out_dtype"):
        oct_table_cuda(vol, ids, 4, torch.float16)
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert oct_table_cuda(vol, ids[:0], 4).shape == (0, 8)
    assert kernels.launch_counts()["oct_table"] == 0


def _bake_on_twins(monkeypatch):
    """Point the bake's dispatches at their plain twins."""
    from rgbd_recon_tpu_torch.ops import raymarch

    monkeypatch.setattr(bake, "surface_occ", bake.surface_occ_plain)
    monkeypatch.setattr(bake, "brick_clearance", bake.brick_clearance_plain)
    monkeypatch.setattr(bake, "sentinel_bake", bake.sentinel_bake_plain)
    monkeypatch.setattr(raymarch, "build_oct_bricks",
                        raymarch.build_oct_plain)


# the small scene's configs of the render bake (20 cm bricks of 2 voxels:
# the (20, 22, 20) volume is whole bricks and the fast config builds its
# oct table; 2 fine rounds take the sentinel kernel) and their launches
BAKE_CHAIN_CONFIGS = {
    "fast": dict(skip_fine_rounds=2),
    "parity": dict(march_mode="trilinear", march_empty_skip=False,
                   integrate_taps="bilinear", projection_model=False,
                   march_dtype="float32", skip_fine_rounds=2),
}
BAKE_CHAIN_LAUNCHES = {
    "fast": dict(surface_occ=1, brick_clearance=1, sentinel_bake=1,
                 compact=1, oct_table=1),
    "parity": dict(surface_occ=1, brick_clearance=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", sorted(BAKE_CHAIN_CONFIGS))
def test_bake_chain_bake_without_host_sync(cuda, monkeypatch, cfg):
    """A whole render bake on the card makes no host sync
    (set_sync_debug_mode("error")), launches the kernels of its config once
    each and nothing else, and is bit-equal, part for part, to the same
    bake on the twins (which launch none)."""
    pipe, volume, _, counts, cam, _ = _small_scene(
        cuda, brick_size=0.2, **BAKE_CHAIN_CONFIGS[cfg])
    render, _ = pipe.make_render_fn(cam)
    render.bake(volume, counts)                 # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = render.bake(volume, counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.launch_counts().items() if n} == \
        BAKE_CHAIN_LAUNCHES[cfg]
    assert (got[1] is not None) == (cfg == "fast")
    _bake_on_twins(monkeypatch)
    kernels.reset_launch_counts()
    want = render.bake(volume, counts)
    torch.cuda.synchronize()
    assert all(n == 0 for n in kernels.launch_counts().values())
    for name, g, w in zip(("table", "oct", "occ", "bsafe"), got, want):
        assert _same_bake_part(g, w), name
    assert int(got[2].sum()) > 0


@pytest.mark.cuda
def test_bake_chain_bake_in_a_graph(cuda, monkeypatch):
    """The fast config's whole bake (surface_occ, brick_clearance,
    sentinel_bake, compact, oct_table) captured in one CUDA graph on a side
    stream, after one eager bake there (compact's scratch), and replayed 3
    times on changed volumes copied into the captured one: each replay
    bit-equal, part for part, to the bake on the twins of that volume."""
    pipe, volume, _, counts, cam, _ = _small_scene(
        cuda, brick_size=0.2, **BAKE_CHAIN_CONFIGS["fast"])
    render, _ = pipe.make_render_fn(cam)
    static = volume.clone()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        render.bake(static, counts)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        baked = render.bake(static, counts)
    assert {k: n for k, n in kernels.launch_counts().items() if n} == \
        BAKE_CHAIN_LAUNCHES["fast"]
    rng = np.random.default_rng(9)
    twins = []
    for i in range(3):
        shift = torch.from_numpy(rng.uniform(-0.05, 0.05, volume.shape)
                                 .astype(np.float32)).to(cuda)
        static.copy_(torch.clamp(volume + shift * i, -pipe._limit,
                                 pipe._limit))
        graph.replay()
        torch.cuda.synchronize()
        with monkeypatch.context() as m:
            _bake_on_twins(m)
            want = render.bake(static, counts)
        for name, g, w in zip(("table", "oct", "occ", "bsafe"), baked, want):
            assert _same_bake_part(g, w), (i, name)
        twins.append(int(want[2].sum()))
    assert len(set(twins)) > 1


# ---- the gather-rate probe's kernels ----------------------------------------

def _gather_inputs(rng, kind, table_shape, idx_shape, device, offset=0,
                   table_offset=0):
    """A normal f32 table and int32 indices in range along the gathered
    axis of ``kind``, the first 0 and the last the axis' last index; with
    ``offset`` the indices are a contiguous view at that storage offset,
    with ``table_offset`` the table."""
    size = int(np.prod(table_shape))
    t = torch.from_numpy(rng.standard_normal(table_offset + size).astype(
        np.float32)).to(device)[table_offset:].view(table_shape)
    assert t.storage_offset() == table_offset and t.is_contiguous()
    axis_len = {"flat": table_shape[0], "smem": table_shape[0],
                "rows": table_shape[-1], "cluster": table_shape[-1],
                "cols": table_shape[0]}[kind]
    buf = rng.integers(0, axis_len, offset + int(np.prod(idx_shape)),
                       dtype=np.int32)
    buf[offset], buf[-1] = 0, axis_len - 1
    i = torch.from_numpy(buf).to(device)[offset:].view(idx_shape)
    assert i.storage_offset() == offset and i.is_contiguous()
    return t, i


def _gather_shape(shape, device):
    """``shape`` with the card's limits put in: "most" is the largest table
    of the shared-memory gather, "cap4" / "cap8" the longest row a cluster
    of 4 / 8 blocks holds (gather_rows_cluster), "+1" one entry more."""
    from rgbd_recon_tpu_torch.kernels import gather as kg

    cap4, cap8 = kg.rows_capacities(device)
    named = {"most": kg.smem_table_entries(device), "cap4": cap4,
             "cap4+1": cap4 + 1, "cap8": cap8, "cap8+1": cap8 + 1}
    return tuple(named.get(d, d) for d in shape)


GATHER_NAMES = {"flat": "gather_flat", "smem": "gather_flat_smem",
                "rows": "gather_rows", "cluster": "gather_rows_cluster",
                "cols": "gather_cols"}


GATHER_CASES = [
    ("flat", (1 << 20,), (1 << 20,)),     # the probe's shapes
    ("flat", (1000,), (777,)),
    # lengths around multiples of 4 lookups (16 bytes), and past 2^20
    ("flat", (1000,), (1,)),
    ("flat", (1000,), (3,)),
    ("flat", (1000,), (4,)),
    ("flat", (1000,), (5,)),
    ("flat", (1000,), (129,)),
    ("flat", (1 << 20,), ((1 << 20) + 3,)),
    ("smem", (1 << 15,), (1 << 20,)),     # the probe's shapes
    ("smem", (1,), (300,)),
    ("smem", (4099,), (5000,)),
    ("rows", (8, 1 << 17), (8, 1 << 17)),  # the probe's shapes
    ("rows", (3, 1001), (3, 517)),
    ("cols", (1 << 13, 128), (1 << 13, 128)),  # the probe's shapes
    ("cols", (999, 37), (45, 37)),
    ("cols", (999, 37), (1001, 37)),       # C % 4 != 0
    ("cols", (1000, 4), (129, 4)),         # C = 4: 16 bytes a row
    # gather_rows_cluster (each row in a cluster's shared memory) at the
    # probe's shapes, at the longest rows clusters of 4 and 8 blocks hold
    # and one entry past the first (8 blocks); gather_rows one entry past
    # the second (no cluster holds it)
    ("cluster", (8, 1 << 17), (8, 1 << 17)),
    ("cluster", (2, "cap4"), (2, 5000)),
    ("cluster", (2, "cap4+1"), (2, 5000)),
    ("cluster", (1, "cap8"), (1, 5000)),
    ("rows", (1, "cap8+1"), (1, 5000)),
    # rows whose count is not a multiple of the clusters a row
    ("cluster", (5, 1 << 16), (5, (1 << 15) + 4)),
    ("cluster", (13, 300), (13, 1 << 14)),
    # odd C: every row but the first starts off a 16-byte boundary, and
    # odd M: so do the index rows
    ("cluster", (3, 1001), (3, 517)),
    ("cluster", (5, 4099), (5, 1027)),
    ("cluster", (1, 5), (1, 9)),
    # the shared-memory gather at its largest table, and at 1, 3, 5 lookups
    ("smem", ("most",), (1 << 20,)),
    ("smem", (4099,), (1,)),
    ("smem", (4099,), (3,)),
    ("smem", (4099,), (5,)),
]

# gather_flat and gather_cols on index views at storage offsets 1-3: the
# indices are not 16-byte aligned where the fresh output is
GATHER_VIEW_CASES = [
    (kind, table_shape, idx_shape, offset)
    for kind, table_shape, idx_shape in [
        ("flat", (1 << 20,), ((1 << 20) + 3,)),
        ("flat", (1000,), (129,)),
        ("cols", (1 << 13, 128), (1 << 13, 128)),
        ("cols", (1000, 4), (129, 4)),
        ("cols", (999, 37), (45, 37))]
    for offset in (1, 2, 3)
] + [
    # the shared-memory gathers on a table view at storage offsets 1-3
    # (gather_rows_cluster: head and tail outside the bulk copy), then on
    # index views (no 16-byte index loads)
    (kind, table_shape, idx_shape, (offset, 0) if on_table else offset)
    for on_table, kind, table_shape, idx_shape in [
        (True, "smem", (1 << 15,), (1 << 20,)),
        (True, "smem", (4099,), (5000,)),
        (True, "cluster", (8, 1 << 17), (8, 1 << 17)),
        (True, "cluster", (3, 1001), (3, 517)),
        (False, "smem", (4099,), (5000,)),
        (False, "cluster", (4, 1 << 15), (4, 1 << 15))]
    for offset in (1, 2, 3)
]


def _gather_fns(kind):
    from rgbd_recon_tpu_torch.kernels import gather as kg
    from rgbd_recon_tpu_torch.ops import gather as og

    return {"flat": (kg.gather_flat_cuda, og.gather_flat_plain),
            "smem": (kg.gather_flat_smem_cuda, og.gather_flat_plain),
            "rows": (kg.gather_rows_cuda, og.gather_rows_plain),
            "cluster": (kg.gather_rows_cluster_cuda, og.gather_rows_plain),
            "cols": (kg.gather_cols_cuda, og.gather_cols_plain)}[kind]


def test_gather_cuda_wrappers_reject_cpu_tensors():
    from rgbd_recon_tpu_torch.kernels import gather as kg

    t, i = torch.zeros(8), torch.zeros(4, dtype=torch.int32)
    for fn in (kg.gather_flat_cuda, kg.gather_flat_smem_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t, i)
    for fn in (kg.gather_rows_cuda, kg.gather_rows_cluster_cuda,
               kg.gather_cols_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t.reshape(2, 4), i.reshape(2, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,table_shape,idx_shape", GATHER_CASES)
def test_gather_kernels_bit_exact(cuda, kind, table_shape, idx_shape):
    """Each gather kernel equals its plain twin bit for bit and counts its
    launch."""
    kern, plain = _gather_fns(kind)
    rng = np.random.default_rng(len(idx_shape) + idx_shape[0])
    table_shape = _gather_shape(table_shape, cuda)
    t, i = _gather_inputs(rng, kind, table_shape, idx_shape, cuda)
    name = GATHER_NAMES[kind]
    before = kernels.LAUNCHES[name]
    got = kern(t, i)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.float32 and got.shape == i.shape
    assert torch.equal(got, plain(t, i))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,table_shape,idx_shape,offset",
                         GATHER_VIEW_CASES)
def test_gather_kernels_on_offset_views(cuda, kind, table_shape, idx_shape,
                                        offset):
    """The gathers on index views at a storage offset, and the cluster
    gathers on table views at one (``offset`` = (table's, indices')), equal
    their plain twins bit for bit and count one launch each."""
    kern, plain = _gather_fns(kind)
    t_off, i_off = offset if isinstance(offset, tuple) else (0, offset)
    rng = np.random.default_rng(t_off + i_off + idx_shape[0])
    t, i = _gather_inputs(rng, kind, table_shape, idx_shape, cuda, i_off,
                          t_off)
    name = GATHER_NAMES[kind]
    before = kernels.LAUNCHES[name]
    got = kern(t, i)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.shape == i.shape
    assert torch.equal(got, plain(t, i))


@pytest.mark.cuda
def test_gather_smem_largest_table(cuda):
    """The shared-memory gather at its largest table (the opt-in shared
    memory of a block, 58,112 entries on an H100), every entry looked up,
    and with no lookups (the launch that only stages the table)."""
    from rgbd_recon_tpu_torch.kernels import gather as kg

    most = kg.smem_table_entries(cuda)
    assert most >= 1 << 15
    rng = np.random.default_rng(3)
    t, i = _gather_inputs(rng, "smem", (most,), (1 << 20,), cuda)
    i[:most] = torch.arange(most, dtype=torch.int32, device=cuda)
    got = kg.gather_flat_smem_cuda(t, i)
    torch.cuda.synchronize()
    assert torch.equal(got, t[i])
    empty = kg.gather_flat_smem_cuda(t, i[:0])
    torch.cuda.synchronize()
    assert empty.shape == (0,)
    with pytest.raises(ValueError, match="shared memory"):
        kg.gather_flat_smem_cuda(torch.zeros(most + 1, device=cuda), i)


@pytest.mark.cuda
def test_gather_wrappers_reject_what_they_do_not_take(cuda):
    """dtype, dimensions, contiguity, matching axes and devices."""
    from rgbd_recon_tpu_torch.kernels import gather as kg

    t = torch.zeros(64, device=cuda)
    i = torch.zeros(16, dtype=torch.int32, device=cuda)
    for fn in (kg.gather_flat_cuda, kg.gather_flat_smem_cuda):
        with pytest.raises(ValueError, match="float32"):
            fn(t.double(), i)
        with pytest.raises(ValueError, match="int32"):
            fn(t, i.long())
        with pytest.raises(ValueError, match="dimensions"):
            fn(t.reshape(8, 8), i)
        with pytest.raises(ValueError, match="contiguous"):
            fn(t, torch.zeros(32, dtype=torch.int32, device=cuda)[::2])
        with pytest.raises(ValueError, match="CUDA"):
            fn(t, i.cpu())
        with pytest.raises(ValueError, match="empty"):
            fn(t[:0], i)
    t2 = t.reshape(8, 8)
    with pytest.raises(ValueError, match="rows"):
        kg.gather_rows_cuda(t2, i.reshape(4, 4))
    with pytest.raises(ValueError, match="columns"):
        kg.gather_cols_cuda(t2, i.reshape(4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        kg.gather_rows_cuda(t2.t(), i.reshape(8, 2))


@pytest.mark.cuda
def test_gather_rows_cluster_refuses_longer_rows(cuda):
    """gather_rows_cluster takes rows up to what its larger cluster holds:
    one entry more and the launch plan is refused, so the wrapper raises
    and launches nothing (no fallback to the L2 kernel)."""
    from rgbd_recon_tpu_torch.kernels import gather as kg

    C = kg.rows_capacities(cuda)[1] + 1
    t = torch.zeros(1, C, device=cuda)
    i = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="gather_rows_cluster"):
        kg.rows_plan(1, C, 8, cuda)
    with pytest.raises(RuntimeError, match="gather_rows_cluster"):
        kg.gather_rows_cluster_cuda(t, i)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_gather_launch_plans(cuda):
    """The launch plans the card reports: gather_rows_cluster holds the
    probe's 2^17-entry rows in clusters of 4 blocks, each block's slice a
    multiple of 4 entries that with the cluster's other slices covers the
    row and fits the block's shared memory; up to the smaller cluster's
    capacity it keeps that cluster, one entry past it takes the larger;
    gather_flat_smem a persistent grid, smaller for few lookups."""
    from rgbd_recon_tpu_torch.kernels import gather as kg

    optin = 4 * kg.smem_table_entries(cuda)   # a block's shared memory
    cap4, cap8 = kg.rows_capacities(cuda)
    assert cap8 > cap4 > 1 << 17
    plans = [(C, kg.rows_plan(R, C, M, cuda)) for R, C, M in [
        (8, 1 << 17, 1 << 17), (3, 1001, 517), (1, 5, 9), (1, cap4, 4096),
        (1, cap4 + 1, 1 << 16), (1, cap8, 4096)]]
    assert [p["cluster"] for _, p in plans] == [4, 4, 4, 4, 8, 8]
    assert [p["capacity"] for _, p in plans] == [cap4] * 4 + [cap8] * 2
    for C, p in plans:
        S = p["slice"]
        assert S % 4 == 0 and S * p["cluster"] >= C
        assert S - 4 < -(-C // p["cluster"])
        assert 4 * S < p["smem_bytes"] <= optin
        assert p["blocks"] % (p["clusters_per_row"] * p["cluster"]) == 0
    probe = plans[0][1]
    assert probe["blocks"] == 8 * probe["clusters_per_row"] * 4
    full = kg.smem_plan(0, 1 << 15, cuda)
    assert full["blocks"] >= torch.cuda.get_device_properties(
        cuda).multi_processor_count
    assert full["smem_bytes"] == 4 << 15
    assert kg.smem_plan(5, 1 << 15, cuda)["blocks"] == 1


# ---- the march -------------------------------------------------------------

# the cells' volume (1 cm voxels in the 2 x 2.2 x 2 m box), their TSDF
# limit and the fast frame's fine march (2,048 blocks of 4 x 4 rays at
# 1280x720: ray_compaction's floor)
MARCH_VOLUME = (200, 220, 200)
MARCH_LIMIT = 0.01
MARCH_RAYS = 184_320
# (mode, table): the fast cell's (nearest, bf16 sentinels), the fast_f32
# path's, the parity cell's (trilinear, raw f32), and the other two
MARCH_CASES = [("nearest", "sentinel_bf16"), ("nearest", "raw_f32"),
               ("nearest", "sentinel_f32"), ("trilinear", "raw_f32"),
               ("trilinear", "sentinel_bf16")]
_MARCH_TABLES = {}


def _march_table(kind, device):
    """(table, sentinel_skip, sentinel_scale) at the cells' volume: a
    sphere's TSDF band (+-limit) with seeded values on the faces' two outer
    layers, raw or sentinel-coded by the render's bake rule (10-voxel
    bricks, 6 rounds)."""
    if kind not in _MARCH_TABLES:
        Z, Y, X = MARCH_VOLUME
        z, y, x = (torch.arange(n, dtype=torch.float32, device=device) + 0.5
                   for n in MARCH_VOLUME)
        r = torch.sqrt((x[None, None] - X / 2) ** 2
                       + (y[None, :, None] - Y / 2) ** 2
                       + (z[:, None, None] - Z / 2) ** 2)
        vol = torch.clamp((60.0 - r) * MARCH_LIMIT * 0.4, -MARCH_LIMIT,
                          MARCH_LIMIT)
        noise = torch.from_numpy(np.random.default_rng(5).uniform(
            -MARCH_LIMIT, MARCH_LIMIT / 2, MARCH_VOLUME).astype(
                np.float32)).to(device)
        inner = torch.zeros(MARCH_VOLUME, dtype=torch.bool, device=device)
        inner[2:-2, 2:-2, 2:-2] = True
        vol = torch.where(inner, vol, noise).contiguous()
        if kind == "raw_f32":
            table, skip = vol, False
        else:
            occ = bake.surface_occ_plain(vol, 10)
            bs = (bake.fine_safe_field(occ, 2) * 10.0).contiguous()
            dtype = (torch.bfloat16 if kind == "sentinel_bf16"
                     else torch.float32)
            table = bake.sentinel_bake_plain(vol, bs, 10, 6, dtype)
            skip = True
        _MARCH_TABLES[kind] = (table, skip, 1.0 / max(MARCH_VOLUME))
    return _MARCH_TABLES[kind]


def _march_rays(seed, n, device):
    """((pos0 x, y, z), length), (dir x, y, z) of ``n`` rays: most from a
    shell of radius 0.45 around the cube's centre toward the sphere, the
    rest from anywhere in the cube in any direction; lengths in [0, 0.9],
    a few 0 or negative."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    start = np.where(np.arange(n) % 8 < 6, 0.5 + 0.45 * u,
                     rng.uniform(0.0, 1.0, (3, n)))
    aim = 0.5 + rng.normal(0.0, 0.1, (3, n)) - start
    d = np.where(np.arange(n) % 8 < 6, aim, rng.normal(size=(3, n)))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    length = rng.uniform(0.0, 0.9, n)
    length[rng.random(n) < 0.05] = 0.0
    length[rng.random(n) < 0.02] = -0.1

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return (tuple(map(t, start)), t(length)), tuple(map(t, d))


def _assert_march_equal(got, want):
    """hit, num and the six state tensors bit for bit (NaN payloads too)."""
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for name, g, w in zip(("t", "prev_t", "prev", "lo_t", "hi_t", "hit_t"),
                          got[2], want[2]):
        assert g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("max_steps", [0, 1, 7, 8, 9, 64])
@pytest.mark.parametrize("mode,kind", MARCH_CASES)
def test_march_kernel_bit_exact(cuda, mode, kind, max_steps, resume):
    """The march kernel against march_plain at the cells' volume and the
    fast frame's ray count, bit for bit; with ``resume`` from the twin's
    state after 5 steps, a tenth of the rays pushed past their length."""
    from rgbd_recon_tpu_torch.kernels.raymarch import march_cuda
    from rgbd_recon_tpu_torch.ops import raymarch

    table, skip, scale = _march_table(kind, cuda)
    start_end, dirs = _march_rays(max_steps + 100 * resume, MARCH_RAYS, cuda)
    res = None
    if resume:
        _, _, st = raymarch.march_plain(table, MARCH_LIMIT, 5, start_end,
                                        dirs, mode, skip, scale)
        past = torch.rand(MARCH_RAYS, generator=torch.Generator(
            cuda).manual_seed(1), device=cuda) < 0.1
        res = (torch.where(past, start_end[1] + 0.05, st[0]), st[1], st[2])
    before = kernels.LAUNCHES["march"]
    got = march_cuda(table, MARCH_LIMIT, max_steps, start_end, dirs, mode,
                     skip, scale, res)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["march"] == before + 1
    want = raymarch.march_plain(table, MARCH_LIMIT, max_steps, start_end,
                                dirs, mode, skip, scale, res)
    _assert_march_equal(got, want)
    if max_steps == 64 and not resume:
        assert int(got[0].sum()) > MARCH_RAYS // 10


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kind", MARCH_CASES)
def test_march_kernel_on_column_views(cuda, mode, kind):
    """The tail stages' form: the per-ray inputs and the resumed state are
    column views of (N, 8) rows (stride 8, storage offsets 0-7), read
    through their strides, bit-equal to march_plain on the same views and
    to the kernel on contiguous copies."""
    from rgbd_recon_tpu_torch.kernels.raymarch import march_cuda
    from rgbd_recon_tpu_torch.ops import raymarch

    table, skip, scale = _march_table(kind, cuda)
    n = MARCH_RAYS // 10
    (p0, length), d = _march_rays(7, n, cuda)
    rg = torch.stack([*p0, *d, length, torch.zeros_like(length)], dim=-1)
    _, _, st = raymarch.march_plain(table, MARCH_LIMIT, 9, (p0, length), d,
                                    mode, skip, scale)
    sg = torch.stack([*st, torch.zeros_like(length),
                      torch.zeros_like(length)], dim=-1)
    views = ((rg[:, 0], rg[:, 1], rg[:, 2]), rg[:, 6])
    vdirs = (rg[:, 3], rg[:, 4], rg[:, 5])
    vres = (sg[:, 0], sg[:, 1], sg[:, 2])
    assert vres[0].stride() == (8,) and not views[1].is_contiguous()
    got = march_cuda(table, MARCH_LIMIT, 132, views, vdirs, mode, skip,
                     scale, vres)
    want = raymarch.march_plain(table, MARCH_LIMIT, 132, views, vdirs, mode,
                                skip, scale, vres)
    _assert_march_equal(got, want)
    dense = march_cuda(
        table, MARCH_LIMIT, 132,
        (tuple(v.contiguous() for v in views[0]), views[1].contiguous()),
        tuple(v.contiguous() for v in vdirs), mode, skip, scale,
        tuple(v.contiguous() for v in vres))
    _assert_march_equal(dense, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_march_kernel_full_screen(cuda, mode):
    """render_dense's march: (720, 1280) rays from an eye through their
    unit-cube entries over the raw f32 volume, the whole budget of the
    cells' limit (347 steps), bit-equal to march_plain."""
    from rgbd_recon_tpu_torch.kernels.raymarch import march_cuda
    from rgbd_recon_tpu_torch.ops import raymarch

    table, _, _ = _march_table("raw_f32", cuda)
    cam = raymarch.ViewCamera(width=1280, height=720, eye=(0.5, 0.55, 1.9),
                              target=(0.5, 0.5, 0.5))
    d = torch.from_numpy(cam.ray_directions_world().astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dn = tuple(d[..., i].contiguous().to(cuda) for i in range(3))
    eye = torch.tensor(cam.eye, dtype=torch.float32, device=cuda)
    start_end = raymarch.unit_cube_entry(eye, dn, MARCH_LIMIT)
    steps = int(np.ceil(np.sqrt(3.0) / (MARCH_LIMIT * 0.5)))
    got = march_cuda(table, MARCH_LIMIT, steps, start_end, dn, mode, False)
    want = raymarch.march_plain(table, MARCH_LIMIT, steps, start_end, dn,
                                mode, False)
    assert got[0].shape == (720, 1280)
    _assert_march_equal(got, want)
    assert int(got[0].sum()) > 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("config,marches", [
    ({}, 4),
    (dict(march_mode="trilinear", march_empty_skip=False,
          march_dtype="float32"), 2),
    (dict(march_mode="trilinear", march_empty_skip=False,
          march_dtype="float32", bricking=False, skip_space=False), 1),
    (dict(march_chunk=8), 3)])
def test_render_marches_on_the_kernel(cuda, monkeypatch, config, marches):
    """A render on the card launches the march kernel once a stepwise
    march (the fast config: the coarse march, phase 1 and two tail stages;
    the parity config: the coarse and the full march; without blocks the
    full-screen march; with march_chunk phase 1 is the chunked march) and
    equals, bit for bit, the same render with every march on
    march_plain."""
    from rgbd_recon_tpu_torch.ops import raymarch

    pipe, volume, maps, counts, cam, _ = _small_scene(cuda, **config)
    render = pipe.make_renderer(cam)
    kernels.reset_launch_counts()
    out = render(volume, maps, counts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["march"] == marches
    monkeypatch.setattr(raymarch, "march", raymarch.march_plain)
    monkeypatch.setattr(raymarch, "march_rows", raymarch.march_rows_plain)
    monkeypatch.setattr(raymarch, "march_grid", raymarch.march_grid_plain)
    kernels.reset_launch_counts()
    want = render(volume, maps, counts)
    assert kernels.launch_counts()["march"] == 0
    for field in ("hit", "depth", "color", "num_samples", "overflow"):
        assert torch.equal(getattr(out, field), getattr(want, field)), field
    assert int(out.hit.sum()) > 50


# ---- the pull-push fill ----------------------------------------------------

# (H, W), num_lods, kind (tests/holefill_cases.py): the render's 1280x720 at
# 7 LODs, odd sizes, alpha <= 0 everywhere, alpha > 0 everywhere, a pyramid
# that stops at 6 levels (37 -> 1 rows: 5 pull steps), at 2 levels, and of
# LOD 0 alone; an odd number of pull steps by num_lods (81x97 at 6); the
# small shapes whose one pull tile straddles every edge
FILL_CASES = [((720, 1280), 7, "mixed"), ((81, 97), 7, "mixed"),
              ((81, 97), 7, "invalid"), ((81, 97), 7, "valid"),
              ((720, 1280), 7, "invalid"), ((53, 40), 5, "mixed"),
              ((37, 150), 7, "mixed"), ((2, 3), 7, "mixed"),
              ((1, 5), 7, "mixed"), ((81, 97), 6, "mixed"),
              ((2, 2), 7, "mixed"), ((3, 5), 7, "mixed"),
              ((5, 3), 7, "mixed")]
FILL_COLOR_ATOL = 1e-6


def _fill_inputs(shape, kind, device, seed=23):
    return [torch.from_numpy(p).to(device)
            for p in fill_planes(seed, *shape, kind)]


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lods,kind", FILL_CASES)
def test_holefill_pull_kernel_bit_exact(cuda, shape, lods, kind):
    """Each pull level of csrc/holefill.cu bit-equal to _pull_planar on
    the card, along the kernel's own chain (two levels a launch, the last
    alone when the steps are odd) and from each of the twin's levels (the
    launch of the next two levels, or of the last one)."""
    from rgbd_recon_tpu_torch.kernels.holefill import pull_cuda

    planes = _fill_inputs(shape, kind, cuda)
    colors, depths = holefill._build_pyramid_planar(planes[:4], planes[4],
                                                    lods)
    n = len(colors)
    kernels.reset_launch_counts()
    chain = pull_cuda(planes, n - 1)
    assert kernels.launch_counts()["holefill_pull"] == holefill.pull_launches(
        n)
    assert len(chain) == n - 1
    for l in range(1, n):
        got = pull_cuda([*colors[l - 1], depths[l - 1]], min(2, n - l))
        torch.cuda.synchronize()
        for k, g in enumerate(got):
            want = [*colors[l + k], depths[l + k]]
            assert g.is_contiguous() and g.shape == (5, *depths[l + k].shape)
            for name, gp, w in zip("rgbad", g, want):
                assert _bits_equal(gp, w), (l, k, name)
        for name, c, w in zip("rgbad", chain[l - 1],
                              [*colors[l], depths[l]]):
            assert _bits_equal(c, w), (l, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lods,kind", FILL_CASES)
def test_holefill_push_kernel(cuda, shape, lods, kind):
    """The push on the twin's pyramid: colours within atol 1e-6 of
    _push_planar (which resamples by cuBLAS products), the chosen level
    bit-equal, the depth passed through."""
    from rgbd_recon_tpu_torch.kernels.holefill import push_cuda

    planes = _fill_inputs(shape, kind, cuda)
    colors, depths = holefill._build_pyramid_planar(planes[:4], planes[4],
                                                    lods)
    levels = [torch.stack(c) for c in colors[1:]]
    got, level = push_cuda(colors[0], levels, return_level=True)
    want, depth = holefill._push_planar(colors, depths)
    _, want_level = holefill._push_level(colors, *shape)
    torch.cuda.synchronize()
    assert depth is depths[0]
    assert torch.equal(level, want_level)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= FILL_COLOR_ATOL
    # level-0 pixels keep their own r, g, b, alpha bits
    keep = level == 0
    for g, p in zip(got, planes[:4]):
        assert torch.equal(g[keep], p[keep])
    if kind == "mixed" and min(shape) > 8:
        assert bool((level >= 2).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lods,kind", FILL_CASES)
def test_holefill_fill_on_the_kernels(cuda, monkeypatch, shape, lods, kind):
    """fill_colors_planar on CUDA tensors: ceil((L - 1) / 2) pull launches
    (two levels each) and one push launch, within atol 1e-6 of
    fill_colors_plain on the card (depth the input itself); the (H, W, 4)
    image's strided views give the bits of contiguous planes; a second
    fill uploads no taps."""
    from rgbd_recon_tpu_torch.kernels import holefill as fill_kernels

    planes = _fill_inputs(shape, kind, cuda)
    n_levels = len(holefill.pyramid_shapes(*shape, lods))
    kernels.reset_launch_counts()
    got, depth = holefill.fill_colors_planar(planes[:4], planes[4], lods)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["holefill_pull"] == -(-(n_levels - 1)
                                                         // 2)
    assert kernels.launch_counts()["holefill_push"] == 1
    want, want_depth = holefill.fill_colors_plain(planes[:4], planes[4],
                                                  lods)
    assert depth is planes[4] and torch.equal(want_depth, planes[4])
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= FILL_COLOR_ATOL

    def no_upload(shapes):
        raise AssertionError(f"taps of {shapes} built again")

    monkeypatch.setattr(fill_kernels, "push_taps", no_upload)
    rgba = torch.stack(planes[:4], dim=-1)
    views = [rgba[..., i] for i in range(4)]
    assert not views[0].is_contiguous()
    again, _ = holefill.fill_colors_planar(views, planes[4], lods)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert _bits_equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("colorfill", [True, False])
def test_render_fills_on_the_kernels(cuda, colorfill):
    """A render on the card fills with the kernels: one pull launch for
    the two levels past LOD 0 (64x48 at 3 LODs) and one push, none
    without colorfill."""
    pipe, volume, maps, counts, cam, _ = _small_scene(cuda,
                                                      colorfill=colorfill)
    render = pipe.make_renderer(cam)
    kernels.reset_launch_counts()
    out = render(volume, maps, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert launched["holefill_pull"] == int(colorfill)
    assert launched["holefill_push"] == int(colorfill)
    assert bool(torch.isfinite(out.color).all())


@pytest.mark.cuda
def test_holefill_fill_back_to_back_and_in_graphs(cuda):
    """50 fills of the render's frame back to back on two inputs in turn,
    then 3 replays of a captured fill after its inputs were overwritten
    with others, each bit-equal to an eager fill of the same inputs."""
    shape, lods = (720, 1280), 7
    inputs = [_fill_inputs(shape, "mixed", cuda, seed=s)
              for s in (23, 24, 25, 26)]
    want = [holefill.fill_colors_planar(p[:4], p[4], lods)[0]
            for p in inputs]
    torch.cuda.synchronize()
    outs = [holefill.fill_colors_planar(inputs[i % 2][:4], inputs[i % 2][4],
                                        lods)[0] for i in range(50)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        for g, w in zip(out, want[i % 2]):
            assert _bits_equal(g, w), i
    static = [p.clone() for p in inputs[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        holefill.fill_colors_planar(static[:4], static[4], lods)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.reset_launch_counts()
    with torch.cuda.graph(graph):
        got, depth = holefill.fill_colors_planar(static[:4], static[4], lods)
    assert depth is static[4]
    assert kernels.launch_counts()["holefill_pull"] == 3
    for k in (1, 2, 3):
        for dst, src in zip(static, inputs[k]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want[k]):
            assert _bits_equal(g, w), k


@pytest.mark.cuda
def test_holefill_pull_refusal_raises(cuda):
    """A launch the card refuses (a grid of more than 65,535 block rows)
    raises; there is no fallback."""
    from rgbd_recon_tpu_torch.kernels.holefill import pull_cuda

    tall = [torch.zeros((1_100_000, 1), device=cuda) for _ in range(5)]
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="holefill_pull"):
        pull_cuda(tall)
    assert kernels.launch_counts()["holefill_pull"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 64), (16, 32), (32, 64)])
def test_holefill_push_refuses_another_tiles_layout(cuda, monkeypatch, tile):
    """The library holds the push's shared-memory layout to its own tile:
    ops/holefill.py's rectangles reserved for another tile raise, with no
    launch, and the next fill of the right layout is as before."""
    from rgbd_recon_tpu_torch.kernels import holefill as fill_kernels

    planes = _fill_inputs((81, 97), "mixed", cuda)
    want, _ = holefill.fill_colors_planar(planes[:4], planes[4], 7)
    colors, _ = holefill._build_pyramid_planar(planes[:4], planes[4], 7)
    levels = [torch.stack(c) for c in colors[1:]]
    layout = holefill.push_layout
    monkeypatch.setattr(fill_kernels, "push_layout",
                        lambda shapes: layout(shapes, tile))
    fill_kernels._plan.cache_clear()
    fill_kernels._fill_plan.cache_clear()
    try:
        kernels.reset_launch_counts()
        with pytest.raises(RuntimeError, match="holefill_push"):
            fill_kernels.push_cuda(colors[0], levels)
        with pytest.raises(RuntimeError, match="holefill"):
            holefill.fill_colors_planar(planes[:4], planes[4], 7)
        assert kernels.launch_counts()["holefill_push"] == 0
    finally:
        monkeypatch.undo()
        fill_kernels._plan.cache_clear()
        fill_kernels._fill_plan.cache_clear()
    got, _ = holefill.fill_colors_planar(planes[:4], planes[4], 7)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


# ---- the hit path ----------------------------------------------------------

# the configurations of the hit kernels' variants (the small scene's
# defaults are the fast config): the oct table with and without the widened
# bracket; the bf16 sentinel table's refine with the clamp floor and its
# nearest gradient; the parity path (f32 raw table, trilinear gradient,
# the calibration volumes' trilinear blend); the volumes' nearest blend;
# bilinear depth/quality taps; f32 oct and sentinel tables; the full-screen
# render without blocks, nearest (refine on the raw volume) and trilinear
# (no refine)
HIT_CONFIGS = {
    "fast": {},
    "oct_no_widen": dict(refine_widen_steps=0.0),
    "no_oct": dict(oct_hit_table=False),
    "parity": dict(march_mode="trilinear", march_empty_skip=False,
                   integrate_taps="bilinear", projection_model=False,
                   march_dtype="float32"),
    "no_proj": dict(projection_model=False),
    "bilinear_taps": dict(integrate_taps="bilinear"),
    "f32_tables": dict(march_dtype="float32"),
    "dense_nearest": dict(ray_compaction=0.0),
    "dense_trilinear": dict(march_mode="trilinear", march_empty_skip=False,
                            projection_model=False, march_dtype="float32",
                            bricking=False, skip_space=False),
}
# the configurations that refine and shade with the oct table
OCT_CONFIGS = ("fast", "oct_no_widen", "no_proj", "bilinear_taps",
               "f32_tables")
# the window depth and shade modes 1 and 2 against the twin; the refined
# positions and mode 0's rgba are bit-equal
HIT_ATOL = 1e-6


def _hit_scene(device, num_sensors=2, **cfg):
    """_small_scene in 20 cm bricks (2 voxels: a brick-aligned volume, so
    the fast config builds its oct table) and a 160x120 camera: (pipeline,
    volume, maps, counts, camera)."""
    from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera

    pipe, volume, maps, counts, _, _ = _small_scene(
        device, brick_size=0.2, num_sensors=num_sensors, **cfg)
    return pipe, volume, maps, counts, ViewCamera(width=160, height=120)


def _shade_args(args, **config):
    """shade_hits' arguments with ``config`` changed."""
    return (dataclasses.replace(args[0], **config),) + tuple(args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("sensors", [1, 3, 4, 5])
@pytest.mark.parametrize("name", sorted(HIT_CONFIGS))
def test_hit_kernels_match_plain(cuda, name, sensors):
    """The refine kernel bit for bit against refine_hits_plain, and the
    shade kernel against shade_hits_plain in shade modes 0, 1 and 2 (mode
    0's rgba bit for bit, the window depth and modes 1-2 within HIT_ATOL,
    alpha bit for bit), on the hits one render records: compacted hit sets
    padded past the live hits, bf16 and f32 tables, 1, 3, 4 and 5
    sensors."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda, shade_cuda
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene(
        cuda, num_sensors=sensors, **HIT_CONFIGS[name])
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    assert ("refine" in calls) == (name != "dense_trilinear")
    assert (calls["shade"][0][13] is not None) == (name in OCT_CONFIGS)
    if "refine" in calls:
        args, kwargs = calls["refine"]
        live = args[4]
        assert 0 < int(live.sum())
        if not name.startswith("dense"):
            assert not bool(live.all())          # padded hit ids
        kernels.reset_launch_counts()
        got = refine_cuda(*args, **kwargs)
        assert kernels.launch_counts()["hit_refine"] == 1
        want = hits.refine_hits_plain(*args, **kwargs)
        assert _bits_equal(got, want)
        if name != "parity":
            # the refine moved hits (the trilinear march's own secant is
            # already the refine's on the raw volume)
            assert bool((want != args[5]).any())
    args, kwargs = calls["shade"]
    for mode in (0, 1, 2):
        margs = _shade_args(args, shade_mode=mode)
        kernels.reset_launch_counts()
        rgba, depth = shade_cuda(**hits.shade_kernel_args(*margs, **kwargs))
        assert kernels.launch_counts()["hit_shade"] == 1
        want_rgba, want_depth = hits.shade_hits_plain(*margs, **kwargs)
        assert rgba.shape == want_rgba.shape
        assert depth.shape == want_depth.shape
        torch.testing.assert_close(depth, want_depth, rtol=0, atol=HIT_ATOL)
        assert _bits_equal(rgba[..., 3], want_rgba[..., 3])
        if mode == 0:
            assert _bits_equal(rgba, want_rgba)
        else:
            torch.testing.assert_close(rgba, want_rgba, rtol=0,
                                       atol=HIT_ATOL)
    if sensors == 4:
        assert bool((want_rgba[..., 3] == 1.0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
def test_hit_kernels_trilinear_taps_with_floor(cuda, table_dtype):
    """The variant no path takes: the central-difference normal with
    trilinear taps clamped by the floor, on the no-oct fast path's
    sentinel table (bf16, and its values in f32); the refine of the same
    table with and without the floor."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda, shade_cuda
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene(cuda, oct_hit_table=False)
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    args, kwargs = calls["refine"]
    kwargs = dict(kwargs, table=kwargs["table"].to(table_dtype))
    assert kwargs["clamp_floor"] is not None
    for floor in (kwargs["clamp_floor"], None):
        kw = dict(kwargs, clamp_floor=floor)
        assert _bits_equal(refine_cuda(*args, **kw),
                           hits.refine_hits_plain(*args, **kw))
    args, kwargs = calls["shade"]
    args = _shade_args(args, march_mode="trilinear")
    args = args[:11] + (args[11].to(table_dtype),) + args[12:]
    rgba, depth = shade_cuda(**hits.shade_kernel_args(*args, **kwargs))
    want_rgba, want_depth = hits.shade_hits_plain(*args, **kwargs)
    assert _bits_equal(rgba, want_rgba)
    torch.testing.assert_close(depth, want_depth, rtol=0, atol=HIT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,refines", [("fast", 1), ("parity", 1),
                                          ("dense_nearest", 1),
                                          ("dense_trilinear", 0)])
def test_render_hits_on_the_kernels(cuda, monkeypatch, name, refines):
    """A render on the card refines with one hit_refine launch (none where
    the full-screen march is trilinear) and shades with one hit_shade
    launch, and equals the same render on the twins: hit mask, step
    counts and overflow bit for bit, window depth within HIT_ATOL; the
    colour without the fill within HIT_ATOL."""
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene(
        cuda, colorfill=False, **HIT_CONFIGS[name])
    render = pipe.make_renderer(cam)
    kernels.reset_launch_counts()
    out = render(volume, maps, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert (launched["hit_refine"], launched["hit_shade"]) == (refines, 1)
    monkeypatch.setattr(hits, "refine_hits", hits.refine_hits_plain)
    monkeypatch.setattr(hits, "shade_hits", hits.shade_hits_plain)
    kernels.reset_launch_counts()
    want = render(volume, maps, counts)
    launched = kernels.launch_counts()
    assert (launched["hit_refine"], launched["hit_shade"]) == (0, 0)
    for field in ("hit", "num_samples", "overflow"):
        assert torch.equal(getattr(out, field), getattr(want, field)), field
    torch.testing.assert_close(out.depth, want.depth, rtol=0, atol=HIT_ATOL)
    torch.testing.assert_close(out.color, want.color, rtol=0, atol=HIT_ATOL)
    assert int(out.hit.sum()) > 50


@pytest.mark.cuda
@pytest.mark.parametrize("config", [dict(shade_mode=3),
                                    dict(blend_mode="best_two"),
                                    dict(debug_skip="grad")])
def test_render_shades_off_the_kernel_by_config(cuda, config):
    """The configurations the shade kernel does not draw (the
    camera-influence view, the normal-weighted blends, the profiling
    switches) shade on the twin on the card: no hit_shade launch; the
    refine still launches."""
    pipe, volume, maps, counts, cam, _ = _small_scene(cuda, **config)
    kernels.reset_launch_counts()
    out = pipe.make_renderer(cam)(volume, maps, counts)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert (launched["hit_refine"], launched["hit_shade"]) == (1, 0)
    assert bool(torch.isfinite(out.color).all())


@pytest.mark.cuda
def test_hit_wrappers_raise_on_the_card(cuda):
    """On CUDA tensors of a wrong type or layout the wrappers raise and
    launch nothing: there is no fallback."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda, shade_cuda
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene(cuda)
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    kernels.reset_launch_counts()
    args, kwargs = calls["refine"]
    with pytest.raises(ValueError, match="float32"):
        refine_cuda(*args[:5], args[5].double(), *args[6:], **kwargs)
    with pytest.raises(ValueError, match="bool"):
        refine_cuda(*args[:4], args[4].to(torch.uint8), *args[5:], **kwargs)
    bad = dataclasses.replace(kwargs["oct"],
                              rows=kwargs["oct"].rows.to(torch.float16))
    with pytest.raises(ValueError, match="table"):
        refine_cuda(*args, **dict(kwargs, oct=bad))
    args, kwargs = calls["shade"]
    shade = hits.shade_kernel_args(*args, **kwargs)
    with pytest.raises(ValueError, match="colour map"):
        shade_cuda(**dict(shade, color=shade["color"].double()))
    with pytest.raises(ValueError, match="shade modes 0-2"):
        shade_cuda(**dict(shade, shade_mode=3))
    with pytest.raises(ValueError, match="oct table"):
        shade_cuda(**dict(shade, oct=None))
    assert kernels.launch_counts()["hit_refine"] == 0
    assert kernels.launch_counts()["hit_shade"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("volume", ["cv_xyz_inv", "cv_uv"])
def test_hit_shade_refuses_unaligned_volumes(cuda, volume):
    """The shade reads a calibration-volume tap as one float4 (cv_xyz_inv)
    or float2 (cv_uv) load: a contiguous view one float off 16 (8) bytes
    is refused with ValueError and launches nothing; the same values in an
    aligned copy shade as the twin."""
    from rgbd_recon_tpu_torch.kernels.hits import shade_cuda
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume_, maps, counts, cam = _hit_scene(cuda,
                                                  **HIT_CONFIGS["parity"])
    render = pipe.make_renderer(cam)
    args, kwargs = record_hits(lambda: render(volume_, maps, counts))["shade"]
    shade = hits.shade_kernel_args(*args, **kwargs)
    assert shade["blend"] == "volume"
    off = _offset_copy(shade[volume], 1)
    assert off.is_contiguous() and off.data_ptr() % 8 == 4
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        shade_cuda(**dict(shade, **{volume: off}))
    assert kernels.launch_counts()["hit_shade"] == 0
    rgba, _ = shade_cuda(**dict(shade, **{volume: off.clone()}))
    want, _ = hits.shade_hits_plain(*args, **kwargs)
    assert _bits_equal(rgba, want)


# ---- the preprocess chain's passes (csrc/preprocess.cu) -------------------

# (sensors, depth h, w, colour h, w): the reference's 4 x 424 x 512 with a
# 1080 x 1280 colour frame, and odd sides that leave partial blocks
PRE_SHAPES = [(4, 424, 512, 1080, 1280), (3, 37, 53, 41, 67)]


def _pre_inputs(shape, device, seed=31):
    """One seeded frame of tests/preprocess_cases.py on ``device``: ({name:
    tensor}, PixelModels, a cv_uv stand-in of CV_DEPTH planes)."""
    from rgbd_recon_tpu_torch.calib.sensors import PixelModels

    n = shape[0]
    inp = {k: torch.from_numpy(v).to(device)
           for k, v in preprocess_cases.chain_inputs(seed, *shape).items()}
    pm = PixelModels(**{k: inp[k]
                        for k in preprocess_cases.PIXEL_MODEL_FIELDS})
    cv_uv = torch.zeros((n, preprocess_cases.CV_DEPTH, 2, 2, 2),
                        device=device)
    return inp, pm, cv_uv


def _pre_case(fn, shape, seed, device):
    return torch.from_numpy(fn(seed, *shape[:3])).to(device)


def _all_bits_equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(_bits_equal(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("shape", PRE_SHAPES)
def test_preprocess_kernels_match_twins(cuda, shape, on):
    """Each kernel of csrc/preprocess.cu bit-equal to its twin on the card,
    on the chain's own maps and on the seeded edge cases (degenerate
    depths, culled and invalidated pixels, confidences at 0.65), with the
    bilateral filter and the refine on and off."""
    from rgbd_recon_tpu_torch.kernels import preprocess as kp
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    inp, pm, cv_uv = _pre_inputs(shape, cuda)
    n = shape[0]
    limits, box = inp["depth_limits"], (inp["bbox_min"], inp["bbox_max"])
    kernels.reset_launch_counts()
    d_m = pre.morph_dilate_plain(inp["depths"])
    assert _bits_equal(kp.morph_cuda(inp["depths"]), d_m)
    near, far = limits[:, 0].view(n, 1, 1), limits[:, 1].view(n, 1, 1)
    z_far = 1.0 - 0.5 / preprocess_cases.CV_DEPTH
    # colours of 8-bit values (x 255) reach both pow branches of the LAB
    # conversion, which [0, 1] colours (divided by 255 again) never do
    for dn, colors in (
            ((d_m - near) / (far - near), inp["colors"]),
            (_pre_case(preprocess_cases.depth_norm_cases, shape, 1, cuda),
             inp["colors"]),
            ((d_m - near) / (far - near), inp["colors"] * 255.0)):
        want = pre.lab_colors_plain(colors, dn, pm, cv_uv)
        assert _bits_equal(kp.lab_cuda(colors, dn, pm, z_far), want)
    lab = pre.lab_colors_plain(inp["colors"], (d_m - near) / (far - near),
                               pm, cv_uv)
    sums = stencil13.bilateral13(d_m, limits) if on else None
    d2 = pre.bilateral_lab_plain(d_m, *box, limits, sums, pm)
    assert _bits_equal(kp.depth2_cuda(d_m, *box, limits, sums, pm), d2)
    for d2_in, lab_in in ((d2, lab), (
            _pre_case(preprocess_cases.depth2_cases, shape, 2, cuda),
            _pre_case(preprocess_cases.lab_cases, shape, 3, cuda))):
        want = pre.boundary_plain(d2_in, lab_in, on)
        assert _all_bits_equal(kp.boundary_cuda(d2_in, lab_in, on), want)
    d2b, _ = pre.boundary_plain(d2, lab, on)
    d2s = _pre_case(preprocess_cases.depth2_cases, shape, 4, cuda)
    for d2_in in (d2b, d2s):
        assert _bits_equal(kp.normals_cuda(d2_in, pm),
                           pre.normals_plain(d2_in, pm))
    nrm = pre.normals_plain(d2b, pm)
    cams = inp["camera_positions"]
    q_sums = stencil13.quality13(d2b[..., 0].contiguous())
    syn = tuple(torch.from_numpy(s).to(cuda) for s in
                preprocess_cases.quality_sums(5, *shape[:3]))
    nrm_s = _pre_case(preprocess_cases.normal_cases, shape, 6, cuda)
    for args in ((d2b, nrm, cams, q_sums, pm), (d2s, nrm_s, cams, syn, pm)):
        assert _bits_equal(kp.quality_cuda(*args), pre.quality_plain(*args))
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert {k: launched[k] for k in ("morph", "lab", "depth2", "boundary",
                                     "normals", "quality")} == {
        "morph": 1, "lab": 3, "depth2": 1, "boundary": 2, "normals": 2,
        "quality": 2}


def _offset_copy(x, floats):
    """A contiguous copy of ``x`` that starts ``floats`` entries into its
    storage (off the 8- and 16-byte boundaries of the kernels' vector
    loads)."""
    buf = torch.empty(x.numel() + floats, dtype=x.dtype, device=x.device)
    view = buf[floats:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("shape", kernel_inputs.BOUNDARY_SHAPES)
def test_preprocess_boundary_kernel_at_odd_tiles(cuda, shape, refine):
    """The boundary kernel bit-equal to boundary_plain on maps with invalid
    pixels along every edge and a reliable left half (tiles that read no
    colour; bench/kernel_inputs.py boundary_maps), on the edge cases of
    tests/preprocess_cases.py, and on inputs that start off the vector
    loads' boundaries (the scalar staging)."""
    from rgbd_recon_tpu_torch.kernels import preprocess as kp
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    n, h, w = shape
    maps = [kernel_inputs.boundary_maps(torch, shape, 7, cuda),
            tuple(torch.from_numpy(x).to(cuda) for x in (
                preprocess_cases.depth2_cases(2, n, h, w),
                preprocess_cases.lab_cases(8, n, h, w)))]
    kernels.reset_launch_counts()
    for d2, lab in maps:
        want = pre.boundary_plain(d2, lab, refine)
        assert _all_bits_equal(kp.boundary_cuda(d2, lab, refine), want)
        for off in (1, 2, 3):
            got = kp.boundary_cuda(_offset_copy(d2, off % 2 + 1),
                                   _offset_copy(lab, off), refine)
            assert _all_bits_equal(got, want), off
    torch.cuda.synchronize()
    assert kernels.launch_counts()["boundary"] == 8


# (sensors, h, w, storage offset in floats, the vector path): W = 512 and
# other multiples of 4 (float4 staging and stores), odd widths and a view 4
# bytes into its storage (the scalar path)
MORPH_MAPS = [(1, 424, 512, 0, True), (2, 9, 4, 0, True),
              (1, 17, 132, 0, True), (2, 7, 3, 0, False),
              (1, 11, 5, 0, False), (1, 9, 513, 0, False),
              (1, 1, 1, 0, False), (2, 9, 512, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,offset,vector", MORPH_MAPS)
def test_preprocess_morph_kernel_on_crafted_maps(cuda, n, h, w, offset,
                                                 vector):
    """The morph kernel bit-equal to morph_dilate_plain on the card on
    tests/preprocess_cases.py's crafted maps (all valid, none valid,
    isolated holes, one valid pixel in a hole, depths at and around 0.5 and
    4.5, NaN and +-inf, taps on either side of 0.2 from the first-pass mean,
    the chain's frame): the vector path where W % 4 == 0 and the map is
    16-byte aligned, else the scalar path; one launch a call."""
    from rgbd_recon_tpu_torch.kernels import preprocess as kp
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    cases = preprocess_cases.morph_cases(9, n, h, w)
    kernels.reset_launch_counts()
    for name, depth in cases.items():
        d = torch.from_numpy(depth).to(cuda)
        if offset:
            d = _offset_copy(d, offset)
            assert d.data_ptr() % 16 == 4 * offset
        assert kp.morph_plan(d)["vector"] == vector
        assert _bits_equal(kp.morph_cuda(d), pre.morph_dilate_plain(d)), name
    torch.cuda.synchronize()
    assert kernels.launch_counts()["morph"] == len(cases)


_PRE_PASSES = ("morph_dilate", "lab_colors", "bilateral_lab", "boundary",
               "normals", "quality")


@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("pixel", [True, False])
def test_preprocess_frames_on_the_kernels(cuda, monkeypatch, on, pixel):
    """The whole chain on the card at the reference's shape against the
    chain of twins on the card, field by field, bit for bit: with the pixel
    models every pass launches once (morph only when on); through the
    calibration volumes the four passes that read them run their twins
    (launched 0 times) and morph and boundary still launch."""
    from rgbd_recon_tpu_torch.ops import preprocess as pre

    shape = PRE_SHAPES[0]
    n = shape[0]
    inp, pm, cv_uv = _pre_inputs(shape, cuda)
    rng = np.random.default_rng(7)
    cv_xyz = torch.from_numpy(rng.uniform(-1.2, 2.4, (
        n, preprocess_cases.CV_DEPTH, 12, 16, 3)).astype(np.float32)).to(cuda)
    cv_uv = torch.from_numpy(rng.uniform(-0.05, 1.05, (
        n, preprocess_cases.CV_DEPTH, 12, 16, 2)).astype(np.float32)).to(cuda)

    def run():
        return pre.preprocess_frames(
            inp["depths"], inp["colors"], cv_xyz, cv_uv, inp["bbox_min"],
            inp["bbox_max"], inp["depth_limits"], inp["camera_positions"],
            morph=on, bilateral=on, refine=on,
            pixel_models=pm if pixel else None)

    kernels.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    calib = int(pixel)
    assert {k: launched[k] for k in ("morph", "bilateral13", "lab", "depth2",
                                     "boundary", "normals", "quality13",
                                     "quality")} == {
        "morph": int(on), "bilateral13": int(on), "lab": calib,
        "depth2": calib, "boundary": 1, "normals": calib, "quality13": 1,
        "quality": calib}
    for name in _PRE_PASSES:
        monkeypatch.setattr(pre, name, getattr(pre, name + "_plain"))
    want = run()
    for field in ("depth", "lab", "silhouette", "normal", "quality",
                  "raw_depth"):
        assert _bits_equal(getattr(got, field), getattr(want, field)), field
    assert bool((got.depth[..., 0] > 0.0).any())


@pytest.mark.cuda
def test_fuse_launches_each_preprocess_kernel_once(cuda):
    """A fuse of the small scene on the card launches morph and boundary
    once, and the four calibration passes once when the pixel models fit
    (0 times through the volumes)."""
    pipe, volume, maps, counts, cam, frames = _small_scene(cuda)
    pm = pipe._get_pixel_models(frames.depths.shape[1:3])
    kernels.reset_launch_counts()
    pipe.fuse(frames)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    calib = int(pm is not None)
    assert {k: launched[k] for k in ("morph", "lab", "depth2", "boundary",
                                     "normals", "quality")} == {
        "morph": 1, "lab": calib, "depth2": calib, "boundary": 1,
        "normals": calib, "quality": calib}


@pytest.mark.cuda
def test_preprocess_wrappers_raise_on_the_card(cuda):
    """On CUDA tensors of a wrong type, shape or layout the wrappers raise
    and launch nothing; a launch the card refuses (more sensors than a
    grid's z side) raises too: there is no fallback."""
    from rgbd_recon_tpu_torch.kernels import preprocess as kp

    shape = PRE_SHAPES[1]
    inp, pm, _ = _pre_inputs(shape, cuda)
    d2 = _pre_case(preprocess_cases.depth2_cases, shape, 2, cuda)
    lab = _pre_case(preprocess_cases.lab_cases, shape, 3, cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        kp.morph_cuda(inp["depths"].double())
    with pytest.raises(ValueError, match="contiguous"):
        kp.morph_cuda(inp["depths"].transpose(1, 2))
    with pytest.raises(ValueError, match="lab"):
        kp.boundary_cuda(d2, lab[..., :2].contiguous())
    with pytest.raises(ValueError, match="ray_a"):
        kp.normals_cuda(d2, dataclasses.replace(pm, ray_a=pm.ray_a[:1]))
    with pytest.raises(ValueError, match="bf_sums"):
        kp.depth2_cuda(inp["depths"], inp["bbox_min"], inp["bbox_max"],
                       inp["depth_limits"], (inp["depths"],), pm)
    assert all(v == 0 for v in kernels.launch_counts().values())
    with pytest.raises(RuntimeError, match="morph"):
        kp.morph_cuda(torch.zeros((70_000, 1, 1), device=cuda))
    assert kernels.launch_counts()["morph"] == 0


# ---- the render's block stages ------------------------------------------

# the block path's configurations on the small scene (render_stage_scene):
# the fast path, the parity path, per-block brackets, the chunked first
# march (phase 1 on its twin), and a close-up camera that overflows the
# block list (2,048 slots), a tail stage's list and the hit list
RENDER_STAGE_CONFIGS = {
    "fast": {},
    "parity": dict(march_mode="trilinear", march_empty_skip=False,
                   integrate_taps="bilinear", projection_model=False,
                   march_dtype="float32"),
    "bracket_per_block": dict(bracket_per_block=True),
    "march_chunk": dict(march_chunk=8),
    "overflow": dict(ray_compaction=0.01, march_phase1_steps=5,
                     hit_compaction=0.05),
}
# each config's launches a render of the stage kernels
RENDER_STAGE_LAUNCHES = {
    "fast": dict(scan=1, block_setup=1, compact=4, bracket=1, hit_gather=1,
                 compose=1, march=4),
    "parity": dict(scan=1, block_setup=1, compact=2, bracket=1,
                   hit_gather=1, compose=1, march=2),
    "march_chunk": dict(scan=1, block_setup=1, compact=4, bracket=1,
                        hit_gather=1, compose=1, march=3),
}
RENDER_STAGE_LAUNCHES["bracket_per_block"] = RENDER_STAGE_LAUNCHES["fast"]
RENDER_STAGE_LAUNCHES["overflow"] = RENDER_STAGE_LAUNCHES["fast"]


def render_stage_scene(device, name):
    """(pipeline, render function, baked state, the render_from_baked
    arguments after the bake) of a config of RENDER_STAGE_CONFIGS on the
    small scene in 20 cm bricks: a 160x120 camera, or for "overflow" a
    256x192 close-up (3,072 blocks)."""
    from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera

    pipe, volume, maps, counts, _, _ = _small_scene(
        device, brick_size=0.2, num_sensors=4,
        **RENDER_STAGE_CONFIGS[name])
    cam = (ViewCamera(width=256, height=192, eye=(0.0, 1.15, 1.35),
                      target=(0.0, 1.1, 0.0)) if name == "overflow"
           else ViewCamera(width=160, height=120))
    render, cam0 = pipe.make_render_fn(cam)
    baked = render.bake(volume, counts)
    args = (baked, maps, cam0, pipe._get_projection_models(), pipe._limit)
    return pipe, render, args


def _render_stage_launches():
    names = ("scan", "block_setup", "compact", "bracket", "hit_gather",
             "compose", "march")
    return {k: kernels.launch_counts()[k] for k in names}


@pytest.mark.cuda
@pytest.mark.parametrize("bit", [0, 1, 7])
@pytest.mark.parametrize("p", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("n", [0, 1, 9, 2047, 2048, 2049, 4096, 8191, 8192,
                               8193, 57_600, 184_320, 1_658_880, 8_294_400])
def test_render_stage_compact_kernel(cuda, n, p, bit):
    """The compaction kernel against compact_plain on the card, bit for
    bit: the list (ascending, padded with n), the count, the slot map, at
    capacities under, at and over the count and 0, across its 2,048-flag
    tiles, up to a 4K camera's 8,294,400 pixels, none, some and all flags
    set; other bits of the flags ignored."""
    from rgbd_recon_tpu_torch.kernels.compact import compact_cuda
    from rgbd_recon_tpu_torch.ops.compact import compact_plain

    g = torch.Generator(cuda).manual_seed(n + int(p * 100) + bit)
    flags = torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda,
                          generator=g)
    on = torch.rand(n, device=cuda, generator=g) < p
    flags = torch.where(on, flags | (1 << bit), flags & (255 - (1 << bit)))
    k = int(on.sum())
    for cap in sorted({0, 1, max(k - 1, 0), k, k + 3, n, 11_520}):
        kc = torch.full((3,), -5, dtype=torch.int32, device=cuda)
        kp = torch.full((3,), -5, dtype=torch.int32, device=cuda)
        before = kernels.LAUNCHES["compact"]
        got = compact_cuda(flags, bit, cap, kc, 2, want_slot=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["compact"] == before + 1
        want = compact_plain(flags, bit, cap, kp, 2, want_slot=True)
        assert all_bits_equal(got, want), cap
        assert kc.tolist() == kp.tolist() == [-5, -5, k], cap
        ids, _ = compact_cuda(flags, bit, cap, kc, 0)
        assert bits_equal(ids, want[0]), cap


@pytest.mark.cuda
def test_render_stage_compact_back_to_back(cuda):
    """50 compactions launched back to back on one stream, with no sync
    between them, each bit-equal to compact_plain: the look-back's scratch
    (the ticket, the tile statuses, the done-counter) is left zeroed by
    each launch for the next, whatever its size."""
    from rgbd_recon_tpu_torch.kernels.compact import compact_cuda
    from rgbd_recon_tpu_torch.ops.compact import compact_plain

    sizes = (184_320, 1, 2049, 0, 57_600, 1_658_880, 4096, 9, 2048)
    cases = []
    for i in range(50):
        n = sizes[i % len(sizes)]
        p = (0.0, 0.35, 1.0, 0.02)[i % 4]
        bit = i % 8
        flags = kernel_inputs.synthetic_flags(torch, n, p, bit, 100 + i, cuda)
        cap = (0, 11_520, n, 61_440, 3)[i % 5]
        cases.append((flags, bit, cap, i % 3 != 0))
    torch.cuda.synchronize()
    counts = torch.full((50,), -1, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = [compact_cuda(f, bit, cap, counts, i, want_slot=ws)
           for i, (f, bit, cap, ws) in enumerate(cases)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["compact"] == 50
    want_counts = torch.full((50,), -1, dtype=torch.int32, device=cuda)
    for i, (f, bit, cap, ws) in enumerate(cases):
        want = compact_plain(f, bit, cap, want_counts, i, want_slot=ws)
        assert all_bits_equal(got[i], want), i
    assert torch.equal(counts, want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [184_320, 1_658_880])
def test_render_stage_compact_graph_replay(cuda, n):
    """A compaction captured in a CUDA graph on a side stream (warmed up
    there first, which makes the stream's scratch) and replayed 3 times on
    changed flags (one eager launch between two replays): each replay
    bit-equal to compact_plain on that replay's flags (the list, the
    count, the slot map); the capture counts one launch, the replays
    none."""
    from rgbd_recon_tpu_torch.kernels.compact import compact_cuda
    from rgbd_recon_tpu_torch.ops.compact import compact_plain

    bit, cap = 1, 61_440
    static = kernel_inputs.synthetic_flags(torch, n, 0.35, bit, 7, cuda)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        compact_cuda(static, bit, cap, counts, 1, want_slot=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        ids, slot = compact_cuda(static, bit, cap, counts, 1,
                                 want_slot=True)
    assert kernels.launch_counts()["compact"] == 1
    for i, p in enumerate((0.35, 0.9, 0.01)):
        static.copy_(kernel_inputs.synthetic_flags(torch, n, p, bit, 20 + i,
                                                   cuda))
        graph.replay()
        torch.cuda.synchronize()
        want_counts = torch.zeros(2, dtype=torch.int32, device=cuda)
        want = compact_plain(static, bit, cap, want_counts, 1,
                             want_slot=True)
        assert all_bits_equal((ids, slot), want), i
        assert int(counts[1]) == int(want_counts[1]), i
        if i == 1:
            eager = compact_cuda(static, bit, cap, counts, 0)
            torch.cuda.synchronize()
            assert bits_equal(eager[0], want[0])
            assert int(counts[0]) == int(want_counts[1])
    assert kernels.launch_counts()["compact"] == 2


@pytest.mark.cuda
def test_render_stage_compact_streams(cuda):
    """Compactions queued on two streams at once, 10 each without a sync,
    each bit-equal to compact_plain: each stream has its own look-back
    scratch. A stream that captures a graph before its first compaction
    is refused (its scratch cannot be made inside the capture)."""
    from rgbd_recon_tpu_torch.kernels import compact as kc
    from rgbd_recon_tpu_torch.ops.compact import compact_plain

    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    flags = [kernel_inputs.synthetic_flags(torch, 1_658_880, p, 3, 30 + i,
                                           cuda)
             for i, p in enumerate((0.35, 0.8))]
    counts = torch.full((20,), -1, dtype=torch.int32, device=cuda)
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            got.append(kc.compact_cuda(flags[i % 2], 3, 700_000 + i,
                                       counts, i, want_slot=True))
    torch.cuda.synchronize()
    assert {(cuda.index or 0, st.cuda_stream) for st in streams} <= {
        (d or 0, h) for d, h in kc._SCRATCH}
    want_counts = torch.full((20,), -1, dtype=torch.int32, device=cuda)
    for i in range(20):
        want = compact_plain(flags[i % 2], 3, 700_000 + i, want_counts, i,
                             want_slot=True)
        assert all_bits_equal(got[i], want), i
    assert torch.equal(counts, want_counts)
    fresh = torch.cuda.Stream(cuda)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            kc.compact_cuda(flags[0], 3, 10, counts, 0)
    assert kernels.launch_counts()["compact"] == 0


@pytest.mark.cuda
def test_render_stage_compact_refusals(cuda):
    """The compaction wrapper refuses flags off an 8-byte boundary, of
    another type, a bit past 7 and counts on another device, and launches
    nothing."""
    from rgbd_recon_tpu_torch.kernels.compact import compact_cuda

    flags = torch.ones(100, dtype=torch.uint8, device=cuda)
    counts = torch.zeros(1, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="boundary"):
        compact_cuda(flags[3:], 0, 8, counts, 0)
    with pytest.raises(ValueError, match="uint8"):
        compact_cuda(flags.bool(), 0, 8, counts, 0)
    with pytest.raises(ValueError, match="bit"):
        compact_cuda(flags, 8, 8, counts, 0)
    with pytest.raises(ValueError, match="counts"):
        compact_cuda(flags, 0, 8, counts.cpu(), 0)
    assert kernels.launch_counts()["compact"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RENDER_STAGE_CONFIGS))
def test_render_stage_kernels_match_twins(cuda, name):
    """Each stage kernel (the compaction, the scan, the block set-up, the
    coarse and the row marches, the bracket, the hit gather, the compose)
    on the inputs one render on the card hands it, bit for bit against its
    plain twin on the same inputs: every output and every array it updates
    in place."""
    _, render, args = render_stage_scene(cuda, name)
    calls = record_stages(lambda: render.render_from_baked(*args))
    stages = set()
    for stage, a, kw, _ in calls:
        got, got_after = replay(stage, a, kw, plain=False)
        want, want_after = replay(stage, a, kw, plain=True)
        torch.cuda.synchronize()
        assert all_bits_equal(got, want), stage
        assert all_bits_equal(got_after, want_after), stage
        stages.add(stage)
    assert stages == set(STAGES)


def _scan_call(device):
    """The first four arguments (g, occ, bsafe, cam) of the scan call of
    the fast config's render on the small scene."""
    _, render, args = render_stage_scene(device, "fast")
    calls = record_stages(lambda: render.render_from_baked(*args))
    (scan,) = [c for c in calls if c[0] == "scan"]
    return scan[1][:4]


def _scan_both(g, occ, bsafe, cam, slot=4):
    """(kernel scan5, its counts, twin scan5, its counts) on the inputs."""
    from rgbd_recon_tpu_torch.kernels.render_stages import scan_cuda
    from rgbd_recon_tpu_torch.ops.render_stages import scan_plain

    dev = occ.device
    kc = torch.full((5,), -1, dtype=torch.int32, device=dev)
    kp = torch.full((5,), -1, dtype=torch.int32, device=dev)
    got = scan_cuda(g, occ, bsafe, cam, kc, slot)
    want = scan_plain(g, occ, bsafe, cam, kp, slot)
    torch.cuda.synchronize()
    return got, kc, want, kp


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCAN_CASES)
def test_render_stage_scan_crafted_cases(cuda, name):
    """The scan kernel bit for bit against scan_plain on the card (all five
    planes, NaNs included, and the surface-brick count) on the crafted
    changes of a recorded call (tests/scan_cases.py): no surface brick,
    every brick a surface brick, an eye inside the box, directions without
    an x component with the eye inside the x slab and on its face."""
    case = scan_case(*_scan_call(cuda), name)
    kernels.reset_launch_counts()
    got, kc, want, kp = _scan_both(*case)
    assert kernels.launch_counts()["scan"] == 1
    assert bits_equal(got, want)
    assert torch.equal(kc, kp)
    if name == "axis_parallel_on_face":
        assert bool(torch.isnan(want[3]).all())


# brick grids of the scan: the small scene's (staged), 64,000 bricks (a
# staged table past 48 KB), 125,000 (past the shared table: the codes
# from global memory); occ and bsafe at storage offsets 0 or 1 (scalar
# staging)
SCAN_GRIDS = [((30, 30, 30), 0), ((40, 40, 40), 0), ((50, 50, 50), 0),
              ((40, 40, 40), 1), ((50, 50, 50), 1), (None, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", SCAN_GRIDS)
def test_render_stage_scan_grids_and_layouts(cuda, shape, offset):
    """The scan kernel bit for bit against scan_plain on seeded brick grids
    of 27,000 to 125,000 bricks (staged in shared memory up to the
    kernel's table, read from global memory past it: the launch plan says
    which) and on occ / bsafe views one element off their storage's
    start; its grid of at most two blocks an SM."""
    from rgbd_recon_tpu_torch.kernels.render_stages import scan_plan

    g, occ, bsafe, cam = _scan_call(cuda)
    if shape is not None:
        gen = torch.Generator(cuda).manual_seed(sum(shape))
        occ = torch.rand(shape, device=cuda, generator=gen) < 0.03
        bsafe = torch.where(
            torch.rand(shape, device=cuda, generator=gen) < 0.3, 0.0,
            torch.rand(shape, device=cuda, generator=gen) * 4.0)
        g = dataclasses.replace(g, vol_shape=tuple(n * g.brick_vox
                                                   for n in shape))
    if offset:
        occ, bsafe = _offset_copy(occ, offset), _offset_copy(bsafe, offset)
        assert occ.is_contiguous() and occ.data_ptr() % 16 == offset
    plan = scan_plan(g, occ.shape, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan["staged"] == (occ.numel() <= 98_304)
    assert 1 <= plan["blocks"] <= 2 * sms
    got, kc, want, kp = _scan_both(g, occ, bsafe, cam)
    assert bits_equal(got, want)
    assert torch.equal(kc, kp)
    assert bool(torch.isfinite(want[0]).any())


@pytest.mark.cuda
def test_render_stage_scan_back_to_back_and_in_graphs(cuda):
    """50 scans launched back to back with no sync between them, each
    bit-equal to scan_plain on its inputs; then a scan captured in a CUDA
    graph on a side stream and replayed 3 times on changed inputs (grid
    and camera copied into the captured tensors), each replay bit-equal to
    an eager scan of the same inputs."""
    from rgbd_recon_tpu_torch.kernels.render_stages import scan_cuda
    from rgbd_recon_tpu_torch.ops.render_stages import scan_plain

    base = _scan_call(cuda)
    cases = [scan_case(*base, SCAN_CASES[i % len(SCAN_CASES)])
             for i in range(50)]
    counts = [torch.full((5,), -1, dtype=torch.int32, device=cuda)
              for _ in range(50)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = [scan_cuda(*c, counts[i], i % 5) for i, c in enumerate(cases)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["scan"] == 50
    for i, c in enumerate(cases):
        want_counts = torch.full((5,), -1, dtype=torch.int32, device=cuda)
        want = scan_plain(*c, want_counts, i % 5)
        assert bits_equal(got[i], want), i
        assert torch.equal(counts[i], want_counts), i
    # the graph
    g, occ, bsafe, cam = base
    static = scan_case(g, occ.clone(), bsafe.clone(), cam, "recorded")
    _, s_occ, s_bsafe, s_cam = static
    s_counts = torch.zeros(5, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        scan_cuda(*static, s_counts, 4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = scan_cuda(*static, s_counts, 4)
    for name in ("every_brick_surface", "eye_inside_box", "axis_parallel"):
        _, c_occ, c_bsafe, c_cam = scan_case(*base, name)
        s_occ.copy_(c_occ)
        s_bsafe.copy_(c_bsafe)
        s_cam.eye_vol.copy_(c_cam.eye_vol)
        s_cam.rot.copy_(c_cam.rot)
        graph.replay()
        torch.cuda.synchronize()
        e_counts = torch.zeros(5, dtype=torch.int32, device=cuda)
        eager = scan_cuda(g, c_occ, c_bsafe, c_cam, e_counts, 4)
        torch.cuda.synchronize()
        assert bits_equal(out, eager), name
        assert torch.equal(s_counts, e_counts), name


# (ds, block slots): 1, 4, 9, 16 and 64 rays a block, slot counts that are
# no multiple of a thread block's slots (256 / B2, at most 64)
BRACKET_GEOMETRIES = [(1, 1), (1, 65), (1, 130), (2, 15), (2, 17), (2, 70),
                      (3, 29), (4, 1), (4, 17), (4, 33), (4, 122), (8, 3),
                      (8, 5), (8, 122)]


@pytest.mark.cuda
@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("ds,capB", BRACKET_GEOMETRIES)
def test_render_stage_bracket_geometries(cuda, ds, capB, per_block):
    """The bracket kernel bit for bit against bracket_plain on the card on
    tests/bracket_cases.py's grids (NaNs, signed zeros, infinities, at
    their edges and corners too; padding slots) at ds 1, 2, 3, 4 and 8 and
    block slot counts that leave a thread block part full; its launch plan
    (ds x ds x slots threads, ceil(capB / slots) blocks, 32 bytes of rows a
    thread and 160 a slot of shared memory)."""
    from rgbd_recon_tpu_torch.kernels.render_stages import (
        bracket_cuda,
        bracket_plan,
    )
    from rgbd_recon_tpu_torch.ops.render_stages import bracket_plain

    kernels.reset_launch_counts()
    for seed in (1, 2):
        args = bracket_cases.bracket_case(seed, ds, capB, cuda,
                                          per_block=per_block)
        got = bracket_cuda(*args)
        want = bracket_plain(*args)
        torch.cuda.synchronize()
        assert bits_equal(got, want), seed
    slots = min(max(256 // (ds * ds), 1), 64)
    assert bracket_plan(args[0], capB) == dict(
        blocks=-(-capB // slots), threads=(ds, ds, slots),
        shared_bytes=ds * ds * slots * 32 + slots * (16 + 33 * 4 + 12))
    assert kernels.launch_counts()["bracket"] == 2


@pytest.mark.cuda
def test_render_stage_bracket_refusals(cuda):
    """ds = 33 (1,089 rays a block, past a 1,024-thread block) is refused
    with ValueError, before any launch."""
    from rgbd_recon_tpu_torch.kernels.render_stages import bracket_cuda

    args = bracket_cases.bracket_case(1, 33, 4, cuda, Hb=2, Wb=3)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="at most 1024"):
        bracket_cuda(*args)
    assert kernels.launch_counts()["bracket"] == 0


@pytest.mark.cuda
def test_render_stage_bracket_back_to_back_and_in_graphs(cuda):
    """50 brackets launched back to back with no sync between them (the
    fast config's recorded call and seeded grids), each bit-equal to
    bracket_plain on its inputs; then a bracket captured in a CUDA graph on
    a side stream and replayed 3 times on changed grids, block rows,
    interval ends, flags and block lists (copied into the captured
    tensors), each replay bit-equal to an eager bracket of the same
    inputs."""
    from rgbd_recon_tpu_torch.kernels.render_stages import bracket_cuda
    from rgbd_recon_tpu_torch.ops.render_stages import bracket_plain

    _, render, args = render_stage_scene(cuda, "fast")
    calls = record_stages(lambda: render.render_from_baked(*args))
    (rec,) = [c[1] for c in calls if c[0] == "bracket"]
    cases = [tuple(c.clone() if isinstance(c, torch.Tensor) else c
                   for c in rec) if i % 5 == 0 else
             bracket_cases.bracket_case(i, 4, 40 + i, cuda,
                                        per_block=i % 2 == 1)
             for i in range(50)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = [bracket_cuda(*c) for c in cases]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bracket"] == 50
    for i, c in enumerate(cases):
        assert bits_equal(got[i], bracket_plain(*c)), i
    # the graph: a seeded case's tensors, refilled from three others
    static = bracket_cases.bracket_case(100, 4, 64, cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        bracket_cuda(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = bracket_cuda(*static)
    for seed in (101, 102, 103):
        new = bracket_cases.bracket_case(seed, 4, 64, cuda)
        for k in range(1, 6):
            static[k].copy_(new[k])
        static[6].eye_vol.copy_(new[6].eye_vol)
        static[6].rot.copy_(new[6].rot)
        graph.replay()
        torch.cuda.synchronize()
        eager = bracket_cuda(*new)
        torch.cuda.synchronize()
        assert bits_equal(out, eager), seed
        assert bits_equal(out, bracket_plain(*new)), seed


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RENDER_STAGE_CONFIGS))
def test_render_stage_render_matches_twins(cuda, monkeypatch, name):
    """render_from_baked on the stage kernels against the same render on
    the stage twins (on the card): hit mask, window depth, march steps,
    the overflow vector, the pre-fill rgba planes and the colour bit for
    bit; each stage kernel launched as RENDER_STAGE_LAUNCHES says, the
    twins none. The overflow case drops blocks, tail rays and hits."""
    from rgbd_recon_tpu_torch.ops import holefill

    _, render, args = render_stage_scene(cuda, name)
    fills = []
    fill = holefill.fill_colors_planar

    def record_fill(planes, depth, lods):
        fills.append([p.clone() for p in planes])
        return fill(planes, depth, lods)

    monkeypatch.setattr(holefill, "fill_colors_planar", record_fill)
    render.render_from_baked(*args)         # warm-up
    kernels.reset_launch_counts()
    got = render.render_from_baked(*args)
    torch.cuda.synchronize()
    assert _render_stage_launches() == RENDER_STAGE_LAUNCHES[name]
    kernels.reset_launch_counts()
    with plain_stages():
        want = render.render_from_baked(*args)
    counts = _render_stage_launches()
    assert all(v == 0 for v in counts.values()), counts
    for f in ("hit", "depth", "num_samples", "overflow", "color"):
        assert bits_equal(getattr(got, f), getattr(want, f)), f
    assert got.overflow.dtype == torch.int32
    for g, w in zip(fills[-2], fills[-1]):
        assert bits_equal(g.contiguous(), w.contiguous())
    assert int(got.hit.sum()) > 50
    ov = got.overflow.tolist()
    if name == "overflow":
        assert ov[0] > 0 and ov[1] > 0 and ov[2] > 0, ov
    else:
        assert ov[0] == 0, ov


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fast", "parity"])
def test_render_stage_no_host_sync(cuda, name):
    """After the bake, render_from_baked makes no host sync: it runs under
    torch.cuda.set_sync_debug_mode("error") (after one warm-up render,
    which uploads the fill's taps once)."""
    _, render, args = render_stage_scene(cuda, name)
    render.render_from_baked(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = render.render_from_baked(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(out.hit.sum()) > 50


# ---- the block set-up's tiles and the refine's rounds of loads -------------

@pytest.mark.cuda
@pytest.mark.parametrize("Hb,Wb,sc,ds", setup_refine_cases.SETUP_GEOMETRIES)
def test_render_stage_block_setup_geometries(cuda, Hb, Wb, sc, ds):
    """The set-up kernel bit for bit against block_setup_plain on the card
    (blk, s_end, flags, grid) on tests/setup_refine_cases.py's planes
    (NaNs, signed zeros and infinities at their edges and corners, and
    planes without them) at the cells' camera, ragged tiles, Hs * sc > Hb
    and scan strides 1 to 5; its launch plan (a 32 x 8 tile of blocks a
    thread block, 20,112 bytes of static shared memory)."""
    from rgbd_recon_tpu_torch.kernels.render_stages import (
        block_setup_cuda,
        block_setup_plan,
    )
    from rgbd_recon_tpu_torch.ops.render_stages import block_setup_plain

    kernels.reset_launch_counts()
    for seed, specials in ((1, True), (2, True), (3, False)):
        g, scan5, cam = setup_refine_cases.setup_case(seed, Hb, Wb, sc, ds,
                                                      cuda, specials)
        got = block_setup_cuda(g, scan5, cam)
        want = block_setup_plain(g, scan5, cam)
        torch.cuda.synchronize()
        assert all_bits_equal(got, want), seed
    assert block_setup_plan(g) == dict(
        blocks=(-(-Wb // 32), -(-Hb // 8)), threads=(32, 8),
        shared_bytes=5 * 10 * 34 * 4 + 5 * 8 * 32 * 4 + 256 * 32)
    assert kernels.launch_counts()["block_setup"] == 3


@pytest.mark.cuda
def test_render_stage_block_setup_refusals(cuda):
    """A scan stride below 1 is refused with ValueError, before any
    launch."""
    from rgbd_recon_tpu_torch.kernels.render_stages import block_setup_cuda

    g = setup_refine_cases.geometry(9, 13, 0, 4)
    cam = setup_refine_cases.camera(1, cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="scan stride"):
        block_setup_cuda(g, torch.zeros((5, 5, 7), device=cuda), cam)
    assert kernels.launch_counts()["block_setup"] == 0


@pytest.mark.cuda
def test_render_stage_block_setup_back_to_back_and_in_graphs(cuda):
    """50 set-ups launched back to back with no sync between them (the
    fast config's recorded call and seeded planes at three geometries),
    each bit-equal to block_setup_plain on its inputs; then a set-up
    captured in a CUDA graph on a side stream and replayed 3 times on
    changed planes and cameras (copied into the captured tensors), each
    replay bit-equal to an eager set-up of the same inputs."""
    from rgbd_recon_tpu_torch.kernels.render_stages import block_setup_cuda
    from rgbd_recon_tpu_torch.ops.render_stages import block_setup_plain

    _, render, args = render_stage_scene(cuda, "fast")
    calls = record_stages(lambda: render.render_from_baked(*args))
    (rec,) = [c[1] for c in calls if c[0] == "block_setup"]
    geoms = setup_refine_cases.SETUP_GEOMETRIES
    cases = [(rec[0], rec[1].clone(), rec[2]) if i % 5 == 0 else
             setup_refine_cases.setup_case(i, *geoms[i % 3], cuda,
                                           specials=i % 2 == 1)
             for i in range(50)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = [block_setup_cuda(*c) for c in cases]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_setup"] == 50
    for i, c in enumerate(cases):
        assert all_bits_equal(got[i], block_setup_plain(*c)), i
    static = setup_refine_cases.setup_case(100, *geoms[1], cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        block_setup_cuda(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = block_setup_cuda(*static)
    for seed in (101, 102, 103):
        new = setup_refine_cases.setup_case(seed, *geoms[1], cuda,
                                            specials=seed != 102)
        static[1].copy_(new[1])
        static[2].eye_vol.copy_(new[2].eye_vol)
        static[2].rot.copy_(new[2].rot)
        graph.replay()
        torch.cuda.synchronize()
        eager = block_setup_cuda(*new)
        torch.cuda.synchronize()
        assert all_bits_equal(out, eager), seed
        assert all_bits_equal(out, block_setup_plain(*new)), seed


# the hit gather's slots a thread block (csrc/render_stages.cu) and the
# list lengths around it: one slot, a few, a block less one, one, one more,
# a ragged last block, the cells'
GATHER_THREADS = int(re.search(
    r"constexpr int GATHER_THREADS = (\d+);",
    open(os.path.join(REPO, "rgbd_recon_tpu_torch", "csrc",
                      "render_stages.cu")).read())[1])
GATHER_CAPS = (1, 3, 4, 7, 8, GATHER_THREADS - 1, GATHER_THREADS,
               GATHER_THREADS + 1, 1_023, 101_376)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", hit_gather_cases.KINDS)
@pytest.mark.parametrize("capH", GATHER_CAPS)
def test_render_stage_hit_gather_lists(cuda, capH, kind):
    """The hit gather bit for bit against hit_gather_plain on the card
    (hrows, hpos, live) on tests/hit_gather_cases.py's rows (NaN, +-0.0,
    +-inf) for lists with no padding, all padding and some, at list lengths
    around its thread block (a ragged last block), with R 2 capH + 3 rays
    (the cells' 184,320 at 101,376 slots) and R = 1; one launch each, its
    plan a slot a thread."""
    from rgbd_recon_tpu_torch.kernels.render_stages import (
        hit_gather_cuda,
        hit_gather_plan,
    )
    from rgbd_recon_tpu_torch.ops.render_stages import hit_gather_plain

    R = 184_320 if capH == 101_376 else 2 * capH + 3
    kernels.reset_launch_counts()
    for seed, r in ((capH, R), (capH + 1, 1)):
        case = hit_gather_cases.gather_case(seed, capH, r, kind, cuda)
        got = hit_gather_cuda(*case)
        want = hit_gather_plain(*case)
        torch.cuda.synchronize()
        assert all_bits_equal(got, want), (seed, r)
    assert kernels.launch_counts()["hit_gather"] == 2
    assert hit_gather_plan(capH) == dict(
        blocks=-(-capH // GATHER_THREADS), threads=GATHER_THREADS)


@pytest.mark.cuda
def test_render_stage_hit_gather_refuses_unaligned_rows(cuda):
    """A ray8 or st8 that does not start on 16 bytes (its rows are read as
    16-byte words) is refused with ValueError, before any launch; an empty
    list launches nothing."""
    from rgbd_recon_tpu_torch.kernels.render_stages import hit_gather_cuda

    ray8, st8, idx = hit_gather_cases.gather_case(4, 40, 50, "mixed", cuda)
    kernels.reset_launch_counts()
    for off in (1, 2, 3):
        flat = torch.empty(ray8.numel() + off, device=cuda)
        view = flat[off:].view(ray8.shape)
        assert view.data_ptr() % 16 == 4 * off
        view.copy_(ray8)
        with pytest.raises(ValueError, match="ray8 must start on 16 bytes"):
            hit_gather_cuda(view, st8, idx)
        view.copy_(st8)
        with pytest.raises(ValueError, match="st8 must start on 16 bytes"):
            hit_gather_cuda(ray8, view, idx)
    rows, pos, live = hit_gather_cuda(ray8, st8, idx[:0])
    assert rows.shape == (0, 8) and pos.shape == (0, 3) and live.numel() == 0
    assert kernels.launch_counts()["hit_gather"] == 0


@pytest.mark.cuda
def test_render_stage_hit_gather_back_to_back_and_in_graphs(cuda):
    """50 hit gathers launched back to back with no sync between them (the
    fast config's recorded call and seeded lists at the ragged lengths),
    each bit-equal to hit_gather_plain on its inputs; then a gather
    captured in a CUDA graph on a side stream and replayed 3 times on
    changed rows and lists (copied into the captured tensors), each replay
    bit-equal to an eager gather of the same inputs."""
    from rgbd_recon_tpu_torch.kernels.render_stages import hit_gather_cuda
    from rgbd_recon_tpu_torch.ops.render_stages import hit_gather_plain

    _, render, args = render_stage_scene(cuda, "fast")
    calls = record_stages(lambda: render.render_from_baked(*args))
    (rec,) = [c[1] for c in calls if c[0] == "hit_gather"]
    kinds = hit_gather_cases.KINDS
    cases = [tuple(t.clone() for t in rec) if i % 5 == 0 else
             hit_gather_cases.gather_case(
                 i, GATHER_CAPS[i % 9], 2 * GATHER_CAPS[i % 9] + 3,
                 kinds[i % 3], cuda)
             for i in range(50)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = [hit_gather_cuda(*c) for c in cases]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hit_gather"] == 50
    for i, c in enumerate(cases):
        assert all_bits_equal(got[i], hit_gather_plain(*c)), i
    capH, R = 1_023, 2_049
    static = hit_gather_cases.gather_case(100, capH, R, "mixed", cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        hit_gather_cuda(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = hit_gather_cuda(*static)
    for seed, kind in ((101, "live"), (102, "dead"), (103, "mixed")):
        new = hit_gather_cases.gather_case(seed, capH, R, kind, cuda)
        for s, n in zip(static, new):
            s.copy_(n)
        graph.replay()
        torch.cuda.synchronize()
        eager = hit_gather_cuda(*new)
        torch.cuda.synchronize()
        assert all_bits_equal(out, eager), seed
        assert all_bits_equal(out, hit_gather_plain(*new)), seed


def _refine_call(device):
    """The refine call one render of the fast config records (the oct
    table in bf16, the widened bracket; the 8 per-hit inputs are columns
    of the hit rows)."""
    pipe, volume, maps, counts, cam = _hit_scene(device, num_sensors=2)
    render = pipe.make_renderer(cam)
    return record_hits(lambda: render(volume, maps, counts))["refine"]


def _refine_inputs(args, path):
    """The refine's arguments with its 8 per-hit inputs laid out by
    ``path``: "rows" as recorded (column views of the (n, 8) hit rows),
    "separate" (a contiguous tensor each), "offset" (the rows copied into
    an (n, 8) view 4 bytes past 16)."""
    pos0, dn, lo, hi = args[0], args[1], args[2], args[3]
    ins = [*pos0, *dn, lo, hi]
    if path == "separate":
        ins = [x.clone() for x in ins]
    elif path == "offset":
        n = lo.shape[0]
        flat = torch.empty(n * 8 + 4, device=lo.device)
        rows = flat[1:1 + n * 8].view(n, 8)
        rows.copy_(torch.stack(ins, dim=1))
        ins = [rows[:, k] for k in range(8)]
    return (tuple(ins[:3]), tuple(ins[3:6]), ins[6], ins[7]) + tuple(args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 8, 17])
@pytest.mark.parametrize("rows_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("path", ["rows", "separate", "offset"])
def test_hit_refine_input_paths(cuda, path, rows_dtype, K):
    """The refine kernel bit for bit against refine_hits_plain on a
    render's hits, on both input paths (the hit rows' column views take
    the two-float4 row path; separate tensors and rows 4 bytes off 16 the
    strided scalar one), bf16 and f32 oct rows, and K = 3, 8 and 17
    widened samples (one ragged chunk, two whole chunks, five chunks)."""
    from rgbd_recon_tpu_torch.kernels.hits import (
        input_rows,
        refine_cuda,
        refine_plan,
    )
    from rgbd_recon_tpu_torch.ops import hits

    args, kwargs = _refine_call(cuda)
    args = _refine_inputs(args, path)
    ins = [*args[0], *args[1], args[2], args[3]]
    assert (input_rows(ins) != 0) == (path == "rows")
    oct = kwargs["oct"]
    kw = dict(kwargs, oct=dataclasses.replace(oct, rows=oct.rows.to(
        rows_dtype)), widen_samples=K)
    assert kw["widen_steps"] > 0.0
    kernels.reset_launch_counts()
    got = refine_cuda(*args, **kw)
    assert kernels.launch_counts()["hit_refine"] == 1
    want = hits.refine_hits_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    assert bool((want != args[5]).any())
    n = args[4].shape[0]
    assert refine_plan(n) == dict(blocks=-(-n // 128), threads=128, lanes=1,
                                  chunk=4)


@pytest.mark.cuda
def test_hit_refine_back_to_back_and_in_graphs(cuda):
    """50 refines launched back to back with no sync between them (the
    recorded call on the row path and the scalar path, at K = 8 and 17 in
    turn), each bit-equal to refine_hits_plain on its inputs; then a refine
    captured in a CUDA graph and replayed 3 times on changed hit rows and
    live masks (copied into the captured tensors), each replay bit-equal to
    an eager refine of the same inputs."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda
    from rgbd_recon_tpu_torch.ops import hits

    args, kwargs = _refine_call(cuda)
    rng = np.random.default_rng(5)
    cases = []
    for i in range(50):
        a = _refine_inputs(args, ("rows", "separate")[i % 2])
        if i % 3:
            live = torch.from_numpy(rng.random(a[4].shape[0]) < 0.7)
            a = a[:4] + (a[4] & live.to(cuda),) + a[5:]
        cases.append((a, dict(kwargs, widen_samples=(8, 17)[i % 4 == 3])))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = [refine_cuda(*a, **kw) for a, kw in cases]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hit_refine"] == 50
    for i, (a, kw) in enumerate(cases):
        assert _bits_equal(got[i], hits.refine_hits_plain(*a, **kw)), i
    # the graph: the hit rows (the row path) and the live mask refilled
    pos0, dn, lo, hi, hit, hit_pos, limit = args
    rows = pos0[0].as_strided((lo.shape[0], 8), (8, 1))
    assert rows[:, 7].data_ptr() == hi.data_ptr()
    static_rows, static_hit = rows.clone(), hit.clone()
    static = ((static_rows[:, 0], static_rows[:, 1], static_rows[:, 2]),
              (static_rows[:, 3], static_rows[:, 4], static_rows[:, 5]),
              static_rows[:, 6], static_rows[:, 7], static_hit, hit_pos,
              limit)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        refine_cuda(*static, **kwargs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = refine_cuda(*static, **kwargs)
    for seed in (1, 2, 3):
        g = torch.Generator(device=cuda).manual_seed(seed)
        new_rows = rows.clone()
        new_rows[:, 6:] += 0.002 * torch.randn(
            (rows.shape[0], 2), generator=g, device=cuda)
        new_hit = hit & (torch.rand(hit.shape, generator=g, device=cuda)
                         < 0.8)
        static_rows.copy_(new_rows)
        static_hit.copy_(new_hit)
        graph.replay()
        torch.cuda.synchronize()
        new = ((new_rows[:, 0], new_rows[:, 1], new_rows[:, 2]),
               (new_rows[:, 3], new_rows[:, 4], new_rows[:, 5]),
               new_rows[:, 6], new_rows[:, 7], new_hit, hit_pos, limit)
        eager = refine_cuda(*new, **kwargs)
        torch.cuda.synchronize()
        assert _bits_equal(out, eager), seed
        assert _bits_equal(out, hits.refine_hits_plain(*new, **kwargs)), seed


@pytest.mark.cuda
def test_hit_kernels_refuse_unaligned_oct_rows(cuda):
    """Oct rows that do not start on 16 bytes (a row is one 16-byte load)
    are refused by the refine and the shade with ValueError, before any
    launch."""
    from rgbd_recon_tpu_torch.kernels.hits import refine_cuda, shade_cuda
    from rgbd_recon_tpu_torch.ops import hits

    pipe, volume, maps, counts, cam = _hit_scene(cuda, num_sensors=2)
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    args, kwargs = calls["refine"]
    oct = kwargs["oct"]
    flat = torch.empty(oct.rows.numel() + 4, dtype=oct.rows.dtype,
                       device=cuda)
    rows = flat[4:].view(oct.rows.shape)
    rows.copy_(oct.rows)
    assert rows.data_ptr() % 16 == 8
    off = dataclasses.replace(oct, rows=rows)
    sargs, skw = calls["shade"]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        refine_cuda(*args, **dict(kwargs, oct=off))
    sargs = sargs[:13] + (off,)
    with pytest.raises(ValueError, match="16 bytes"):
        shade_cuda(**hits.shade_kernel_args(*sargs, **skw))
    counts = kernels.launch_counts()
    assert counts["hit_refine"] == 0 and counts["hit_shade"] == 0


# ---- the fuse's marking and brick-compact integration (csrc/fuse.cu) -----

def _fuse_mark_args(c, device):
    """mark_pixels' arguments of a fuse_cases.mark_case on ``device``: the
    depth as channel 0 of its (N, H, W, 2) map (a strided view)."""
    def t(k):
        return None if c[k] is None else torch.from_numpy(c[k]).to(device)

    depth = torch.from_numpy(c["depth"]).to(device)[..., 0]
    return ((depth, t("bbox_min"), c["brick_size"], c["brick_res"],
             c["stride"]),
            dict(ray_a=t("ray_a"), ray_b=t("ray_b"), worlds=t("worlds")))


def _fuse_integrate_args(c, device):
    keys = ("proj_bricks", "counts", "min_voxels", "capacity", "depths",
            "qualities", "silhouettes", "limit", "vol_shape", "brick_vox")
    args = [torch.from_numpy(c[k]).to(device)
            if isinstance(c[k], np.ndarray) else c[k] for k in keys]
    return args, dict(carve_sil_threshold=c["carve_sil_threshold"],
                      phantom_hull=c["phantom_hull"], taps=c["taps"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fuse_cases.MARK_CASES))
def test_fuse_brick_mark_matches_twin(cuda, name):
    """brick_mark (through mark_pixels' dispatch) bit for bit against
    mark_pixels_plain on the card on fuse_cases' pixels: strides 1-3, the
    pixel models and given world points (points on brick faces and past
    the box), 10 cm bricks (the shared histogram) and 5 cm bricks (70,400
    counts: global atomics, as its launch plan says); one launch."""
    from rgbd_recon_tpu_torch.kernels.fuse import mark_plan
    from rgbd_recon_tpu_torch.ops import bricks

    c = fuse_cases.mark_case(name)
    args, kw = _fuse_mark_args(c, cuda)
    bins = int(np.prod(c["brick_res"]))
    plan = mark_plan(*args, **kw)
    assert plan["shared_histogram"] == (bins * 4 <= 48 * 1024)
    kernels.reset_launch_counts()
    got = bricks.mark_pixels(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["brick_mark"] == 1
    want = bricks.mark_pixels_plain(*args, **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(want.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fuse_cases.INTEGRATE_CASES))
def test_fuse_brick_integrate_matches_twin(cuda, name):
    """integrate_compact on the card (the flags, one compaction, one
    brick_integrate launch) bit for bit against integrate_compact_plain on
    the card on fuse_cases' maps and projections: nearest and bilinear
    taps, a capacity above and below the occupied bricks, the phantom
    hull, carve threshold 0.5, padded bricks and the sharded step's
    z-slab."""
    from rgbd_recon_tpu_torch.ops import tsdf

    c = fuse_cases.integrate_case(name)
    args, kw = _fuse_integrate_args(c, cuda)
    kernels.reset_launch_counts()
    got = tsdf.integrate_compact(*args, **kw)
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    assert launched == {"compact": 1, "brick_integrate": 1}
    want = tsdf.integrate_compact_plain(*args, **kw)
    assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["nearest", "bilinear"])
def test_fuse_brick_integrate_on_slab_views(cuda, taps):
    """The sharded step's form: each slab's projections a view of the
    whole bake (the sensors a whole bake apart, not a slab apart) and its
    counts a slice; each slab's volume bit-equal to the twin's and to the
    kernel's on a contiguous copy of the view."""
    from rgbd_recon_tpu_torch.ops import tsdf

    c = fuse_cases.integrate_case(f"{taps}_whole", seed=5)
    args, kw = _fuse_integrate_args(c, cuda)
    proj, counts = args[0], args[1]
    N, B, V, _ = proj.shape
    Bz = counts.shape[0]
    v = c["brick_vox"]
    Z, Y, X = c["vol_shape"]
    projz = proj.view(N, Bz, B // Bz, V, 4)
    for lo, hi in ((0, 1), (1, 3)):
        part = projz[:, lo:hi].reshape(N, (hi - lo) * (B // Bz), V, 4)
        assert not part.is_contiguous()
        sargs = list(args)
        sargs[0], sargs[1] = part, counts[lo:hi]
        sargs[8] = ((hi - lo) * v, Y, X)
        got = tsdf.integrate_compact(*sargs, **kw)
        assert _bits_equal(got, tsdf.integrate_compact_plain(*sargs, **kw))
        sargs[0] = part.contiguous()
        assert _bits_equal(got, tsdf.integrate_compact(*sargs, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("listed", ["none", "every", "odd"])
@pytest.mark.parametrize("name", ["nearest_padded", "bilinear_big_bricks",
                                  "nearest_six_sensors"])
def test_fuse_brick_integrate_on_whole_lists(cuda, name, listed):
    """brick_integrate on an empty list (every voxel cleared by the clear
    blocks), on every brick listed (the brick blocks write every voxel)
    and on every other brick, each at a capacity of exactly the listed
    bricks: bit for bit against integrate_compact_plain with min_voxels
    and counts that list the same bricks."""
    from rgbd_recon_tpu_torch.kernels.fuse import brick_integrate_cuda
    from rgbd_recon_tpu_torch.ops import tsdf

    c = fuse_cases.integrate_case(name)
    args, kw = _fuse_integrate_args(c, cuda)
    B = args[0].shape[1]
    on = {"none": torch.zeros(B, dtype=torch.bool, device=cuda),
          "every": torch.ones(B, dtype=torch.bool, device=cuda),
          "odd": torch.arange(B, device=cuda) % 2 == 1}[listed]
    args[1] = on.to(torch.int32).view(args[1].shape) * 20
    n = int(on.sum())
    args[3] = n
    ids = torch.full((max(n, 1),), B, dtype=torch.int64, device=cuda)
    ids[:n] = torch.nonzero(on).reshape(-1)
    slot = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    slot[ids[:n]] = torch.arange(n, dtype=torch.int32, device=cuda)
    got = brick_integrate_cuda(args[0], ids, slot, *args[4:], **kw)
    want = tsdf.integrate_compact_plain(*args, **kw)
    assert _bits_equal(got, want)
    if listed == "none":
        assert bool((got == -c["limit"]).all())


@pytest.mark.cuda
def test_fuse_brick_mark_past_the_touched_list(cuda):
    """A marking whose blocks each touch more distinct bricks than their
    list holds (1,638,400 pixels, pixel k near the centre of brick k mod
    8,800): the blocks flush their whole histograms, and the counts equal
    mark_pixels_plain's; one launch."""
    from rgbd_recon_tpu_torch.kernels.fuse import mark_plan
    from rgbd_recon_tpu_torch.ops import bricks

    rng = np.random.default_rng(4)
    shape = (4, 640, 640)
    w = fuse_cases.gathered_points("every_brick", shape, 0.1, rng)
    depth = torch.full((*shape, 2), 0.5, device=cuda)[..., 0]
    args = (depth, torch.tensor(fuse_cases.BOX_MIN, device=cuda), 0.1,
            fuse_cases.brick_res(0.1), 1)
    kw = dict(worlds=torch.from_numpy(w).to(cuda))
    plan = mark_plan(*args, **kw)
    assert plan["shared_histogram"]
    assert np.prod(shape) / plan["blocks"] > plan["list_capacity"]
    kernels.reset_launch_counts()
    got = bricks.mark_pixels(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["brick_mark"] == 1
    assert torch.equal(got, bricks.mark_pixels_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("brick_size", [0.1, 0.05, 0.2, 0.25, 0.3, 0.07])
def test_fuse_mark_scalars_match_torch_division(cuda, brick_size):
    """PyTorch's CUDA x / c by a Python c is x times mark_scalars' f32
    reciprocal, bit for bit, on 2^20 seeded values around the box (the
    twin's (p - bbox_min) / brick_size, which the kernel computes so)."""
    from rgbd_recon_tpu_torch.kernels.fuse import mark_scalars

    inv = mark_scalars(brick_size)[0]
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.rand(2 ** 20, device=cuda, generator=gen) * 2.4 - 0.1
    assert _bits_equal(x / brick_size, x * torch.tensor(inv, device=cuda))


@pytest.mark.cuda
def test_fuse_kernels_back_to_back_and_in_graphs(cuda):
    """The fuse's marking and integration (brick_mark; the flags, compact
    and brick_integrate) captured in one CUDA graph on a side stream
    (warmed up there first) and replayed 3 times on changed inputs copied
    into the captured tensors, each replay bit-equal to the twins on those
    inputs; then 20 eager rounds back to back with no sync, each
    bit-equal."""
    from rgbd_recon_tpu_torch.ops import bricks, tsdf

    def inputs(seed):
        m = fuse_cases.mark_case("stride3_models", seed)
        c = fuse_cases.integrate_case("nearest_capacity_below", seed)
        return _fuse_mark_args(m, cuda), _fuse_integrate_args(c, cuda)

    (margs, mkw), (iargs, ikw) = inputs(0)
    static = [margs[0], margs[1], mkw["ray_a"], mkw["ray_b"], iargs[0],
              iargs[1], iargs[4], iargs[5], iargs[6]]

    def run():
        counts = bricks.mark_pixels(*margs, **mkw)
        vol = tsdf.integrate_compact(*iargs, **ikw)
        return counts, vol

    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        counts, vol = run()
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {
        "brick_mark": 1, "compact": 1, "brick_integrate": 1}
    for seed in (1, 2, 3):
        (m2, mk2), (i2, ik2) = inputs(seed)
        new = [m2[0], m2[1], mk2["ray_a"], mk2["ray_b"], i2[0], i2[1], i2[4],
               i2[5], i2[6]]
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(counts, bricks.mark_pixels_plain(*margs, **mkw))
        assert _bits_equal(vol, tsdf.integrate_compact_plain(*iargs, **ikw))
    rounds = [inputs(10 + i) for i in range(20)]
    torch.cuda.synchronize()
    outs = [(bricks.mark_pixels(*ma, **mk), tsdf.integrate_compact(*ia, **ik))
            for (ma, mk), (ia, ik) in rounds]
    torch.cuda.synchronize()
    for ((ma, mk), (ia, ik)), (cg, vg) in zip(rounds, outs):
        assert torch.equal(cg, bricks.mark_pixels_plain(*ma, **mk))
        assert _bits_equal(vg, tsdf.integrate_compact_plain(*ia, **ik))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [{}, dict(integrate_taps="bilinear",
                                          mark_stride=1),
                                 dict(pixel_ray_model=False)])
def test_fuse_on_the_kernels_matches_twins(cuda, monkeypatch, cfg):
    """A fuse of the small scene on the card launches brick_mark,
    compact and brick_integrate once each; its marking and integration
    make no host sync (set_sync_debug_mode("error")); its counts and
    volume are bit-equal to the same fuse with the marking and the
    integration on their twins (which launch none of the three)."""
    from rgbd_recon_tpu_torch.ops import bricks, tsdf

    pipe, _, _, _, _, frames = _small_scene(cuda, brick_size=0.2, **cfg)
    pm = pipe._get_pixel_models(frames.depths.shape[1:3])
    maps, _ = pipe.preprocess(frames)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = pipe._mark_bricks(pm, maps)
        vol = pipe.integrate(maps, counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert {k: launched[k] for k in ("brick_mark", "compact",
                                     "brick_integrate")} == {
        "brick_mark": 1, "compact": 1, "brick_integrate": 1}
    monkeypatch.setattr(bricks, "mark_pixels", bricks.mark_pixels_plain)
    monkeypatch.setattr(tsdf, "integrate_compact",
                        tsdf.integrate_compact_plain)
    kernels.reset_launch_counts()
    want_counts = pipe._mark_bricks(pm, maps)
    want_vol = pipe.integrate(maps, want_counts)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts()[k] for k in (
        "brick_mark", "compact", "brick_integrate"))
    assert torch.equal(counts, want_counts)
    assert _bits_equal(vol, want_vol)
    assert int((counts > pipe.config.min_voxels_per_brick).sum()) > 10


@pytest.mark.cuda
def test_fuse_wrappers_raise_on_the_card(cuda):
    """On CUDA tensors the wrappers refuse what their kernels do not take
    (maps on two devices, projections off 16 bytes) and launch nothing."""
    from rgbd_recon_tpu_torch.kernels.fuse import (
        brick_integrate_cuda,
        brick_mark_cuda,
    )

    m = fuse_cases.mark_case("stride3_models")
    margs, mkw = _fuse_mark_args(m, cuda)
    c = fuse_cases.integrate_case("nearest_whole")
    iargs, ikw = _fuse_integrate_args(c, cuda)
    B = iargs[0].shape[1]
    slot = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    ids = torch.full((iargs[3],), B, dtype=torch.int64, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="one card"):
        brick_mark_cuda(*margs, ray_a=mkw["ray_a"].cpu(), ray_b=mkw["ray_b"])
    proj = iargs[0]
    off = torch.zeros(proj.numel() + 1, device=cuda)[1:].view(proj.shape)
    with pytest.raises(ValueError, match="16-byte"):
        brick_integrate_cuda(off, ids, slot, *iargs[4:], **ikw)
    with pytest.raises(ValueError, match="one card"):
        brick_integrate_cuda(proj, ids, slot.cpu(), *iargs[4:], **ikw)
    assert not any(kernels.launch_counts().values())
