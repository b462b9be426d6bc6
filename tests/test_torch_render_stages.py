"""The render's block stages on the CPU: ops/compact.py's compaction twin
against the former ``torch.nonzero`` compaction and the JAX package's
``jnp.nonzero(size=, fill_value=)``, each stage twin of
ops/render_stages.py and the row marches of ops/raymarch.py against the
former inline render (tests/render_reference.py, with its intermediates
recorded), and the whole CPU render against it, bit for bit.

The scene is the verify scene (4 sensors, one sphere, 5 cm voxels in 25 cm
bricks) rendered at 96x80, and a 256x192 close-up whose configuration
overflows the block list, a tail stage's list and the hit list.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu_torch.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu_torch.ops import compact, render_stages
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.ops.stage_calls import (
    STAGES,
    all_bits_equal,
    bits_equal,
    record_stages,
    replay,
)
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline
from rgbd_recon_tpu_torch.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

from render_reference import _first_ids, reference_render

torch.set_num_threads(2)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
CAM = ViewCamera(width=96, height=80, eye=(0.0, 1.3, 2.6),
                 target=(0.0, 1.1, 0.0))
# a close-up whose sphere covers most of its 3,072 blocks
CLOSE = ViewCamera(width=256, height=192, eye=(0.0, 1.15, 1.35),
                   target=(0.0, 1.1, 0.0))
# the verify scene's config and the cases on top of it: the fast path, the
# parity path (one trilinear f32 march), per-block brackets, the chunked
# first march, and the overflow case (2,048 block slots, a 5-step first
# march, 5% hit slots) on the close-up
BASE = dict(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02, num_lods=5)
CASES = {
    "fast": ({}, CAM),
    "parity": (dict(march_mode="trilinear", march_empty_skip=False,
                    march_dtype="float32"), CAM),
    "bracket_per_block": (dict(bracket_per_block=True), CAM),
    "march_chunk": (dict(march_chunk=8), CAM),
    "overflow": (dict(ray_compaction=0.01, march_phase1_steps=5,
                      hit_compaction=0.05), CLOSE),
}


@pytest.fixture(scope="module")
def scene():
    rig = default_test_rig(num_sensors=4, bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40), device="cpu")
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig,
        device="cpu")
    return calib, frames


@pytest.fixture(scope="module")
def renders(scene):
    """{case: (the render's output, its recorded stage calls, the reference
    render's output, its intermediates)} of one CPU render a case."""
    calib, frames = scene
    out = {}
    for name, (kw, cam) in CASES.items():
        pipe = TsdfPipeline(calib, PipelineConfig(**BASE, **kw), BBOX)
        volume, maps, counts = pipe.fuse(frames)
        render, cam0 = pipe.make_render_fn(cam)
        baked = render.bake(volume, counts)
        args = (baked, maps, cam0, pipe._get_projection_models(),
                pipe._limit)
        got = []
        calls = record_stages(
            lambda: got.append(render.render_from_baked(*args)))
        trace = {}
        want = reference_render(pipe, cam)(*args, trace)
        out[name] = (got[0], calls, want, trace)
    return out


# ---- the compaction ---------------------------------------------------------

def _masks():
    """(name, bool mask, capacity): empty, full, at capacity, past it, under
    it, across the kernel's 8,192-flag tiles."""
    rng = np.random.default_rng(5)
    out = []
    for n in (0, 1, 7, 8, 9, 100, 8191, 8192, 8193, 20_011):
        for p in (0.0, 1.0, 0.3):
            m = rng.random(n) < p
            k = int(m.sum())
            for cap in sorted({1, max(k, 1), k + 5, max(k - 3, 1), 8}):
                out.append((f"n{n}_p{p}_cap{cap}", m, cap))
    return out


MASKS = _masks()


@pytest.mark.parametrize("case", range(0, len(MASKS), 7))
def test_compact_plain_matches_nonzero(case):
    """compact_plain's list equals the former _first_ids and the JAX
    package's jnp.nonzero(size=, fill_value=), over a spread of sizes,
    densities and capacities; its count is the mask's, its slot map the
    list's inverse."""
    for name, m, cap in MASKS[case: case + 7]:
        mask = torch.from_numpy(m)
        for bit in (0, 3):
            flags = mask.to(torch.uint8) << bit | (~mask).to(torch.uint8) << (
                (bit + 1) % 8)
            counts = torch.full((3,), -7, dtype=torch.int32)
            ids, slot = compact.compact_plain(flags, bit, cap, counts, 1,
                                              want_slot=True)
            want = _first_ids(mask, cap)
            assert bits_equal(ids, want), name
            jx = np.asarray(jnp.nonzero(jnp.asarray(m), size=cap,
                                        fill_value=len(m))[0])
            np.testing.assert_array_equal(ids.numpy(), jx, err_msg=name)
            assert counts.tolist() == [-7, int(m.sum()), -7], name
            expect = np.full(len(m), -1, np.int32)
            listed = ids.numpy()[ids.numpy() < len(m)]
            expect[listed] = np.arange(len(listed), dtype=np.int32)
            np.testing.assert_array_equal(slot.numpy(), expect, err_msg=name)
            ids2, slot2 = compact.compact(flags, bit, cap, counts, 0)
            assert slot2 is None and bits_equal(ids2, ids), name
            assert int(counts[0]) == int(m.sum()), name


# the compaction kernel's tile is 2,048 flags (csrc/compact.cu): one below,
# at, one above and twice it, and a 4K camera's 1,658,880 rays
TILE_FLAGS = 2048


@pytest.mark.parametrize("p", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("n", [TILE_FLAGS - 1, TILE_FLAGS, TILE_FLAGS + 1,
                               2 * TILE_FLAGS, 1_658_880])
def test_compact_plain_matches_jax_at_tile_sizes(n, p):
    """compact_plain against jnp.nonzero(size=, fill_value=) at sizes
    around the kernel's tile and at 1,658,880 flags, at capacities 0,
    under, at and over the count: the list, the count, the slot map."""
    rng = np.random.default_rng(n + int(p * 100))
    m = rng.random(n) < p
    k = int(m.sum())
    flags = torch.from_numpy(m.astype(np.uint8) << 2 | rng.integers(
        0, 4, n).astype(np.uint8))
    for cap in sorted({0, max(k - 1, 0), k // 2, k, k + 1, k + 4096}):
        counts = torch.full((2,), -3, dtype=torch.int32)
        ids, slot = compact.compact_plain(flags, 2, cap, counts, 1,
                                          want_slot=True)
        want = np.asarray(jnp.nonzero(jnp.asarray(m), size=cap,
                                      fill_value=n)[0])
        np.testing.assert_array_equal(ids.numpy(), want, err_msg=str(cap))
        assert counts.tolist() == [-3, k], cap
        expect = np.full(n, -1, np.int32)
        listed = want[want < n]
        expect[listed] = np.arange(len(listed), dtype=np.int32)
        np.testing.assert_array_equal(slot.numpy(), expect, err_msg=str(cap))


def test_compact_dispatch_on_cpu_runs_the_twin():
    """compact on CPU tensors is compact_plain and counts no launch."""
    kernels.reset_launch_counts()
    m = torch.from_numpy(np.random.default_rng(1).random(300) < 0.4)
    counts = torch.zeros(1, dtype=torch.int32)
    got = compact.compact(m.to(torch.uint8), 0, 64, counts, 0, True)
    want = compact.compact_plain(m.to(torch.uint8), 0, 64,
                                 torch.zeros(1, dtype=torch.int32), 0, True)
    assert all_bits_equal(got, want)
    assert all(n == 0 for n in kernels.launch_counts().values())


# ---- the stages against the reference render --------------------------------

def _calls(calls, stage):
    return [c for c in calls if c[0] == stage]


@pytest.mark.parametrize("name", list(CASES))
def test_render_unchanged_on_cpu(renders, name):
    """The CPU render equals the reference render bit for bit: colour,
    window depth, hit mask, march steps, overflow."""
    got, _, want, _ = renders[name]
    for f in ("color", "depth", "hit", "num_samples", "overflow"):
        assert bits_equal(getattr(got, f), getattr(want, f)), (name, f)
    assert int(got.hit.sum()) > 100
    if name == "overflow":
        ov = got.overflow.tolist()
        assert ov[0] > 0 and ov[1] > 0 and ov[2] > 0, ov
    else:
        assert got.overflow.tolist()[0] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_stage_twins_match_reference(renders, name):
    """Each stage's twin, fed the inputs the CPU render recorded, gives the
    reference render's intermediates: the scan's five planes, the blocks'
    interval, flags and centre rays, the block list, the coarse grids, the
    ray rows, the state rows after each march, the tail and hit lists, the
    hit inputs, the pre-fill image."""
    _, calls, _, tr = renders[name]
    stages = [c[0] for c in calls]
    marches = 1 if name == "parity" else 1 + len(tr["tail_idx"])
    assert stages[:3] == ["scan", "block_setup", "compact"], stages
    assert stages.count("march_rows") == marches - (name == "march_chunk")
    assert stages.count("compact") == 2 + len(tr["tail_idx"])

    def twin(call):
        out, after = replay(call[0], call[1], call[2], plain=True)
        assert all_bits_equal(out, call[3]), call[0]
        return out, after

    scan5, = (twin(c)[0] for c in _calls(calls, "scan"))
    assert bits_equal(scan5, tr["scan5"])
    (blk, s_end, bflags, grid), = (twin(c)[0]
                                   for c in _calls(calls, "block_setup"))
    assert bits_equal(blk[:, 6], tr["length"])
    assert bits_equal(blk[:, 7], tr["s_start"])
    assert bits_equal(blk[:, 3:6].T.contiguous(), tr["dirs_c"])
    assert bits_equal(s_end, tr["s_end"])
    assert torch.equal((bflags & 1).bool(), tr["flags"])
    assert torch.equal((bflags & 2).bool(), tr["found"])
    comp = _calls(calls, "compact")
    (blk_idx, blk_slot), _ = twin(comp[0])
    assert bits_equal(blk_idx, tr["blk_idx"])
    (g,) = [twin(c)[1][0][5] for c in _calls(calls, "march_grid")]
    assert bits_equal(g, tr["grid"])
    (ray8,) = [twin(c)[0] for c in _calls(calls, "bracket")]
    assert bits_equal(ray8, tr["ray8"])
    rows = _calls(calls, "march_rows")
    st8s = [twin(c)[0][0] for c in rows]
    assert len(st8s) + (name == "march_chunk") == len(tr["st8"])
    for got, want in zip(st8s[::-1], tr["st8"][::-1]):
        assert bits_equal(got, want)
    for c, want in zip(comp[1:-1], tr["tail_idx"]):
        assert bits_equal(twin(c)[0][0], want)
    (hit_idx, hit_slot), _ = twin(comp[-1])
    assert bits_equal(hit_idx, tr["hit_idx"])
    ((hrows, hpos, live),) = [twin(c)[0] for c in _calls(calls, "hit_gather")]
    assert bits_equal(hrows, tr["hit_rows"])
    assert bits_equal(hpos, tr["hit_pos"])
    assert bits_equal(live, tr["live"])
    ((planes, depth, hit, num, _),) = [twin(c)[0]
                                       for c in _calls(calls, "compose")]
    assert bits_equal(planes, tr["planes"].contiguous())
    assert bits_equal(depth, tr["depth"])
    assert bits_equal(hit, tr["hit"])
    assert bits_equal(num, tr["num"])


def test_stage_dispatch_on_cpu_runs_the_twins(renders):
    """Every stage's dispatch on the recorded CPU inputs equals its twin
    and counts no launch."""
    _, calls, _, _ = renders["fast"]
    kernels.reset_launch_counts()
    seen = set()
    for stage, args, kwargs, _ in calls:
        got, got_after = replay(stage, args, kwargs, plain=False)
        want, want_after = replay(stage, args, kwargs, plain=True)
        assert all_bits_equal(got, want), stage
        assert all_bits_equal(got_after, want_after), stage
        seen.add(stage)
    assert seen == set(STAGES)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_overflow_plain_counts():
    """overflow_plain: each list past its capacity, the larger tail stage,
    the lists that were not made as 0, int32."""
    counts = torch.tensor([10, 7, 30, 4, 90], dtype=torch.int32)
    got = render_stages.overflow_plain(counts, [8, 5, 20, 6, 100])
    assert got.dtype == torch.int32 and got.tolist() == [2, 10, 0, 0]
    got = render_stages.overflow_plain(counts, [12, 3, -1, 1, -1])
    assert got.tolist() == [0, 4, 3, 0]


def test_kernel_wrappers_reject_cpu_tensors(renders):
    """The stage wrappers of kernels/render_stages.py, kernels/compact.py
    and the row marches raise on the CPU tensors they are given (no
    build, no launch)."""
    from rgbd_recon_tpu_torch.kernels import compact as kcompact
    from rgbd_recon_tpu_torch.kernels import raymarch as kraymarch
    from rgbd_recon_tpu_torch.kernels import render_stages as kstages

    _, calls, _, _ = renders["fast"]
    by_stage = {c[0]: c for c in calls}
    wrappers = {
        "scan": kstages.scan_cuda, "block_setup": kstages.block_setup_cuda,
        "bracket": kstages.bracket_cuda, "hit_gather": kstages.hit_gather_cuda,
        "compose": kstages.compose_cuda, "compact": kcompact.compact_cuda,
        "march_rows": kraymarch.march_rows_cuda,
        "march_grid": kraymarch.march_grid_cuda,
    }
    kernels.reset_launch_counts()
    for stage, fn in wrappers.items():
        _, args, kwargs, _ = by_stage[stage]
        with pytest.raises(ValueError):
            fn(*args, **kwargs)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_geometry_of_the_cells():
    """The cells' 1280x720 camera at the default config: 4-pixel blocks,
    180 x 320 of them, 90 x 160 scan rays of 53 samples, 11,520 block
    slots (184,320 rays), tail lists of 61,440 and 18,432 rays, 101,376
    hit slots."""
    cfg = PipelineConfig()
    h_min = 1.0 / 220
    brick_norm = 10 * h_min
    step_len = cfg.interval_step_frac * brick_norm
    g = render_stages.BlockGeometry(
        H=720, W=1280, ds=cfg.interval_downsample, sc=2, tan_half=0.5,
        bbox_size=(2.0, 2.2, 2.0), vol_shape=(200, 220, 200), brick_vox=10,
        n_scan=int(np.ceil(np.sqrt(3.0) / step_len)) + 2, step_len=step_len,
        brick_norm=brick_norm, bracket_max_steps=cfg.bracket_max_steps,
        bracket_margin_steps=cfg.bracket_margin_steps, sd=0.005,
        per_block=False)
    assert (g.Hb, g.Wb, g.NB, g.Hs, g.Ws, g.n_scan) == (180, 320, 57_600, 90,
                                                        160, 53)
    assert dataclasses.replace(g, H=721).Hp == 724
