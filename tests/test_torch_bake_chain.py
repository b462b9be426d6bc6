"""The render bake's two chain kernels on the CPU: csrc/bake.cu's
brick_clearance and oct_table through their plain twins, held against the
JAX package, and their algorithms as numpy models held against the twins.

- ``ops/bake.py brick_clearance_plain`` against the JAX pipeline's
  ``render.brick_safe_field`` (rgbd_recon_tpu/recon/tsdf_pipeline.py:1042)
  bit for bit, on tests/bake_chain_cases.py's grids (non-cubic, empty,
  full, one brick, bricks on each face, a cropped z-slab) at 0, 1, 6 and
  16 rounds; bs_scaled is bsafe * brick_vox.
- The kernel's algorithm (the x distance, then the y and z folds of
  max(|d|, .) with its early exits, capped at rounds + 1) as vectorized
  numpy, bit for bit against the twin on those grids and the card's (the
  cells' 20 x 22 x 20 shell, a 30 x 30 x 30 grid).
- ``ops/raymarch.py build_oct_plain`` (``compact_plain``'s list and slot
  map, ``oct_rows_plain``'s rows) against the JAX ``build_oct_bricks``
  (rgbd_recon_tpu/ops/raymarch.py:351) bit for bit over every capacity
  row and over ``slots[:, 0]``: bf16 and f32 tables, fewer, as many and
  more set bricks than the capacity, none.
- The oct kernel's algorithm (a block a slot, the extended brick staged by
  its element index or read in place, a thread a row, the corner order) as
  numpy, bit for bit against ``oct_rows_plain``.
- The pipeline's CPU bake on the fast and parity cells' configs (a seeded
  volume at 5 cm voxels in 20 cm bricks) against the JAX pipeline's bake:
  surface bricks, clearance, march table, oct rows and slots; it and the
  dispatches on CPU tensors make no kernel launch.
- ``profile_slice.py``'s cells, and its exit without a card.

The constants the models use are read from the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.calib import build_synthetic_calibration
from rgbd_recon_tpu.core import BoundingBox, PipelineConfig
from rgbd_recon_tpu.ops import raymarch as jax_raymarch
from rgbd_recon_tpu.ops.raymarch import ViewCamera
from rgbd_recon_tpu.recon import TsdfPipeline
from rgbd_recon_tpu.sensors import default_test_rig

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.bench.headline import load_cell
from rgbd_recon_tpu_torch.calib.sensors import (
    build_synthetic_calibration as port_calibration,
)
from rgbd_recon_tpu_torch.core import BoundingBox as PortBox
from rgbd_recon_tpu_torch.core import PipelineConfig as PortConfig
from rgbd_recon_tpu_torch.kernels import bake as kbake
from rgbd_recon_tpu_torch.ops import bake, raymarch
from rgbd_recon_tpu_torch.ops.compact import compact_plain
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera as PortCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import (
    TsdfPipeline as PortPipeline,
)
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic

import bake_chain_cases as cases

torch.set_num_threads(2)

SRC = (Path(__file__).resolve().parent.parent / "rgbd_recon_tpu_torch"
       / "csrc" / "bake.cu").read_text()
BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
BBOX = BoundingBox(**BOX)
PBBOX = PortBox(**BOX)
CAM = dict(width=96, height=80, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0))
# 5 cm voxels in 20 cm bricks: a (40, 44, 40) volume of whole bricks, so the
# fast config builds its oct table
BASE_CFG = dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=0.02, num_lods=5)
RIG = dict(num_sensors=1, depth_size=(32, 24), color_size=(40, 32))
CALIB_RES = dict(cv_res=(8, 10, 8), inv_res=(10, 11, 10))
CELLS = {"fast": "tsdf_fast_4kinect2_1cm", "parity": "tsdf_parity_4kinect2_1cm"}


def _const(name: str) -> int:
    """An integer constant of csrc/bake.cu (``constexpr int NAME = ...;``,
    a product of literals)."""
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", SRC).group(1)
    out = 1
    for f in expr.split("*"):
        out *= int(f)
    return out


def _f32_bits(x):
    a = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    assert a.dtype == np.float32
    return a.view(np.uint32)


def _bits(x):
    """An f32 or bf16 array (torch or jax) as its bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        return _f32_bits(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.fixture(scope="module")
def jax_calib():
    rig = default_test_rig(bbox=BBOX, **RIG)
    return build_synthetic_calibration(rig, BBOX, **CALIB_RES)


@pytest.fixture(scope="module")
def jax_brick_safe_field(jax_calib):
    """rounds -> the JAX pipeline's render.brick_safe_field with
    skip_brick_rounds = rounds."""
    fields = {}

    def get(rounds):
        if rounds not in fields:
            pipe = TsdfPipeline(jax_calib, PipelineConfig(
                **BASE_CFG, skip_brick_rounds=rounds), BBOX)
            render, _ = pipe.make_render_fn(ViewCamera(**CAM))
            fields[rounds] = render.brick_safe_field
        return fields[rounds]

    return get


# ---- brick_clearance --------------------------------------------------------

@pytest.mark.parametrize("rounds", cases.ROUNDS)
@pytest.mark.parametrize("name", cases.CLEARANCE_CASES)
def test_brick_clearance_plain_matches_jax(jax_brick_safe_field, name,
                                           rounds):
    """The twin's bsafe bit-equal to the JAX render.brick_safe_field, its
    bs_scaled bit-equal to the JAX bake's bsafe * brick_vox."""
    occ = cases.clearance_case(name)
    want = np.asarray(jax_brick_safe_field(rounds)(jnp.asarray(occ)))
    bsafe, bs = bake.brick_clearance_plain(torch.from_numpy(occ), rounds, 4)
    assert bsafe.shape == occ.shape and bs.shape == occ.shape
    np.testing.assert_array_equal(_f32_bits(bsafe), _f32_bits(want))
    np.testing.assert_array_equal(_f32_bits(bs),
                                  _f32_bits(want * np.float32(4.0)))
    assert float(bsafe.max()) <= rounds


def _x_distance(occ, R):
    """csrc/bake.cu clr_x over the grid: the first k in 0..R at which the
    row holds a set brick at x - k or x + k, else R + 1."""
    Bx = occ.shape[2]
    out = np.full(occ.shape, R + 1, np.int64)
    done = np.zeros(occ.shape, bool)
    x = np.arange(Bx)
    for k in range(R + 1):
        lo, hi = x - k >= 0, x + k < Bx
        left = np.zeros(occ.shape, bool)
        right = np.zeros(occ.shape, bool)
        left[:, :, lo] = occ[:, :, x[lo] - k]
        right[:, :, hi] = occ[:, :, x[hi] + k]
        found = (left | right) & ~done
        out[found] = k
        done |= found
    return out


def _fold(p, axis):
    """csrc/bake.cu clr_fold along ``axis``: best = p, then for k = 1, 2,
    ... while k < best, best = min(best, max(k, min of p at -k and +k
    inside the grid)); an element stops once k reaches its best, which
    only falls, so the loop over every element at once is the kernel's."""
    best = p.copy()
    E = p.shape[axis]
    k = 1
    while k < best.max(initial=0):
        t = np.full(p.shape, 255, np.int64)
        lo = [slice(None)] * 3
        src = [slice(None)] * 3
        if k < E:
            lo[axis], src[axis] = slice(k, E), slice(0, E - k)
            t[tuple(lo)] = p[tuple(src)]
            lo[axis], src[axis] = slice(0, E - k), slice(k, E)
            t[tuple(lo)] = np.minimum(t[tuple(lo)], p[tuple(src)])
        live = k < best
        best = np.where(live, np.minimum(best, np.maximum(k, t)), best)
        k += 1
    return best


def _clearance_as_kernel(occ, R, brick_vox):
    """The kernel's three passes (x, then y, then z) and its store."""
    d = _fold(_fold(_x_distance(occ, R), 1), 0)
    assert d.max(initial=0) <= min(R + 1, 255)
    bsafe = np.where(d > 0, d - 1, 0).astype(np.float32)
    return bsafe, bsafe * np.float32(brick_vox)


@pytest.mark.parametrize("rounds", cases.ROUNDS)
@pytest.mark.parametrize("name", cases.CARD_CLEARANCE_CASES)
def test_clearance_algorithm_matches_twin(name, rounds):
    """The kernel's separable passes give the twin's R dilation rounds bit
    for bit (brick_vox 10: the cells' bs_scaled)."""
    occ = cases.clearance_case(name)
    want = bake.brick_clearance_plain(torch.from_numpy(occ), rounds, 10)
    got = _clearance_as_kernel(occ, rounds, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_f32_bits(g), _f32_bits(w))


def test_clearance_constants_match_source():
    """The wrapper's limit is csrc/bake.cu's: the most rounds (a distance
    capped at rounds + 1 fits a byte)."""
    assert _const("CLR_MAX_ROUNDS") == kbake.CLEARANCE_MAX_ROUNDS == 254


# ---- oct_table --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(cases.OCT_CASES))
def test_build_oct_plain_matches_jax(name, dtype):
    """Every capacity row (the padding slots' too) and the slot map of the
    twin bit-equal to the JAX build_oct_bricks (its slots' first
    column)."""
    vol, occ, v, capacity = cases.oct_case(name)
    want = jax_raymarch.build_oct_bricks(
        jnp.asarray(vol), jnp.asarray(occ), v, capacity, 0.02,
        dtype=getattr(jnp, dtype))
    got = raymarch.build_oct_plain(torch.from_numpy(vol),
                                   torch.from_numpy(occ), v, capacity,
                                   getattr(torch, dtype))
    assert got.rows.shape == (capacity * v ** 3, 8)
    assert got.rows.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got.rows), _bits(want.rows))
    np.testing.assert_array_equal(got.slots.numpy(),
                                  np.asarray(want.slots)[:, 0])
    listed = min(int(occ.sum()), capacity)
    assert int((got.slots >= 0).sum()) == listed
    assert got.shape == vol.shape and got.brick_vox == v


def _oct_as_kernel(vol, ids, v):
    """csrc/bake.cu oct_table_kernel as numpy: a block a slot, its brick
    min(id, B - 1); staged (the extended brick at element e = (dz * w + dy)
    * w + dx, w = v + 1, edge-clamped) when it fits OCT_STAGE_BYTES, else
    each corner read in place; a thread a row r = (lz * v + ly) * v + lx,
    corner k = dz * 4 + dy * 2 + dx."""
    Z, Y, X = vol.shape
    By, Bx = Y // v, X // v
    B = (Z // v) * By * Bx
    w = v + 1
    staged = w ** 3 * 4 <= _const("OCT_STAGE_BYTES")
    e = np.arange(w ** 3)
    edx, edy, edz = e % w, (e // w) % w, e // (w * w)
    r = np.arange(v ** 3)
    lx, ly, lz = r % v, (r // v) % v, r // (v * v)
    rows = np.empty((len(ids), v ** 3, 8), np.float32)
    for slot, i in enumerate(ids):
        bid = min(int(i), B - 1)
        bx, by, bz = bid % Bx, (bid // Bx) % By, bid // (Bx * By)
        z0, y0, x0 = bz * v, by * v, bx * v
        if staged:
            ext = vol[np.minimum(z0 + edz, Z - 1), np.minimum(y0 + edy, Y - 1),
                      np.minimum(x0 + edx, X - 1)]
        for k in range(8):
            dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
            if staged:
                rows[slot, :, k] = ext[((lz + dz) * w + ly + dy) * w + lx + dx]
            else:
                rows[slot, :, k] = vol[np.minimum(z0 + lz + dz, Z - 1),
                                       np.minimum(y0 + ly + dy, Y - 1),
                                       np.minimum(x0 + lx + dx, X - 1)]
    return rows.reshape(-1, 8)


@pytest.mark.parametrize("name", sorted(cases.CARD_OCT_CASES))
def test_oct_algorithm_matches_twin(name):
    """The kernel's rows (staged and read in place: 20- and 23-voxel
    bricks) bit-equal to oct_rows_plain's in f32 on compact_plain's list;
    the bf16 table is that table rounded once."""
    vol, occ, v, capacity = cases.oct_case(name)
    flags = torch.from_numpy(occ).reshape(-1).view(torch.uint8)
    ids, _ = compact_plain(flags, 0, capacity,
                           torch.zeros(1, dtype=torch.int32), 0)
    tvol = torch.from_numpy(vol)
    want = raymarch.oct_rows_plain(tvol, ids, v, torch.float32)
    got = _oct_as_kernel(vol, ids.numpy(), v)
    np.testing.assert_array_equal(got.view(np.uint32), _f32_bits(want))
    assert torch.equal(raymarch.oct_rows_plain(tvol, ids, v),
                       torch.from_numpy(got).to(torch.bfloat16))


def test_oct_stage_limit_splits_the_card_cases():
    """20-voxel bricks (37,044 B extended) are staged, 23-voxel bricks
    (55,296 B) read in place: the card's cases take both forms."""
    limit = _const("OCT_STAGE_BYTES")
    assert 21 ** 3 * 4 <= limit < 24 ** 3 * 4
    assert cases.CARD_OCT_CASES["bricks_20"][1] == 20
    assert cases.CARD_OCT_CASES["bricks_23"][1] == 23


# ---- dispatch and the pipeline's bake ---------------------------------------

def test_cpu_dispatch_takes_the_twins():
    """On CPU tensors brick_clearance, oct_rows and build_oct_bricks are
    their twins, bit for bit, and launch nothing."""
    kernels.reset_launch_counts()
    occ = torch.from_numpy(cases.clearance_case("non_cubic"))
    for g, w in zip(bake.brick_clearance(occ, 6, 10),
                    bake.brick_clearance_plain(occ, 6, 10)):
        assert torch.equal(g, w)
    vol, occ, v, capacity = cases.oct_case("over")
    vol, occ = torch.from_numpy(vol), torch.from_numpy(occ)
    got = raymarch.build_oct_bricks(vol, occ, v, capacity)
    want = raymarch.build_oct_plain(vol, occ, v, capacity)
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.slots, want.slots)
    ids = torch.tensor([3, 0, 59, 60], dtype=torch.int64)
    assert torch.equal(raymarch.oct_rows(vol, ids, v),
                       raymarch.oct_rows_plain(vol, ids, v))
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_chain_wrappers_refuse():
    """The two wrappers take CUDA tensors only (no fallback) and refuse a
    wrong type, shape, layout or rounds and an empty grid before the
    device check."""
    from rgbd_recon_tpu_torch.kernels.bake import (
        brick_clearance_cuda,
        oct_table_cuda,
    )

    kernels.reset_launch_counts()
    occ = torch.zeros(3, 4, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        brick_clearance_cuda(occ, 6, 10)
    with pytest.raises(ValueError, match="bool"):
        brick_clearance_cuda(occ.float(), 6, 10)
    with pytest.raises(ValueError, match="bool"):
        brick_clearance_cuda(occ[0], 6, 10)
    with pytest.raises(ValueError, match="contiguous"):
        brick_clearance_cuda(occ.transpose(0, 2), 6, 10)
    with pytest.raises(ValueError, match="rounds"):
        brick_clearance_cuda(occ, kbake.CLEARANCE_MAX_ROUNDS + 1, 10)
    with pytest.raises(ValueError, match="brick_vox"):
        brick_clearance_cuda(occ, 6, 0)
    with pytest.raises(ValueError, match="at least one brick"):
        brick_clearance_cuda(torch.zeros(0, 4, 5, dtype=torch.bool), 6, 10)
    with pytest.raises(ValueError, match="CUDA"):
        oct_table_cuda(torch.zeros(8, 8, 8), torch.zeros(2, dtype=torch.int64),
                       4)
    assert all(n == 0 for n in kernels.launch_counts().values())


def _sphere_volume(shape, limit):
    """A TSDF of a 0.55 m sphere at the box's centre in 5 cm voxels,
    clipped to +-limit and positive inside, with seeded noise."""
    rng = np.random.default_rng(11)
    z, y, x = np.meshgrid(*[(np.arange(s) + 0.5) * 0.05 for s in shape],
                          indexing="ij")
    d = 0.55 - np.sqrt((x - 1.0) ** 2 + (y - 1.1) ** 2 + (z - 1.0) ** 2)
    d = d + rng.normal(0.0, 0.004, shape)
    return np.clip(d, -limit, limit).astype(np.float32)


@pytest.fixture(scope="module")
def port_calib():
    rig = port_synthetic.default_test_rig(bbox=PBBOX, **RIG)
    return port_calibration(rig, PBBOX, device="cpu", **CALIB_RES)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_pipeline_bake_matches_jax(jax_calib, port_calib, cell):
    """The port's CPU bake (surface_occ, brick_clearance, sentinel_bake,
    build_oct_bricks) at the cell's pipeline config against the JAX
    pipeline's bake of the same volume: surface bricks, clearance, march
    table (the fast cell's sentinel table in bf16, the parity cell's raw
    f32 volume), every oct row and the slots; no kernel launch."""
    over = load_cell(CELLS[cell])["pipeline"]
    jpipe = TsdfPipeline(jax_calib, PipelineConfig(**BASE_CFG, **over), BBOX)
    ppipe = PortPipeline(port_calib, PortConfig(**BASE_CFG, **over), PBBOX)
    vol = _sphere_volume(ppipe.volume_grid.shape, ppipe._limit)
    counts = np.zeros(tuple(s // 4 for s in vol.shape), np.int32)
    jrender, _ = jpipe.make_render_fn(ViewCamera(**CAM))
    packed, oct_j, occ_j, bsafe_j, _ = jrender.bake(
        jnp.asarray(vol), jnp.asarray(counts), jpipe._limit)
    prender, _ = ppipe.make_render_fn(PortCamera(**CAM))
    kernels.reset_launch_counts()
    table, oct, occ, bsafe = prender.bake(torch.from_numpy(vol),
                                          torch.from_numpy(counts))
    assert all(n == 0 for n in kernels.launch_counts().values())
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    assert 0 < int(occ.sum()) < occ.numel()
    np.testing.assert_array_equal(_f32_bits(bsafe), _f32_bits(bsafe_j))
    pairs = _bits(packed.pairs)
    want = (pairs.reshape(vol.shape) if packed.half
            else pairs[:, 0].reshape(vol.shape))
    np.testing.assert_array_equal(_bits(table), want)
    if cell == "parity":
        assert table.dtype == torch.float32 and oct is None and oct_j is None
        return
    assert table.dtype == torch.bfloat16 and bool((table < -1.5).any())
    np.testing.assert_array_equal(_bits(oct.rows), _bits(oct_j.rows))
    np.testing.assert_array_equal(oct.slots.numpy(),
                                  np.asarray(oct_j.slots)[:, 0])


def test_profile_slice_cells_and_refusal(monkeypatch):
    """profile_slice.py (the bake's device activities, device ms, wall ms
    and host syncs on the card) takes the two cells whose pipelines the
    bake test above holds, refuses another name, and without a card exits
    before any work."""
    from rgbd_recon_tpu_torch import profile_slice

    assert profile_slice.CELLS == CELLS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cell in sorted(CELLS):
        with pytest.raises(SystemExit, match="is_available"):
            profile_slice.main(["--cell", cell])
    with pytest.raises(SystemExit):
        profile_slice.main(["--cell", "parity_dense"])
