"""The fuse's two kernels (csrc/fuse.cu brick_integrate and brick_mark) as
numpy models on the CPU, and edge cases of their twins against the JAX
package.

- The integrate's partition: the grid of brick blocks (an item a block,
  INT_THREADS voxels of a listed brick, a thread a voxel) and clear blocks
  (a warp CLEAR_ROWS x-rows, a lane a quad of four voxels along x, the
  row's listed flags a ballot of 32 bricks, the brick of a quad's voxel by
  the kernel's walk from a multiply-and-shift quotient) interleaved as the
  kernel interleaves them. Every voxel of the volume is written exactly
  once, by a brick block iff its brick is listed (slot >= 0), and a float4
  store is made only of four cleared voxels on a 16-byte boundary: the
  cells' 200 x 220 x 200 grid at 576 and 640 listed bricks, the shapes of
  tests/fuse_cases.py (X % 4 != 0, partial bricks, a slab), an empty list,
  every brick listed, and a capacity below the occupied count. The
  multiply-and-shift quotient is exact over the kernel's range.
- The ring of bench/fuse_split.py's bulk-copy forms (persistent brick
  blocks stepping by P over the items, each item's sensor groups a stage):
  every listed item's every group is consumed once, in the producer's
  order, padding entries skipped, at P = 1, 7, the card's 132 and 264,
  and an item a block.
- The marking: its pixel order (a warp 32 x MARK_UNROLL consecutive
  pixels); with the shared histogram an add a lane, each block's list of
  touched bins (its whole histogram flushed past the list's capacity);
  without it (5 cm bricks) __match_any_sync's groups and one add of popc
  x add a group to the counts; the grid sized as mark_plan sizes it: the
  counts equal np.bincount of the pixels' keys and mark_pixels_plain, also
  when every pixel falls in one brick or at one brick corner, and when the
  blocks overflow their lists.
- Seeded edge cases of the twins against the JAX package: depths of
  exactly 0, 1, NaN and just inside (0, 1) (mark_bricks through the
  pipeline's sampling, and both pipelines' _mark_bricks on the verify
  scene's maps), points on brick faces and far outside the box
  (clamped), and the integrate on maps holding 0, 1 and NaN depths at a
  capacity below the occupied count (integrate_bricks).

The constants the models use are read from the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.ops import bricks as jax_bricks
from rgbd_recon_tpu.ops import tsdf as jax_tsdf

from rgbd_recon_tpu_torch.bench import fuse_split
from rgbd_recon_tpu_torch.kernels import fuse as kfuse
from rgbd_recon_tpu_torch.ops import bricks as port_bricks
from rgbd_recon_tpu_torch.ops import tsdf as port_tsdf

import fuse_cases
from test_torch_fuse_kernels import _with_stride, scene  # noqa: F401
from test_torch_parity import jax_arrays

from rgbd_recon_tpu_torch import convert

torch.set_num_threads(2)

SOURCE = Path(kfuse.__file__).resolve().parent.parent / "csrc" / "fuse.cu"


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    return int(eval(m[1], {}))


INT_THREADS = _constant("INT_THREADS")
CLEAR_ROWS = _constant("CLEAR_ROWS")
SENSOR_CHUNK = _constant("SENSOR_CHUNK")
MARK_THREADS = _constant("MARK_THREADS")
MARK_UNROLL = _constant("MARK_UNROLL")
MARK_BLOCKS_PER_SM = _constant("MARK_BLOCKS_PER_SM")
MARK_SMEM_MAX = _constant("MARK_SMEM_MAX")
MARK_LIST_MAX = _constant("MARK_LIST_MAX")
WARPS = INT_THREADS // 32
SMS = 132


def test_model_uses_the_sources_constants():
    """Whole warps a block; a histogram limit within the default 48 KB."""
    assert INT_THREADS % 32 == 0 and 32 <= INT_THREADS <= 1024
    assert MARK_THREADS % 32 == 0 and 32 <= MARK_THREADS <= 1024
    assert CLEAR_ROWS >= 1 and SENSOR_CHUNK >= 1 and MARK_UNROLL >= 1
    assert MARK_SMEM_MAX <= 48 * 1024 and MARK_LIST_MAX >= 1
    assert MARK_BLOCKS_PER_SM >= 1


# ---- multiply and shift ------------------------------------------------------

def divisor(d: int):
    """csrc/fuse.cu divisor(d): (magic, shift)."""
    d = max(d, 1)
    ell = 0
    while (1 << ell) < d:
        ell += 1
    shift = 31 + ell
    return ((1 << shift) + d - 1) // d, shift


def div_by(v, q):
    magic, shift = q
    return (np.asarray(v, dtype=object) * magic) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 10, 11, 20, 22, 200, 220,
                               1000, 4099, 65_535, 2 ** 20 + 1])
def test_multiply_and_shift_is_the_quotient(d):
    """v // d by (v * magic) >> shift at the ends of [0, 2^31) and around
    multiples of d, in 64-bit arithmetic as the kernel's unsigned long long
    (the product stays below 2^64)."""
    magic, shift = divisor(d)
    assert magic < 2 ** 33
    k = np.arange(0, 2 ** 31, max(1, 2 ** 31 // 4096), dtype=np.int64)
    v = np.concatenate([k, np.clip((k // d) * d + np.array([[-1], [0], [1]]),
                                   0, 2 ** 31 - 1).ravel(),
                        [2 ** 31 - 1, 2 ** 31 - 2]])
    got = (v.astype(np.uint64) * np.uint64(magic)) >> np.uint64(shift)
    assert (v.astype(np.uint64) * np.uint64(magic) // np.uint64(magic)
            == v.astype(np.uint64)).all()
    np.testing.assert_array_equal(got.astype(np.int64), v // d)


# ---- the integrate's partition ------------------------------------------------

def compact_list(listed: np.ndarray, capacity: int):
    """ops/compact.py's list (the first ``capacity`` listed bricks,
    ascending, padded with B) and slot map (-1: not listed, or past the
    capacity)."""
    B = listed.size
    on = np.flatnonzero(listed)[:capacity]
    ids = np.full(capacity, B, np.int64)
    ids[:on.size] = on
    slot = np.full(B, -1, np.int32)
    slot[on] = np.arange(on.size, dtype=np.int32)
    return ids, slot


def integrate_launch(vol_shape, v, capacity):
    """(brick blocks, clear blocks, items a list entry) of csrc/fuse.cu
    integrate_shape."""
    Z, Y, _ = vol_shape
    chunks = -(-v ** 3 // INT_THREADS)
    rows_a_block = WARPS * CLEAR_ROWS
    return capacity * chunks, -(-(Z * Y) // rows_a_block), chunks


def clear_row_writes(X, v, Bx):
    """The quads the lanes of a warp take along one x-row, from the kernel's
    loops: [(segment b0, x0, [(x, brick relative to b0)] of its voxels
    inside the segment)], each voxel's brick by the walk from
    div_by(x0, v)."""
    dv = divisor(v)
    out = []
    for b0 in range(0, Bx, 32):
        x_lo, x_hi = b0 * v, min(X, (b0 + 32) * v)
        assert x_lo % 4 == 0
        for lane in range(32):
            for x0 in range(x_lo + 4 * lane, x_hi, 128):
                bq = int(div_by(x0, dv))
                ell = x0 - bq * v
                bq -= b0
                vox = []
                for i in range(4):
                    if x0 + i < x_hi:
                        assert 0 <= bq < 32
                        vox.append((x0 + i, bq))
                    ell += 1
                    if ell == v:
                        ell, bq = 0, bq + 1
                out.append((b0, x0, vox))
    return out


def integrate_partition(vol_shape, v, ids, slot):
    """The model of one brick_integrate launch: (writes, by_brick, float4
    stores, misaligned float4 stores) where writes[z, y, x] counts the
    stores to a voxel and by_brick marks those a brick block made."""
    Z, Y, X = vol_shape
    Bz, By, Bx = (-(-s // v) for s in vol_shape)
    B, V = Bz * By * Bx, v ** 3
    P, C, chunks = integrate_launch(vol_shape, v, ids.size)
    writes = np.zeros(Z * Y * X, np.int32)
    by_brick = np.zeros(Z * Y * X, bool)
    total = P + C
    i = np.arange(total, dtype=np.int64)
    before = i * P // total
    upto = (i + 1) * P // total
    brick = upto > before
    assert brick.sum() == P and (np.sort(before[brick]) == np.arange(P)).all()
    cbs = i[~brick] - before[~brick]
    assert (cbs == np.arange(C)).all()
    # brick blocks: item w -> entry w // chunks, voxels of chunk w % chunks
    w = before[brick]
    j, c = w // chunks, w % chunks
    idv = ids[j]
    ok = (idv >= 0) & (idv < B)
    lv = (c[ok, None] * INT_THREADS + np.arange(INT_THREADS)[None, :])
    b = np.broadcast_to(idv[ok, None], lv.shape)
    keep = lv < V
    lv, b = lv[keep], b[keep]
    bxi, byz = b % Bx, b // Bx
    byi, bzi = byz % By, byz // By
    lz, lyx = lv // (v * v), lv % (v * v)
    ly, lx = lyx // v, lyx % v
    z, y, x = bzi * v + lz, byi * v + ly, bxi * v + lx
    inside = (z < Z) & (y < Y) & (x < X)
    flat = ((z * Y + y) * X + x)[inside]
    np.add.at(writes, flat, 1)
    by_brick[flat] = True
    # clear blocks: warp w of block cb, rows r0 + k
    r0 = ((cbs[:, None] * WARPS + np.arange(WARPS)[None, :]) * CLEAR_ROWS)
    rows = (r0[..., None] + np.arange(CLEAR_ROWS)).reshape(-1)
    rows = rows[rows < Z * Y]
    assert np.unique(rows).size == rows.size == Z * Y
    dY, dv = divisor(Y), divisor(v)
    zr = div_by(rows, dY).astype(np.int64)
    yr = rows - zr * Y
    row_b = ((div_by(zr, dv).astype(np.int64) * By
              + div_by(yr, dv).astype(np.int64)) * Bx)
    vec4 = misaligned = 0
    for b0, x0, vox in clear_row_writes(X, v, Bx):
        bits = np.stack([slot[row_b + b0 + bq] < 0 for _, bq in vox], axis=1)
        for k, (xv, _) in enumerate(vox):
            hit = rows[bits[:, k]]
            np.add.at(writes, hit * X + xv, 1)
        full = bits.all(axis=1) if len(vox) == 4 else np.zeros(len(rows),
                                                                bool)
        if X % 4 == 0:
            n4 = int(full.sum())
            vec4 += n4
            misaligned += int(((rows[full] * X + x0) % 4 != 0).sum())
    return (writes.reshape(Z, Y, X), by_brick.reshape(Z, Y, X), vec4,
            misaligned)


def _listed_voxels(vol_shape, v, slot):
    Z, Y, X = vol_shape
    Bz, By, Bx = (-(-s // v) for s in vol_shape)
    grid = (slot >= 0).reshape(Bz, By, Bx)
    full = grid.repeat(v, 0).repeat(v, 1).repeat(v, 2)
    return full[:Z, :Y, :X]


def _cells_list(n_listed, capacity, seed=0):
    rng = np.random.default_rng(seed)
    listed = np.zeros(8_800, bool)
    listed[rng.choice(8_800, n_listed, replace=False)] = True
    return compact_list(listed, capacity)


# name -> (volume, brick voxels, listed flags from a seed, capacity)
PARTITION_CASES = {
    "cells_576": ((200, 220, 200), 10, 576, 640),
    "cells_640": ((200, 220, 200), 10, 640, 640),
    "cells_capacity_below": ((200, 220, 200), 10, 700, 640),
    "cells_empty": ((200, 220, 200), 10, 0, 640),
    "cells_every": ((200, 220, 200), 10, 8_800, 8_800),
    "whole": ((12, 8, 12), 4, 11, 23),
    "padded": ((13, 10, 11), 4, 20, 41),
    "padded_capacity_below": ((13, 10, 11), 4, 20, 10),
    "slab": ((8, 8, 9), 4, 5, 17),
    "big_bricks": ((15, 9, 22), 7, 10, 29),
    "x_mod_4_is_2": ((9, 7, 30), 3, 40, 60),
    "bricks_of_one": ((5, 6, 37), 1, 500, 600),
    "wide": ((4, 5, 333), 2, 300, 700),
    "tiny_empty": ((3, 1, 5), 4, 0, 3),
    "tiny_every": ((3, 1, 5), 4, 2, 2),
}


@pytest.mark.parametrize("name", sorted(PARTITION_CASES))
def test_integrate_writes_every_voxel_once(name):
    """The model of the launch writes each voxel exactly once, a brick
    block iff its brick is listed; float4 stores only on 16-byte
    boundaries (X % 4 == 0)."""
    shape, v, n_listed, capacity = PARTITION_CASES[name]
    Bz, By, Bx = (-(-s // v) for s in shape)
    B = Bz * By * Bx
    rng = np.random.default_rng(len(name))
    listed = np.zeros(B, bool)
    listed[rng.choice(B, min(n_listed, B), replace=False)] = True
    ids, slot = compact_list(listed, capacity)
    writes, by_brick, vec4, misaligned = integrate_partition(shape, v, ids,
                                                             slot)
    assert (writes == 1).all()
    np.testing.assert_array_equal(by_brick, _listed_voxels(shape, v, slot))
    assert misaligned == 0
    if shape[2] % 4:
        assert vec4 == 0
    elif n_listed == 0:
        # every quad a float4: the clear alone
        assert vec4 == shape[0] * shape[1] * shape[2] // 4


def test_integrate_launch_at_the_cells_shape():
    """The cells' launch: 640 entries of 4 items (1,000 voxels in items of
    256), and rows of x cleared CLEAR_ROWS a warp."""
    P, C, chunks = integrate_launch((200, 220, 200), 10, 640)
    assert chunks == -(-1000 // INT_THREADS)
    assert P == 640 * chunks
    assert C * WARPS * CLEAR_ROWS >= 200 * 220 > (C - 1) * WARPS * CLEAR_ROWS


# ---- the ring of the bulk-copy forms ---------------------------------------

def ring_sequence(ids, B, items, chunks, groups, P, p):
    """Block p's loads as its Cursor steps through them (RING's seek and
    step): [(item, group)] of the items p, p + P, ... whose entries list a
    brick."""
    out = []
    w = p
    while True:
        while w < items and not (0 <= ids[w // chunks] < B):
            w += P
        if w >= items:
            return out
        for g in range(groups):
            out.append((w, g))
        w += P


def ring_consumption(ids, B, items, chunks, groups, P, p, stages=2):
    """The consumer's loads as the kernel's loop takes them: the producer
    issues the first ``stages`` loads, then one after each consumed load;
    (load, stage, parity) in consumption order, each checked against the
    load the producer put in that stage."""
    seq = ring_sequence(ids, B, items, chunks, groups, P, p)
    in_stage = {}
    issued = 0
    for k in range(min(stages, len(seq))):
        in_stage[k % stages] = (seq[k], k // stages)
        issued += 1
    taken = []
    for k in range(len(seq)):
        st = k % stages
        load, use = in_stage.pop(st)
        assert use == k // stages
        taken.append((load, st, use & 1))
        if issued < len(seq):
            in_stage[st] = (seq[issued], issued // stages)
            issued += 1
    assert not in_stage
    return taken


@pytest.mark.parametrize("P", [1, 7, 132, 264, "items"])
@pytest.mark.parametrize("sensors", [1, 4, 6, 9])
def test_ring_takes_every_listed_item_once(P, sensors):
    """Over all brick blocks, every group of every item whose entry lists
    a brick is consumed exactly once, from the stage the producer filled,
    and the padding entries' items never."""
    rng = np.random.default_rng(sensors)
    B, capacity, chunks = 8_800, 640, 4
    listed = np.zeros(B, bool)
    listed[rng.choice(B, 576, replace=False)] = True
    ids, _ = compact_list(listed, capacity)
    ids[rng.choice(576, 5, replace=False)] = -1   # stray entries skipped too
    items = capacity * chunks
    groups = -(-sensors // SENSOR_CHUNK)
    P = items if P == "items" else P
    seen = []
    for p in range(min(P, items)):
        seen += [load for load, _, _ in ring_consumption(
            ids, B, items, chunks, groups, P, p)]
    want = [(w, g) for w in range(items) if 0 <= ids[w // chunks] < B
            for g in range(groups)]
    assert sorted(seen) == want
    assert len(set(seen)) == len(seen)


def test_ring_variant_is_in_the_bench():
    """bench/fuse_split.py's ring variants apply to the source and carry
    the stepping the model follows."""
    text = SOURCE.read_text()
    for name in ("ring_persistent_2", "ring_persistent_4",
                 "ring_block_an_item", "ring_block_a_brick"):
        out = fuse_split.variant_source(text, name)
        assert "k.w += s.brick_blocks;" in out and "mbar_wait" in out


@pytest.mark.parametrize("name", sorted(fuse_split.VARIANTS))
def test_variant_regions_found_once(name):
    """Every variant of bench/fuse_split.py applies to the source as it
    is (each region found once)."""
    out = fuse_split.variant_source(SOURCE.read_text(), name)
    assert (out == SOURCE.read_text()) == (name == "kept")
    # nothing the launches need is cut out with a region
    for needed in ("int sm_count()", "mark_kernel(const MarkParams q",
                   "integrate_kernel(const IntegrateParams q",
                   "IntegrateShape integrate_shape(", "void mark_plan(",
                   "void clear_rows(", "int rgbd_fuse_attrs("):
        assert out.count(needed) == 1, needed


# ---- the marking -------------------------------------------------------------

def pixel_keys(c):
    """(own, nbr) of each sampled pixel of a fuse_cases marking case in the
    kernel's pixel order (n, i, j), -1 where no add: the twin's arithmetic
    (mark_bricks on the sampled pixels' world points)."""
    s = c["stride"]
    d = torch.from_numpy(c["depth"][..., 0])[:, s // 2::s, s // 2::s]
    if c["worlds"] is None:
        ra = torch.from_numpy(c["ray_a"])[:, s // 2::s, s // 2::s]
        rb = torch.from_numpy(c["ray_b"])[:, s // 2::s, s // 2::s]
        w = torch.stack([ra[..., k] + rb[..., k] * d for k in range(3)], -1)
    else:
        w = torch.from_numpy(c["worlds"])
    bx, by, bz = c["brick_res"]
    bs = c["brick_size"]
    p = w.reshape(-1, 3)
    valid = ((d > 0.0) & (d < 1.0)).reshape(-1)
    hi = torch.tensor([bx - 1, by - 1, bz - 1], dtype=torch.int32)
    zero = torch.zeros_like(hi)
    bmin = torch.from_numpy(c["bbox_min"])
    idx = torch.minimum(torch.maximum(torch.floor((p - bmin) / bs)
                                      .to(torch.int32), zero), hi)
    own = (idx[:, 2] * by + idx[:, 1]) * bx + idx[:, 0]
    diff = p - ((idx.to(torch.float32) + 0.5) * bs + bmin)
    dab = torch.abs(diff)
    top = dab.max(dim=-1, keepdim=True).values
    off = torch.sign(diff * torch.where(dab < top, 0.0, 1.0)).to(torch.int32)
    nidx = torch.minimum(torch.maximum(idx + off, zero), hi)
    nbr = (nidx[:, 2] * by + nidx[:, 1]) * bx + nidx[:, 0]
    near = dab[:, 0] > bs * 0.1
    own = torch.where(valid, own, -1).numpy().astype(np.int64)
    nbr = torch.where(valid & near, nbr, -1).numpy().astype(np.int64)
    return own, nbr


def mark_launch(pixels, bins):
    """csrc/fuse.cu mark_plan on a card of SMS SMs (resident blocks at
    least MARK_BLOCKS_PER_SM): (blocks, shared histogram, list capacity)."""
    smem = bins * 4 <= MARK_SMEM_MAX
    cap_list = min(MARK_LIST_MAX, (MARK_SMEM_MAX - bins * 4) // 4) if smem \
        else 0
    warp_pixels = 32 * MARK_UNROLL
    chunks = -(-pixels // warp_pixels)
    want = -(-chunks // (MARK_THREADS // 32))
    cap = SMS * MARK_BLOCKS_PER_SM
    return max(1, min(cap, max(want, min(chunks, SMS)))), smem, cap_list


def match_any(keys):
    """__match_any_sync over a warp: each lane's mask of the lanes holding
    its key."""
    keys = np.asarray(keys)
    return [int(sum(1 << m for m in np.flatnonzero(keys == k))) for k in keys]


def mark_model(own, nbr, bins, add, blocks=None, list_cap=None):
    """The counts one mark launch adds up, and how many blocks flushed
    their whole histogram: each warp's 32 x MARK_UNROLL pixels a step
    (grid-stride over the warps), each k-slice's own then neighbour keys;
    with a shared histogram (bins within MARK_SMEM_MAX) each lane adds
    ``add`` to its block's histogram (a first add listing its bin), then
    each block's listed bins (all of them past the list's capacity) go to
    the counts; without one, the keys grouped by match_any and the lowest
    lane of a group adding popc x add to the counts."""
    pixels = own.size
    b_auto, smem, cap_auto = mark_launch(pixels, bins)
    blocks = b_auto if blocks is None else blocks
    list_cap = cap_auto if list_cap is None else list_cap
    warps_a_block = MARK_THREADS // 32
    hist = np.zeros((blocks, bins), np.int64)
    lists = [[] for _ in range(blocks)]
    WP = 32 * MARK_UNROLL
    n_warps = blocks * warps_a_block
    for wg in range(n_warps):
        blk = wg // warps_a_block
        for w in range(wg, -(-pixels // WP), n_warps):
            for k in range(MARK_UNROLL):
                p = w * WP + k * 32 + np.arange(32)
                inb = p < pixels
                for keys in (own, nbr):
                    key = np.where(inb, keys[np.minimum(p, pixels - 1)], -1)
                    if smem:
                        # an atomic a lane, a first add listing its bin
                        for lane in np.flatnonzero(key >= 0):
                            if hist[blk, key[lane]] == 0:
                                lists[blk].append(key[lane])
                            hist[blk, key[lane]] += add
                        continue
                    masks = match_any(key)
                    for lane in range(32):
                        if key[lane] < 0 or (masks[lane] & -masks[lane]) \
                                != 1 << lane:
                            continue
                        hist[blk, key[lane]] += bin(masks[lane]).count("1") \
                            * add
    counts = np.zeros(bins, np.int64)
    whole = 0
    if not smem:
        # no histogram: the leaders added to the counts themselves
        return hist.sum(axis=0), whole
    for blk in range(blocks):
        if len(lists[blk]) <= list_cap:
            for k in lists[blk]:
                counts[k] += hist[blk, k]
        else:
            whole += 1
            counts += hist[blk]
    return counts, whole


MODEL_CASES = ("stride3_models", "stride2_models", "stride1_models_one_brick",
               "stride1_worlds_corner", "stride3_models_corner",
               "stride3_worlds_5cm", "stride1_worlds_one_brick_5cm")


@pytest.mark.parametrize("name", MODEL_CASES)
def test_mark_model_is_the_bincount(name):
    """The aggregated adds, the histograms and their lists add up to
    np.bincount of the pixels' keys, and to mark_pixels_plain."""
    c = fuse_cases.mark_case(name)
    own, nbr = pixel_keys(c)
    bx, by, bz = c["brick_res"]
    bins, add = bx * by * bz, c["stride"] ** 2
    counts, _ = mark_model(own, nbr, bins, add)
    keys = np.concatenate([own[own >= 0], nbr[nbr >= 0]])
    np.testing.assert_array_equal(counts,
                                  np.bincount(keys, minlength=bins) * add)
    depth = torch.from_numpy(c["depth"])[..., 0]
    t = {k: None if c[k] is None else torch.from_numpy(c[k])
         for k in ("ray_a", "ray_b", "worlds")}
    want = port_bricks.mark_pixels_plain(
        depth, torch.from_numpy(c["bbox_min"]), c["brick_size"],
        c["brick_res"], c["stride"], **t)
    np.testing.assert_array_equal(counts.reshape(bz, by, bx), want.numpy())


@pytest.mark.parametrize("name", ["stride1_models_one_brick",
                                  "stride1_worlds_one_brick_5cm",
                                  "stride1_worlds_corner"])
def test_mark_model_gathered_points(name):
    """Every pixel near one brick's centre: each warp's valid lanes form
    one group (one aggregated add a warp step to global counts; 32 lanes
    on one shared bin); at one corner the pixels reach the eight bricks
    around it."""
    c = fuse_cases.mark_case(name)
    own, nbr = pixel_keys(c)
    gx, gy, gz = fuse_cases.GATHER_BRICK
    bx, by, _ = c["brick_res"]
    centre = (gz * by + gy) * bx + gx
    if "one_brick" in name:
        assert set(own[own >= 0]) == {centre} and (nbr < 0).all()
    else:
        hit = set(own[own >= 0]) | set(nbr[nbr >= 0])
        corner = {((gz - dz) * by + gy - dy) * bx + gx - dx
                  for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)}
        assert hit <= corner and len(hit) >= 4
        return
    # one group of valid lanes a warp step (and one of invalid ones)
    p = np.arange(32)
    assert len(set(match_any(own[p]))) <= 2


def test_mark_model_past_the_list():
    """Blocks that touch more bins than their list holds flush their whole
    histograms, and the counts stay the bincount."""
    c = fuse_cases.mark_case("stride1_worlds_every_brick")
    own, nbr = pixel_keys(c)
    bins = int(np.prod(c["brick_res"]))
    counts, whole = mark_model(own, nbr, bins, 1, blocks=4, list_cap=300)
    assert whole == 4
    keys = np.concatenate([own[own >= 0], nbr[nbr >= 0]])
    np.testing.assert_array_equal(counts, np.bincount(keys, minlength=bins))
    counts2, whole2 = mark_model(own, nbr, bins, 1)
    assert whole2 == 0
    np.testing.assert_array_equal(counts2, counts)


@pytest.mark.parametrize("pixels,bins", [(96_444, 8_800), (868_352, 8_800),
                                         (9_348, 8_800), (100, 8_800),
                                         (1, 8_800), (868_352, 70_400),
                                         (96_444, 12_288), (96_444, 12_289)])
def test_mark_launch(pixels, bins):
    """The grid covers every warp step, has a block an SM while the pixels
    last, and stays co-resident; the histogram and its list fit the
    shared-memory limit."""
    blocks, smem, cap = mark_launch(pixels, bins)
    chunks = -(-pixels // (32 * MARK_UNROLL))
    assert 1 <= blocks <= SMS * MARK_BLOCKS_PER_SM
    assert blocks >= min(chunks, SMS)
    assert smem == (bins * 4 <= MARK_SMEM_MAX)
    if smem:
        assert bins * 4 + cap * 4 <= MARK_SMEM_MAX and cap >= 0


# ---- edge cases of the twins against the JAX package ---------------------

def _edge_mark_case(kind, seed):
    """A 5 cm or 10 cm marking case with depths of exactly 0, 1, NaN and
    just inside (0, 1) ("depths"), or world points on brick faces and far
    outside the box ("faces")."""
    rng = np.random.default_rng(seed)
    c = fuse_cases.mark_case("stride1_worlds" if kind == "faces"
                             else "stride3_models", seed)
    d = c["depth"][..., 0]
    if kind == "depths":
        pick = rng.choice(6, d.shape)
        vals = np.array([0.0, 1.0, np.nan, 1e-7, np.float32(1) -
                         np.float32(6e-8), 0.5], np.float32)
        keep = rng.random(d.shape) < 0.4
        d[keep] = vals[pick[keep]]
    else:
        d[...] = 0.5
        w = c["worlds"]
        lo = np.asarray(fuse_cases.BOX_MIN)
        bs = c["brick_size"]
        faces = np.round((w - lo) / bs) * bs + lo
        axis = rng.integers(0, 3, w.shape[:-1])
        for a in range(3):
            m = axis == a
            w[m, a] = faces[m, a]
        far = rng.random(w.shape[:-1]) < 0.1
        w[far] = rng.choice([-10.0, 10.0], (int(far.sum()), 3))
    return c


def _jax_counts(c):
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
    return np.asarray(jax_bricks.mark_bricks(
        worlds, valid, jnp.asarray(c["bbox_min"]), c["brick_size"],
        c["brick_res"])) * (s * s)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["depths", "faces"])
def test_mark_edge_cases_match_jax(kind, seed):
    """mark_pixels on the CPU (the twin) against the JAX package's
    mark_bricks on depths of 0, 1, NaN and just inside, and on points on
    brick faces and far outside the box: equal counts, and the model's
    aggregation of the same keys equal to both."""
    c = _edge_mark_case(kind, seed)
    depth = torch.from_numpy(c["depth"])[..., 0]
    t = {k: None if c[k] is None else torch.from_numpy(c[k])
         for k in ("ray_a", "ray_b", "worlds")}
    got = port_bricks.mark_pixels(depth, torch.from_numpy(c["bbox_min"]),
                                  c["brick_size"], c["brick_res"],
                                  c["stride"], **t).numpy()
    np.testing.assert_array_equal(got, _jax_counts(c))
    own, nbr = pixel_keys(c)
    counts, _ = mark_model(own, nbr, got.size, c["stride"] ** 2)
    np.testing.assert_array_equal(counts, got.reshape(-1))
    if kind == "faces":
        bx, by, bz = c["brick_res"]
        assert got[0, 0, 0] > 0 and got[bz - 1, by - 1, bx - 1] > 0


@pytest.mark.parametrize("taps", ["nearest", "bilinear"])
@pytest.mark.parametrize("name", ["big_bricks_capacity_below",
                                  "six_sensors", "padded_capacity_below"])
def test_integrate_edge_maps_match_jax(name, taps):
    """integrate_compact on the CPU (the twin) against the JAX package's
    occupied_brick_ids + integrate_bricks on maps holding depths of exactly
    0 and 1 and NaN, and qualities of 0: the volume within rtol 1e-4,
    NaN where JAX has NaN; the bricks past the capacity cleared."""
    c = fuse_cases.integrate_case(f"{taps}_{name}", seed=3)
    rng = np.random.default_rng(7)
    d = c["depths"]
    pick = rng.random(d.shape)
    d[pick < 0.05] = 0.0
    d[(pick >= 0.05) & (pick < 0.1)] = 1.0
    d[(pick >= 0.1) & (pick < 0.12)] = np.nan
    c["qualities"][rng.random(d.shape) < 0.1] = 0.0
    keys = ("proj_bricks", "counts", "min_voxels", "capacity", "depths",
            "qualities", "silhouettes", "limit", "vol_shape", "brick_vox")
    args = [torch.from_numpy(c[k]) if isinstance(c[k], np.ndarray) else c[k]
            for k in keys]
    kw = dict(carve_sil_threshold=c["carve_sil_threshold"],
              phantom_hull=c["phantom_hull"], taps=c["taps"])
    got = port_tsdf.integrate_compact(*args, **kw).numpy()
    ids = jax_tsdf.occupied_brick_ids(jnp.asarray(c["counts"]),
                                      c["min_voxels"], c["capacity"])
    want = np.asarray(jax_tsdf.integrate_bricks(
        jnp.asarray(c["proj_bricks"]), ids, jnp.asarray(c["depths"]),
        jnp.asarray(c["qualities"]), jnp.asarray(c["silhouettes"]),
        c["limit"], c["vol_shape"], c["brick_vox"], **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                               equal_nan=True)
    if c["capacity"] < c["occupied"]:
        v = c["brick_vox"]
        occ = np.flatnonzero(c["counts"].reshape(-1) > c["min_voxels"])
        slot = np.full(c["counts"].size, -1)
        slot[occ[:c["capacity"]]] = 0
        listed = _listed_voxels(c["vol_shape"], v, slot)
        assert (got[~listed] == -c["limit"]).all()


@pytest.mark.parametrize("models", [True, False])
@pytest.mark.parametrize("stride", [1, 3])
def test_mark_edge_depths_match_jax_pipeline(scene, stride, models):
    """The pipelines' marking on the verify scene's maps with seeded pixels
    set to depths of exactly 0, 1, NaN and just inside (0, 1), through the
    pixel models and through the calibration volumes: the port's
    _mark_bricks (its twin on the CPU) equal to the JAX pipeline's."""
    import dataclasses

    s = scene
    rng = np.random.default_rng(10 * stride + models)
    arrays = {k: v.copy() for k, v in jax_arrays(s["maps"]).items()}
    d = arrays["depth"][..., 0]
    vals = np.array([0.0, 1.0, np.nan, 1e-7,
                     np.float32(1) - np.float32(6e-8)], np.float32)
    pick = rng.random(d.shape) < 0.3
    d[pick] = vals[rng.integers(0, vals.size, int(pick.sum()))]
    jmaps = dataclasses.replace(s["maps"], depth=jnp.asarray(arrays["depth"]))
    pmaps = convert.sensor_maps_from_numpy(arrays, device="cpu")
    jpipe = _with_stride(s["pipe"], stride)
    want = jpipe._mark_bricks(jpipe.calib, s["pm"] if models else None,
                              jmaps)
    ppipe = _with_stride(s["ppipe"], stride)
    got = ppipe._mark_bricks(s["ppm"] if models else None, pmaps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got > 0).sum()) > 20
