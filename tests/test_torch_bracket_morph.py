"""The bracket and morph kernels' algorithms on the CPU, as numpy / torch
models of csrc/render_stages.cu ``bracket_kernel`` and csrc/preprocess.cu
``morph_kernel``:

- the morph as the kernel runs it: a warp's 32 lanes on 128 pixels of a
  row, 4 a lane, each window row a float4 where W % 4 == 0 with the
  neighbour columns from the adjacent lanes (shuffles; the edge lanes
  load theirs), else 6 clamped loads; then the exits (a valid centre
  itself, no valid tap +0.0) and the two passes for the rest.
  Held bit for bit against ``ops/preprocess.py morph_dilate_plain`` and
  within ``ATOL["raw_depth"]`` (1e-6, tests/test_torch_preprocess.py's) of
  the JAX package's ``morph_dilate``, on ``tests/preprocess_cases.py``'s
  crafted maps at widths 1, 3, 5, 513 and multiples of 4;
- the bracket's per-slot work: each listed block's 27 taps staged by the
  kernel's index map, folded in pool3's order, and its start and lengths,
  held bit for bit against ``bracket_plain``'s rows, and its pools by
  value against ``_pool3``, on grids with NaNs, signed zeros and
  infinities at their edges and corners (``tests/bracket_cases.py``), at
  1, 4, 16 and 64 rays a block.

The constants the models use are read from the CUDA sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_recon_tpu.ops import preprocess as jax_pre

from rgbd_recon_tpu_torch.bench.kernel_inputs import morph_exits
from rgbd_recon_tpu_torch.ops import render_stages
from rgbd_recon_tpu_torch.ops.preprocess import morph_dilate_plain
from rgbd_recon_tpu_torch.ops.stage_calls import bits_equal

import bracket_cases
import preprocess_cases

torch.set_num_threads(2)

CSRC = Path(render_stages.__file__).resolve().parent.parent / "csrc"
ATOL = {"raw_depth": 1e-6}


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / source).read_text())
    return m[1]


# the morph's tile (csrc/preprocess.cu MT_W = 4 * BLOCK_X, MT_H = BLOCK_Y)
BLOCK_X, BLOCK_Y = 32, 8
MT_W, MT_H = 4 * BLOCK_X, BLOCK_Y

# (sensors, h, w): widths 1, 3, 5, 513 (the scalar path only) and
# multiples of 4 (both paths), tiles cut at the right and the bottom
MORPH_SHAPES = [(1, 9, 1), (2, 7, 3), (1, 11, 5), (1, 9, 513), (2, 10, 4),
                (1, 9, 128), (1, 17, 132), (1, 9, 512)]


def test_models_use_the_sources_constants():
    pre = "preprocess.cu"
    assert _constant(pre, "BLOCK_X") == str(BLOCK_X)
    assert _constant(pre, "BLOCK_Y") == str(BLOCK_Y)
    assert _constant(pre, "MT_W") == "4 * BLOCK_X"
    assert _constant(pre, "MT_H") == "BLOCK_Y"
    from rgbd_recon_tpu_torch.kernels.render_stages import BRACKET_MAX_B2

    rs = "render_stages.cu"
    assert _constant(rs, "BRACKET_MAX_B2") == str(BRACKET_MAX_B2)
    assert _constant(rs, "BRACKET_MAX_SLOTS") == "64"


def _valid(d):
    return (d > np.float32(0.5)) & (d < np.float32(4.5))


def morph_windows(taps):
    """The kernel's result for (P, 3, 3) windows, and the exit of each
    (0 the centre, 1 no valid tap, 2 the two passes)."""
    f32 = np.float32
    centre = taps[:, 1, 1]
    ok = _valid(taps)
    res = np.where(_valid(centre), centre, f32(0.0)).astype(f32)
    exit_ = np.where(_valid(centre), 0, np.where(ok.any((1, 2)), 2, 1))
    t = taps[exit_ == 2].reshape(-1, 9)
    v = ok[exit_ == 2].reshape(-1, 9)
    with np.errstate(invalid="ignore"):
        sum1 = np.zeros(len(t), f32)
        cnt1 = np.zeros(len(t), f32)
        for k in range(9):
            sum1 = sum1 + np.where(v[:, k], t[:, k], f32(0.0))
            cnt1 = cnt1 + np.where(v[:, k], f32(1.0), f32(0.0))
        avg = sum1 / np.maximum(cnt1, f32(1.0))
        sum2 = np.zeros(len(t), f32)
        cnt2 = np.zeros(len(t), f32)
        for k in range(9):
            keep = v[:, k] & (np.abs(avg - t[:, k]) < f32(0.2))
            sum2 = sum2 + np.where(keep, t[:, k], f32(0.0))
            cnt2 = cnt2 + np.where(keep, f32(1.0), f32(0.0))
        res[exit_ == 2] = np.where(cnt2 > 0, sum2 / np.maximum(cnt2, f32(1.0)),
                                   f32(0.0))
    return res, exit_


def morph_as_kernel(depth, vec):
    """The morph kernel over (n, h, w) f32 ``depth``: (out, exits), every
    pixel written once. A warp's 32 lanes hold 4 pixels each of a row;
    each window row is the lane's 4 pixels (a float4 on the vector path,
    zeros past the map's edge), the column left of them from the lane
    before and the one right of them from the lane after, the first and
    last lanes and a lane at the map's right edge loading theirs (clamped);
    on the scalar path 6 clamped loads a row."""
    n, h, w = depth.shape
    if vec:
        assert w % 4 == 0
    out = np.full(depth.shape, np.nan, np.float32)
    exits = np.full(depth.shape, -1)
    written = np.zeros(depth.shape, int)
    lane = np.arange(BLOCK_X)
    for s in range(n):
        d = depth[s]
        for y in range(h):
            for x0 in range(0, w, MT_W):
                x = x0 + 4 * lane
                win = np.zeros((BLOCK_X, 3, 6), np.float32)
                for r in range(3):
                    row = d[min(max(y - 1 + r, 0), h - 1)]
                    if not vec:
                        win[:, r] = row[np.clip(x[:, None] - 1 + np.arange(6),
                                                0, w - 1)]
                        continue
                    m = np.zeros((BLOCK_X, 4), np.float32)
                    inside = x < w
                    m[inside] = row[x[inside, None] + np.arange(4)]
                    left = np.roll(m[:, 3], 1)      # __shfl_up_sync
                    right = np.roll(m[:, 0], -1)    # __shfl_down_sync
                    left[0] = row[min(max(x[0] - 1, 0), w - 1)]
                    own = (lane == BLOCK_X - 1) | (x + 4 >= w)
                    right[own] = row[np.clip(x[own] + 4, 0, w - 1)]
                    win[:, r, 1:5] = m
                    win[:, r, 0], win[:, r, 5] = left, right
                for j in range(4):
                    res, ex = morph_windows(win[:, :, j: j + 3])
                    keep = x + j < w
                    out[s, y, x[keep] + j] = res[keep]
                    exits[s, y, x[keep] + j] = ex[keep]
                    written[s, y, x[keep] + j] += 1
    assert (written == 1).all()
    return out, exits


def _paths(w):
    return (True, False) if w % 4 == 0 else (False,)


def _bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("shape", MORPH_SHAPES)
def test_morph_model_matches_twin(shape):
    """The kernel's model bit for bit against morph_dilate_plain on every
    crafted map, on both paths where W % 4 == 0; its exits counted as
    kernel_inputs.morph_exits counts them."""
    for name, depth in preprocess_cases.morph_cases(3, *shape).items():
        want = morph_dilate_plain(torch.from_numpy(depth)).numpy()
        counts = morph_exits(torch, torch.from_numpy(depth))
        for vec in _paths(shape[2]):
            got, exits = morph_as_kernel(depth, vec)
            assert _bits(got, want), (name, vec)
            assert [int((exits == k).sum()) for k in range(3)] == [
                counts["valid"], counts["no_valid_tap"],
                counts["two_pass"]], name


@pytest.mark.parametrize("shape", MORPH_SHAPES)
def test_morph_model_matches_jax(shape):
    """The kernel's model within ATOL["raw_depth"] of the JAX package's
    morph_dilate (vmapped over the sensors) on every crafted map."""
    fn = jax.jit(jax.vmap(jax_pre.morph_dilate))
    for name, depth in preprocess_cases.morph_cases(4, *shape).items():
        want = np.asarray(fn(jnp.asarray(depth)))
        got, _ = morph_as_kernel(depth, shape[2] % 4 == 0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ATOL["raw_depth"], err_msg=name)


def test_morph_cases_reach_every_exit():
    """The crafted maps reach each exit, and the two passes' neighbours on
    either side of 0.2 from the first-pass mean."""
    cases = preprocess_cases.morph_cases(5, 1, 9, 513)
    seen = set()
    for name, depth in cases.items():
        _, exits = morph_as_kernel(depth, False)
        seen |= {(name, int(k)) for k in np.unique(exits)}
    assert ("all_valid", 0) in seen and ("all_invalid", 1) in seen
    for name in ("isolated_holes", "single_valid_in_hole", "near_threshold",
                 "nan_inf", "at_limits"):
        assert (name, 2) in seen, name
    windows = preprocess_cases.threshold_windows()
    diffs = [abs(preprocess_cases._morph_mean(w) - w[2, 2])
             for w in windows[1:]]
    assert not diffs[0] < np.float32(0.2) and diffs[1] < np.float32(0.2)
    assert np.nextafter(windows[1][2, 2], np.float32(2.0)) == windows[2][2, 2]


def test_morph_exits_on_a_frame():
    """morph_exits on the chain's frame: its three exits partition the
    pixels, and a hole's inside takes no valid tap."""
    depth = preprocess_cases.chain_inputs(1, 2, 37, 53, 4, 4)["depths"]
    counts = morph_exits(torch, torch.from_numpy(depth))
    assert counts["valid"] + counts["no_valid_tap"] + counts["two_pass"] \
        == counts["pixels"] == depth.size
    assert counts["no_valid_tap"] >= 2 * 2 * 3
    assert counts["two_pass"] > 0


# ---- the bracket -------------------------------------------------------------

def bracket_slots_as_kernel(g, grid, blk, s_end, flags, blk_idx):
    """Each slot's (pools (all, lo9, hi9), start, len_full, len_brkt) as
    the kernel computes them: block index, row and column once; the 27
    taps t = 9 * grid + 3 * dy + dx at the clamped window cells; the fold
    from the centre tap (t % 9 == 4) over taps 0-8 in order; a padding
    slot 0, 0, 0."""
    NB, Hb, Wb = g.NB, g.Hb, g.Wb
    live = blk_idx < NB
    b = torch.where(live, blk_idx, NB - 1)
    by = b // Wb
    bx = b - by * Wb
    taps = []
    for t in range(27):
        gi, w = divmod(t, 9)
        dy, dx = divmod(w, 3)
        y = torch.clamp(by + dy - 1, 0, Hb - 1)
        x = torch.clamp(bx + dx - 1, 0, Wb - 1)
        taps.append(grid[gi][y * Wb + x])
    all_, lo9, hi9 = taps[4], taps[13], taps[22]
    for w in range(9):
        all_ = torch.minimum(all_, taps[w])
        lo9 = torch.minimum(lo9, taps[9 + w])
        hi9 = torch.maximum(hi9, taps[18 + w])
    s_start, length, end = blk[b, 7], blk[b, 6], s_end[b]
    found = ((flags[b] >> 1) & 1).to(torch.bool)
    ok = ((all_ > 0.5) & ((hi9 - lo9) < g.bracket_max_steps * g.sd)
          & ((lo9 - s_start) < 2.0 * g.brick_norm + g.pad))
    margin = g.bracket_margin_steps * g.sd
    if g.per_block:
        spread = 0.125 * (hi9 - lo9)
        lo_b, hi_b = taps[13], taps[22]
        b_lo = torch.where(torch.isfinite(lo_b), lo_b, s_start) - margin \
            - spread
        b_hi = torch.where(torch.isfinite(hi_b), hi_b, end) + margin + spread
    else:
        b_lo, b_hi = lo9 - margin, hi9 + margin
    start = torch.where(ok, torch.maximum(b_lo, s_start), s_start)
    len_brkt = torch.where(
        found & ok, torch.clamp_min(torch.minimum(b_hi, end) - start, 0.0),
        length)
    len_full = torch.clamp_min(torch.where(found, end - start, 0.0), 0.0)
    zero = torch.zeros_like(start)
    return ((all_, lo9, hi9), torch.where(live, start, zero),
            torch.where(live, len_full, zero),
            torch.where(live, len_brkt, zero))


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("ds,capB", [(1, 1), (1, 130), (2, 17), (4, 16),
                                     (4, 33), (8, 5), (8, 117)])
def test_bracket_slot_model_matches_twin(ds, capB, per_block):
    """The kernel's per-slot work against bracket_plain bit for bit: the
    rows' lengths, their start points from the slot's start along the
    twin's directions, and the pools against _pool3 at the listed
    blocks."""
    for seed in (1, 2, 3):
        g, grid, blk, s_end, flags, blk_idx, cam = \
            bracket_cases.bracket_case(seed, ds, capB, "cpu",
                                       per_block=per_block)
        want = render_stages.bracket_plain(g, grid, blk, s_end, flags,
                                           blk_idx, cam)
        pools, start, len_full, len_brkt = bracket_slots_as_kernel(
            g, grid, blk, s_end, flags, blk_idx)
        B2 = g.B2

        def rays(x):
            return x[:, None].expand(capB, B2).reshape(-1)

        assert bits_equal(want[:, 6], rays(len_full))
        assert bits_equal(want[:, 7], rays(len_brkt))
        pos0 = torch.stack([cam.eye_vol[a] + want[:, 3 + a] * rays(start)
                            for a in range(3)], -1)
        assert bits_equal(want[:, :3].contiguous(), pos0)
        live = blk_idx < g.NB
        for i, op in enumerate((torch.minimum, torch.minimum,
                                torch.maximum)):
            pooled = render_stages._pool3(grid[i].reshape(g.Hb, g.Wb),
                                          op).reshape(-1)
            # by value: CPU torch's vectorized minimum / maximum chooses a
            # NaN's payload and a zero's sign by its vector width, so a
            # plane's pool and a list's differ in those bits on the CPU
            want_pool, got_pool = pooled[blk_idx[live]], pools[i][live]
            assert torch.equal(torch.isnan(want_pool), torch.isnan(got_pool))
            assert torch.equal(torch.nan_to_num(want_pool, 7.0),
                               torch.nan_to_num(got_pool, 7.0))
        # the grids hold the specials the fold must keep
        assert bool(torch.isnan(grid).any())
        assert bool((torch.isinf(grid)).any())
        assert bool(((grid == 0) & torch.signbit(grid)).any())


def test_bracket_wrapper_refuses_a_block_past_its_thread_block():
    """ds = 33 (1,089 rays a block) is past the kernel's 1,024-thread
    block: the wrapper raises before it looks at the tensors."""
    from rgbd_recon_tpu_torch.kernels.render_stages import bracket_cuda

    g, grid, blk, s_end, flags, blk_idx, cam = bracket_cases.bracket_case(
        1, 33, 4, "cpu", Hb=2, Wb=3)
    with pytest.raises(ValueError, match="at most 1024"):
        bracket_cuda(g, grid, blk, s_end, flags, blk_idx, cam)


def test_variant_sources_replace_the_kept_code():
    """bench/bracket_morph_variants.py's variants: each kept text found
    once in the CUDA sources and replaced, the rest of both files
    unchanged; the kept variant the sources themselves."""
    from rgbd_recon_tpu_torch.bench import bracket_morph_variants as bmv

    texts = tuple(s.read_text() for s in bmv.SOURCES)
    assert bmv.variant_sources(texts, bmv.VARIANTS["kept"]) == texts
    for name, changes in bmv.VARIANTS.items():
        got = bmv.variant_sources(texts, changes)
        for k, kept, other in changes:
            assert other in got[k] and kept not in got[k], name
            assert got[k].replace(other, kept) == texts[k], name
        changed = {k for k, _, _ in changes}
        for k in set(range(2)) - changed:
            assert got[k] == texts[k], name
    with pytest.raises(ValueError, match="not found once"):
        bmv.variant_sources(texts, ((0, "no such text", ""),))
