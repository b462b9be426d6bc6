"""The port's pull-push fill on the CPU: the per-axis taps of the push
kernel against the twin's resample matrices, the CPU dispatch, the plain
fill against the JAX package, and the algorithm of csrc/holefill.cu
written as vectorized numpy float32 against the plain twin.

``_pull_launch_as_kernel`` and ``_push_as_kernel`` follow the kernels
step for step. The pull, every tile of a launch at once: the level-l
window staged at clamped indices, a tap read at its unclamped offset in
it, the taps in the kernel's order; for two levels a launch the level
l + 1 region with its clamped halo, the texels each tile owns scattered
(each exactly once), then level l + 2 from the region. The push: the
per-axis taps through ``push_taps`` (unpacked at the kernel's offsets),
each tile's rectangles reduced from its staged taps and laid out by
``push_layout``, every coarser texel read from them, vertical taps before
horizontal ones. The pull must equal ``_pull_planar`` bit for bit and the
push ``_push_planar`` within the fill's tolerance (atol 1e-6: the twin
resamples by matrix products), with the chosen level equal, before the
kernels themselves are held to the twin on the card
(tests/test_torch_kernels.py, ``cuda``-marked).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.ops import holefill as jax_holefill

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.ops import holefill

from holefill_cases import fill_planes

torch.set_num_threads(2)

F = np.float32
# the fill's tolerances (tests/test_torch_render.py test_holefill_matches)
COLOR_ATOL = 1e-6


def _axis_pairs():
    """(n_out, n_in) of every resample of a 1280x720 7-LOD pyramid, and of
    odd sizes (81x97 and the early-stopping 37x150)."""
    pairs = set()
    for H, W in ((720, 1280), (81, 97), (37, 150)):
        for h, w in holefill.pyramid_shapes(H, W, 7)[1:]:
            pairs |= {(H, h), (W, w)}
    return sorted(pairs)


@pytest.mark.parametrize("n_out,n_in", _axis_pairs())
def test_axis_taps_reproduce_the_matrices(n_out, n_in):
    """The push kernel's taps give back _nearest_matrix and
    _bilinear_matrix exactly (the f32 entries, merged edge taps
    included)."""
    rows = np.arange(n_out)
    near = np.zeros((n_out, n_in), F)
    near[rows, holefill.nearest_taps(n_out, n_in)] = 1.0
    np.testing.assert_array_equal(near, holefill._nearest_matrix(n_out, n_in))
    idx, w = holefill.bilinear_taps(n_out, n_in)
    assert idx.dtype == np.int32 and w.dtype == F
    assert bool((idx[0] <= idx[1]).all())
    bil = np.zeros((n_out, n_in), F)
    np.add.at(bil, (rows, idx[0]), w[0])
    np.add.at(bil, (rows, idx[1]), w[1])
    want = holefill._bilinear_matrix(n_out, n_in)
    np.testing.assert_array_equal(bil.view(np.uint32), want.view(np.uint32))


def test_pyramid_shapes_are_the_twins():
    """pyramid_shapes names the levels _build_pyramid_planar makes,
    early stops included."""
    for (H, W), lods in (((720, 1280), 7), ((37, 150), 7), ((2, 3), 7),
                         ((1, 5), 7), ((9, 8), 1), ((64, 48), 3)):
        planes = [torch.zeros((H, W)) for _ in range(4)]
        colors, _ = holefill._build_pyramid_planar(planes, torch.ones(H, W),
                                                   lods)
        assert holefill.pyramid_shapes(H, W, lods) == [
            tuple(c[0].shape) for c in colors]
    assert len(holefill.pyramid_shapes(720, 1280, 7)) == 7
    assert len(holefill.pyramid_shapes(37, 150, 7)) == 6


def _unpack_taps(shapes):
    """push_taps at csrc/holefill.cu's offsets: yi, xi (L, 3, n) int32 and
    yw, xw (L, 2, n) f32."""
    (H, W), L = shapes[0], len(shapes)
    t = holefill.push_taps(tuple(shapes))
    assert t.dtype == np.int32 and t.size == L * 5 * (H + W)
    yi = t[:L * 3 * H].reshape(L, 3, H)
    xi = t[L * 3 * H: L * 3 * (H + W)].reshape(L, 3, W)
    yw = t[L * 3 * (H + W): L * (5 * H + 3 * W)].view(F).reshape(L, 2, H)
    xw = t[L * (5 * H + 3 * W):].view(F).reshape(L, 2, W)
    return yi, xi, yw, xw


def test_push_taps_pack_every_level():
    shapes = holefill.pyramid_shapes(81, 97, 7)
    yi, xi, yw, xw = _unpack_taps(shapes)
    for l, (h, w) in enumerate(shapes[1:], 1):
        np.testing.assert_array_equal(yi[l, 0], holefill.nearest_taps(81, h))
        np.testing.assert_array_equal(xi[l, 0], holefill.nearest_taps(97, w))
        for got, want in ((yi[l, 1:], holefill.bilinear_taps(81, h)[0]),
                          (yw[l], holefill.bilinear_taps(81, h)[1]),
                          (xi[l, 1:], holefill.bilinear_taps(97, w)[0]),
                          (xw[l], holefill.bilinear_taps(97, w)[1])):
            np.testing.assert_array_equal(got, want)
    assert not yi[0].any() and not xw[0].any()


def _torch_planes(planes):
    return [torch.from_numpy(p) for p in planes]


def test_cpu_fill_takes_the_plain_path():
    """On CPU tensors the dispatch runs the plain twin (strided views of an
    (H, W, 4) image too) and launches nothing."""
    kernels.reset_launch_counts()
    planes = _torch_planes(fill_planes(4, 45, 61))
    got_c, got_d = holefill.fill_colors_planar(planes[:4], planes[4], 7)
    want_c, want_d = holefill.fill_colors_plain(planes[:4], planes[4], 7)
    rgba = torch.stack(planes[:4], dim=-1)
    view_c, _ = holefill.fill_colors_planar(
        [rgba[..., i] for i in range(4)], planes[4], 7)
    for g, v, w in zip(got_c, view_c, want_c):
        assert torch.equal(g, w) and torch.equal(v, w)
    assert got_d is planes[4] and torch.equal(want_d, planes[4])
    assert all(n == 0 for n in kernels.launch_counts().values())


# (H, W), num_lods, kind: odd sizes, a pyramid that stops before num_lods
# (37 -> 18 -> 9 -> 4 -> 2 -> 1: 6 levels), one of 2 levels and one of 1;
# then the small shapes of the pull's tile test (a single tile straddling
# every edge)
FILL_CASES = [((81, 97), 7, "mixed"), ((37, 150), 7, "mixed"),
              ((81, 97), 7, "invalid"), ((81, 97), 7, "valid"),
              ((53, 40), 5, "mixed"), ((2, 3), 7, "mixed"),
              ((1, 5), 7, "mixed"), ((2, 2), 7, "mixed"),
              ((3, 5), 7, "mixed"), ((5, 3), 7, "mixed")]


@pytest.mark.parametrize("shape,lods,kind",
                         FILL_CASES + [((720, 1280), 7, "mixed")])
def test_fill_matches_jax(shape, lods, kind):
    """The port's plain fill (the kernels' twin) against the JAX package's
    fill_colors_planar: colour atol 1e-6, depth exact."""
    planes = fill_planes(11, *shape, kind)
    cj, dj = jax_holefill.fill_colors_planar(
        [jnp.asarray(p) for p in planes[:4]], jnp.asarray(planes[4]), lods)
    tp = _torch_planes(planes)
    cp, dp = holefill.fill_colors_planar(tp[:4], tp[4], lods)
    assert len(cp) == 4
    for a, b in zip(cp, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=COLOR_ATOL)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))


# ---- the kernels' algorithm in numpy -----------------------------------

def _pull_math(tap):
    """csrc/holefill.cu pull_texel over numpy f32: ``tap(dy, dx)`` -> (r, g,
    b, valid, d) of the 16 taps, any common shape -> [r, g, b, alpha,
    depth]. A colour that is not kept adds +0 (the kernel skips its
    load)."""
    sum_d = cnt = F(0)
    taps = []
    for dx in range(4):
        for dy in range(4):
            r, g, b, valid, d = tap(dy, dx)
            sum_d = sum_d + np.where(valid, d, F(0))
            cnt = cnt + np.where(valid, F(1), F(0))
            taps.append((r, g, b, valid, d))
    depth_av = sum_d / np.maximum(cnt, F(1))
    tr = tg = tb = total_d = total_w = F(0)
    for r, g, b, valid, d in taps:
        keep = valid & (d >= depth_av)
        tr = tr + np.where(keep, r, F(0))
        tg = tg + np.where(keep, g, F(0))
        tb = tb + np.where(keep, b, F(0))
        total_d = total_d + np.where(keep, d, F(0))
        total_w = total_w + np.where(keep, F(1), F(0))
    w = np.maximum(total_w, F(1))
    centre = taps[1 * 4 + 1][4]
    hole = centre < 1
    has = cnt > 0
    return [np.where(has, tr / w, F(0)),
            np.where(has, tg / w, np.where(hole, F(0), F(1))),
            np.where(has, tb / w, F(0)),
            np.where(has, F(1), np.where(hole, F(-1), F(0))),
            np.where(has, total_d / w, centre)]


def _half(n):
    return max(n // 2, 1)


def _pull_launch_as_kernel(planes, steps, tile=None):
    """csrc/holefill.cu pull_tile_kernel<steps> over numpy f32 [r, g, b,
    alpha, depth] of a level, every tile of ``tile`` (rows, columns) of the
    launch's last level at once: the staged level-l window (each slot the
    texel at its clamped index), at ``steps`` 2 the level l + 1 region with
    its halo computed at clamped indices from the window and the colour
    planes, the texels each tile owns scattered to level l + 1, then level
    l + 2 from the region alone -> the ``steps`` levels; every texel of
    every level is written by exactly one tile."""
    r, g, b, alpha, depth = planes
    H, W = depth.shape
    H1, W1 = _half(H), _half(W)
    H2, W2 = _half(H1), _half(W1)
    ty, tx = tile or holefill.PULL_TILES[steps]
    Ho, Wo = (H2, W2) if steps == 2 else (H1, W1)
    ta = np.arange(-(-Ho // ty)) * ty                   # tile origins
    tb = np.arange(-(-Wo // tx)) * tx
    nty, ntx = len(ta), len(tb)
    RY, RX = (2 * ty + 2, 2 * tx + 2) if steps == 2 else (ty, tx)
    ry0, rx0 = (2 * ta - 1, 2 * tb - 1) if steps == 2 else (ta, tb)
    wy0, wx0 = 2 * ry0 - 1, 2 * rx0 - 1
    WY, WX = 2 * RY + 2, 2 * RX + 2
    wrow = np.clip(wy0[:, None] + np.arange(WY), 0, H - 1)
    wcol = np.clip(wx0[:, None] + np.arange(WX), 0, W - 1)
    s_d = depth[wrow[:, None, :, None], wcol[None, :, None, :]]
    s_v = alpha[wrow[:, None, :, None], wcol[None, :, None, :]] > 0
    ti = np.arange(nty)[:, None, None, None]
    tj = np.arange(ntx)[None, :, None, None]
    uy = ry0[:, None] + np.arange(RY)                  # unclamped
    ux = rx0[:, None] + np.arange(RX)
    R, C = np.clip(uy, 0, H1 - 1), np.clip(ux, 0, W1 - 1)
    by, bx = 2 * R - 1 - wy0[:, None], 2 * C - 1 - wx0[:, None]
    assert by.min() >= 0 and by.max() + 3 < WY
    assert bx.min() >= 0 and bx.max() + 3 < WX

    def tap(dy, dx):
        iy, ix = (by + dy)[:, None, :, None], (bx + dx)[None, :, None, :]
        gr = np.clip(2 * R - 1 + dy, 0, H - 1)[:, None, :, None]
        gc = np.clip(2 * C - 1 + dx, 0, W - 1)[None, :, None, :]
        return (r[gr, gc], g[gr, gc], b[gr, gc], s_v[ti, tj, iy, ix],
                s_d[ti, tj, iy, ix])

    region = _pull_math(tap)                   # (nty, ntx, RY, RX) each

    def scatter(values, rows, cols, own_y, own_x, h, w):
        out = np.zeros((5, h, w), F)
        count = np.zeros((h, w), np.int64)
        mask = own_y[:, None, :, None] & own_x[None, :, None, :]
        Y = np.broadcast_to(rows[:, None, :, None], mask.shape)[mask]
        X = np.broadcast_to(cols[None, :, None, :], mask.shape)[mask]
        for k in range(5):
            out[k][Y, X] = values[k][mask]
        np.add.at(count, (Y, X), 1)
        assert (count == 1).all()
        return list(out)

    if steps == 1:
        return [scatter(region, uy, ux, uy < H1, ux < W1, H1, W1)]
    last_y = np.where(np.arange(nty) == nty - 1, H1, 2 * ta + 2 * ty)
    last_x = np.where(np.arange(ntx) == ntx - 1, W1, 2 * tb + 2 * tx)
    level1 = scatter(region, uy, ux,
                     (uy >= 2 * ta[:, None]) & (uy < last_y[:, None]),
                     (ux >= 2 * tb[:, None]) & (ux < last_x[:, None]),
                     H1, W1)
    t, s = np.arange(ty), np.arange(tx)

    def tap2(dy, dx):
        iy = (2 * t + dy)[None, None, :, None]
        ix = (2 * s + dx)[None, None, None, :]
        r_, g_, b_, a_, d_ = (p[ti, tj, iy, ix] for p in region)
        return r_, g_, b_, a_ > 0, d_

    j, i = ta[:, None] + t, tb[:, None] + s
    level2 = scatter(_pull_math(tap2), j, i, j < H2, i < W2, H2, W2)
    return [level1, level2]


def _pull_as_kernel(planes):
    """One pull step as the kernel's one-level launch."""
    return _pull_launch_as_kernel(planes, 1)[0]


def _pull2_as_kernel(planes, tile=None):
    """Two pull steps as the kernel's two-level launch."""
    return _pull_launch_as_kernel(planes, 2, tile)


def _pull_chain_as_kernel(planes, num_levels):
    """The pyramid's levels past LOD 0 as a fill launches them: two a
    launch from the last launch's level, the last one alone."""
    levels, cur = [], planes
    while len(levels) < num_levels - 1:
        steps = min(2, num_levels - 1 - len(levels))
        levels += _pull_launch_as_kernel(cur, steps)
        cur = levels[-1]
    assert len(levels) == num_levels - 1
    assert -(-len(levels) // 2) == holefill.pull_launches(num_levels)
    return levels


TILE_SHAPES = [(2, 2), (3, 5), (5, 3), (37, 150), (81, 97), (720, 1280)]


@pytest.mark.parametrize("scale", [1, 2], ids=["tile", "half_tile"])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_pull2_tile_equals_two_twin_steps(shape, scale):
    """The two-level tile (staged clamped window, level l + 1 with its
    clamped halo, then level l + 2) bit-equal to two steps of _pull_planar
    at the kernel's tile and at half of it, the one-level launch to one
    step likewise; tiles that straddle the levels' edges included."""
    tile2, tile1 = (tuple(n // scale for n in holefill.PULL_TILES[k])
                    for k in (2, 1))
    planes = fill_planes(29, *shape)
    tp = _torch_planes(planes)
    c1, d1 = holefill._pull_planar(tp[:4], tp[4])
    c2, d2 = holefill._pull_planar(c1, d1)
    got1, got2 = _pull2_as_kernel(planes, tile2)
    for got, want in ((got1, [*c1, d1]), (got2, [*c2, d2]),
                      (_pull_launch_as_kernel(planes, 1, tile1)[0],
                       [*c1, d1])):
        for gp, w in zip(got, want):
            np.testing.assert_array_equal(gp.view(np.uint32),
                                          w.numpy().view(np.uint32))


def _push_rects(shapes, tile=holefill.PUSH_TILE):
    """csrc/holefill.cu push_tile_kernel's rectangles: for each level past
    LOD 0, (r0, nr) of every tile row and (c0, nc) of every tile column,
    the least and the span of the staged taps (nearest and both bilinear)
    of the tile's rows and columns, a row or column past the image's side
    staged as its last one."""
    (H, W), (ty, tx) = shapes[0], tile
    yi, xi, _, _ = _unpack_taps(shapes)
    rows = np.minimum(np.arange(-(-H // ty))[:, None] * ty + np.arange(ty),
                      H - 1)
    cols = np.minimum(np.arange(-(-W // tx))[:, None] * tx + np.arange(tx),
                      W - 1)
    rects = []
    for l in range(1, len(shapes)):
        ty_, tx_ = yi[l][:, rows], xi[l][:, cols]      # (3, tiles, t)
        r0, c0 = ty_.min(axis=(0, 2)), tx_.min(axis=(0, 2))
        rects.append((r0, ty_.max(axis=(0, 2)) - r0 + 1,
                      c0, tx_.max(axis=(0, 2)) - c0 + 1))
    return rects


def _push_as_kernel(planes0, levels, tile=holefill.PUSH_TILE):
    """csrc/holefill.cu push_tile_kernel: LOD 0 [r, g, b, alpha] and the
    coarser levels' [r, g, b, alpha] (numpy f32) -> (filled planes,
    level). Every coarser texel is read from the tile's staged r, g, b,
    alpha planes at the kernel's offsets (the level's rectangle at its
    ``push_layout`` offset, row-major with the rectangle's own width; NaN
    where nothing is staged), and when min(level + 1, L - 1) == min(level +
    2, L - 1) the one sample serves both."""
    H, W = planes0[0].shape
    shapes = [(H, W), *(lv[0].shape for lv in levels)]
    L = len(shapes)
    ty, tx = tile
    yi, xi, yw, xw = _unpack_taps(shapes)
    roff, texels, _ = holefill.push_layout(shapes, tile)
    rects = _push_rects(shapes, tile)
    lv = [planes0, *levels]
    staged = np.full((-(-H // ty), -(-W // tx), texels, 4), np.nan, F)
    for l, (r0, nr, c0, nc) in enumerate(rects, 1):
        reserved = (roff + [texels])[l] - roff[l - 1]
        assert (nr[:, None] * nc[None, :] <= reserved).all()
        k = np.arange(reserved)
        rr, cc = k // nc[None, :, None], k % nc[None, :, None]
        ok = k < (nr[:, None] * nc[None, :])[..., None]
        gy = np.minimum(r0[:, None, None] + rr, shapes[l][0] - 1)
        gx = np.minimum(c0[None, :, None] + cc, shapes[l][1] - 1)
        for c in range(4):
            staged[:, :, roff[l - 1] + k, c] = np.where(ok, lv[l][c][gy, gx],
                                                        np.nan)
    y = np.arange(H)[:, None]
    x = np.arange(W)[None, :]
    tyy, txx = y // ty, x // tx

    def fetch(l, iy, ix, c):
        r0, nr, c0, nc = rects[l - 1]
        ny, nx = iy - r0[tyy], ix - c0[txx]
        assert (ny >= 0).all() and (ny < nr[tyy]).all()
        assert (nx >= 0).all() and (nx < nc[txx]).all()
        return staged[tyy, txx, roff[l - 1] + ny * nc[txx] + nx, c]

    level = np.full((H, W), L - 1, np.int32)
    found = planes0[3] > 0
    level[found] = 0
    for l in range(1, L):
        a = fetch(l, yi[l, 0][y], xi[l, 0][x], 3)
        new = ~found & (a > 0)
        level[new] = l
        found |= new

    def bilinear(l):
        iy0, iy1 = yi[l, 1][y], yi[l, 2][y]
        wy0, wy1 = yw[l, 0][y], yw[l, 1][y]
        ix0, ix1 = xi[l, 1][x], xi[l, 2][x]
        wx0, wx1 = xw[l, 0][x], xw[l, 1][x]
        out = []
        for c in range(4):
            t0 = wy0 * fetch(l, iy0, ix0, c) + wy1 * fetch(l, iy1, ix0, c)
            t1 = wy0 * fetch(l, iy0, ix1, c) + wy1 * fetch(l, iy1, ix1, c)
            out.append(wx0 * t0 + wx1 * t1)
        return out

    samples = [None] + [bilinear(l) for l in range(1, L)]
    u = (x.astype(F) + F(0.5)) / F(W)
    v = (y.astype(F) + F(0.5)) / F(H)
    w1 = np.sqrt(u * u + v * v)
    w2 = F(1) - w1
    s = w1 + w2
    denom = np.where(np.abs(s) < F(1e-20), F(1e-20), s)
    out = [p.copy() for p in planes0]
    for lvl in range(1, L):
        sel = level == lvl
        l1, l2 = min(lvl + 1, L - 1), min(lvl + 2, L - 1)
        c1 = samples[l1]
        c2 = c1 if l2 == l1 else samples[l2]
        for c in range(4):
            blend = (c1[c] * w1 + c2[c] * w2) / denom
            out[c][sel] = blend[sel]
    return out, level


KERNEL_CASES = FILL_CASES + [((720, 1280), 7, "mixed")]


@pytest.mark.parametrize("shape,lods,kind", KERNEL_CASES)
def test_kernel_algorithm_equals_the_twin(shape, lods, kind):
    """Each pull level, launched as a fill launches them (two a launch),
    bit-equal to _pull_planar; the push's colours within atol 1e-6 of
    _push_planar, its level equal to the twin's."""
    planes = fill_planes(17, *shape, kind)
    tp = _torch_planes(planes)
    colors, depths = holefill._build_pyramid_planar(tp[:4], tp[4], lods)
    chain = _pull_chain_as_kernel(planes, len(colors))
    for l, got in enumerate(chain, 1):
        for g, w in zip(got, [*colors[l], depths[l]]):
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.numpy().view(np.uint32))
    H, W = shape
    got, level = _push_as_kernel(
        planes[:4], [[p.numpy() for p in c] for c in colors[1:]])
    want, depth = holefill._push_planar(colors, depths)
    assert depth is depths[0]
    _, want_level = holefill._push_level(colors, H, W)
    np.testing.assert_array_equal(level, want_level.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=COLOR_ATOL)
    if kind == "mixed" and min(shape) > 8:
        assert (level >= 2).any()


# LOD 0 shapes of the push's rectangles: odd sizes, an early stop, the
# render's frame, one-row and one-column images (no coarser level), and
# two-row and two-column ones (one)
RECT_SHAPES = [(81, 97), (37, 150), (720, 1280), (1, 97), (97, 1),
               (2, 301), (301, 2)]


@pytest.mark.parametrize("shape", RECT_SHAPES)
def test_push_rects_hold_every_tap(shape):
    """Every nearest and bilinear tap of every pixel of a tile (from the
    twin's matrices' taps, not the packed table) falls inside the
    rectangle the kernel reduces from its staged taps; each rectangle fits
    its ``push_rect_bound`` reservation, and the block's taps and
    rectangles fit the shared memory the push reserves."""
    H, W = shape
    shapes = holefill.pyramid_shapes(H, W, 7)
    ty, tx = holefill.PUSH_TILE
    rects = _push_rects(shapes)
    roff, texels, smem = holefill.push_layout(shapes)
    assert smem <= holefill.PUSH_SMEM_MAX
    assert len(roff) == len(shapes) - 1 and roff == sorted(roff)
    for l, (h, w) in enumerate(shapes[1:], 1):
        r0, nr, c0, nc = rects[l - 1]
        for n, n_l, t, lo, span, o in ((H, h, ty, r0, nr, 0),
                                       (W, w, tx, c0, nc, 1)):
            idx, _ = holefill.bilinear_taps(n, n_l)
            taps = np.stack([holefill.nearest_taps(n, n_l), *idx])
            tile = np.arange(n) // t
            assert (taps >= lo[tile]).all()
            assert (taps < (lo + span)[tile]).all()
            assert span.max() <= holefill.push_rect_bound(n, n_l, t)
        end = (roff + [texels])[l]
        assert holefill.push_rect_bound(H, h, ty) * holefill.push_rect_bound(
            W, w, tx) == end - roff[l - 1]
    if shape == (720, 1280):
        # the largest rectangle: level 1, 10 x 34 texels of an 11 x 35
        # reservation
        assert (rects[0][1].max(), rects[0][3].max()) == (10, 34)
        assert (holefill.push_rect_bound(720, 360, ty),
                holefill.push_rect_bound(1280, 640, tx)) == (11, 35)


def test_push_layout_fits_any_pyramid():
    """The deepest pyramid the wrappers take (planes of fewer than 2^31
    entries: a 46,340 x 46,340 LOD 0 halves to 16 levels at 32 LODs)
    still fits the push block's shared memory."""
    shapes = holefill.pyramid_shapes(46_340, 46_340, 32)
    assert 46_340 ** 2 < 2 ** 31 <= 46_341 ** 2
    assert len(shapes) == 16
    assert holefill.push_layout(shapes)[2] <= holefill.PUSH_SMEM_MAX


def test_tiles_are_the_kernel_sources():
    """ops/holefill.py's tiles and shared-memory limit, which the models
    above and the push's layout use, are the ones csrc/holefill.cu
    declares (on the card the library also refuses a push layout of
    another tile)."""
    import re
    from pathlib import Path

    src = (Path(holefill.__file__).parents[1] / "csrc" / "holefill.cu"
           ).read_text()
    push = re.search(r"constexpr int PTY = (\d+), PTX = (\d+),", src)
    pull = re.search(r"OY = (\d+), OX = STEPS == 2 \? (\d+) : (\d+);", src)
    smem = re.search(r"constexpr int SMEM_MAX = (\d+) \* 1024;", src)
    assert push and pull and smem
    assert tuple(map(int, push.groups())) == holefill.PUSH_TILE
    oy, ox2, ox1 = map(int, pull.groups())
    assert holefill.PULL_TILES == {2: (oy, ox2), 1: (oy, ox1)}
    assert int(smem.group(1)) * 1024 == holefill.PUSH_SMEM_MAX


def test_pyramid_offsets_place_each_level():
    """The pyramid buffer: each level (5, Hl, Wl) at a 64-float offset, no
    two overlapping; the fill's pull launches, two levels each."""
    shapes = holefill.pyramid_shapes(720, 1280, 7)
    offsets, total = holefill.pyramid_offsets(shapes)
    ends = [o + 5 * h * w for o, (h, w) in zip(offsets, shapes[1:])]
    assert all(o % 64 == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:] + [total]))
    assert [holefill.pull_launches(n) for n in range(1, 9)] == [
        0, 1, 1, 2, 2, 3, 3, 4]


# ---- the wrappers' argument checks (no nvcc needed) ---------------------

def test_fill_wrappers_reject_what_they_do_not_take():
    from rgbd_recon_tpu_torch.kernels.holefill import pull_cuda, push_cuda

    kernels.reset_launch_counts()
    p = [torch.zeros(6, 8) for _ in range(5)]
    with pytest.raises(ValueError, match="5 planes"):
        pull_cuda(p[:4])
    with pytest.raises(ValueError, match="float32"):
        pull_cuda([*p[:4], torch.zeros(6, 8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="float32"):
        pull_cuda([*p[:4], torch.zeros(1, 6, 8)])
    with pytest.raises(ValueError, match="one shape"):
        pull_cuda([*p[:4], torch.zeros(6, 9)])
    with pytest.raises(ValueError, match="entries"):
        pull_cuda([torch.zeros(0, 8) for _ in range(5)])
    with pytest.raises(ValueError, match="CUDA"):
        pull_cuda(p)
    with pytest.raises(ValueError, match="4 planes"):
        push_cuda(p, [])
    with pytest.raises(ValueError, match="CUDA"):
        push_cuda(p[:4], [torch.zeros(5, 3, 4)])
    meta = [torch.empty(6, 8, device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="CUDA"):
        pull_cuda(meta)
    assert all(n == 0 for n in kernels.launch_counts().values())
