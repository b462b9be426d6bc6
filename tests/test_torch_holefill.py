"""The port's pull-push fill on the CPU: the per-axis taps of the push
kernel against the twin's resample matrices, the CPU dispatch, the plain
fill against the JAX package, and the algorithm of csrc/holefill.cu
written as vectorized numpy float32 against the plain twin.

``_pull_as_kernel`` and ``_push_as_kernel`` follow the kernels step for
step: clamped tap indices in place of the replicate pad, the taps in the
kernel's order, the push's resampling through ``push_taps`` (unpacked at
the kernel's offsets), vertical taps before horizontal ones. The pull
must equal ``_pull_planar`` bit for bit and the push ``_push_planar``
within the fill's tolerance (atol 1e-6: the twin resamples by matrix
products), with the chosen level equal, before the kernels themselves are
held to the twin on the card (tests/test_torch_kernels.py,
``cuda``-marked).
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
# (37 -> 18 -> 9 -> 4 -> 2 -> 1: 6 levels), one of 2 levels and one of 1
FILL_CASES = [((81, 97), 7, "mixed"), ((37, 150), 7, "mixed"),
              ((81, 97), 7, "invalid"), ((81, 97), 7, "valid"),
              ((53, 40), 5, "mixed"), ((2, 3), 7, "mixed"),
              ((1, 5), 7, "mixed")]


@pytest.mark.parametrize("shape,lods,kind", FILL_CASES)
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

def _pull_as_kernel(planes):
    """csrc/holefill.cu pull_kernel over numpy f32 [r, g, b, alpha, depth]."""
    r, g, b, alpha, depth = planes
    H, W = depth.shape
    H2, W2 = max(H // 2, 1), max(W // 2, 1)
    j = np.arange(H2)[:, None]
    i = np.arange(W2)[None, :]
    ry = [np.clip(2 * j + k - 1, 0, H - 1) for k in range(4)]
    cx = [np.clip(2 * i + k - 1, 0, W - 1) for k in range(4)]
    zero = np.zeros((H2, W2), F)
    sum_d, cnt, taps = zero, zero, []
    for dx in range(4):
        for dy in range(4):
            valid = alpha[ry[dy], cx[dx]] > 0
            d = depth[ry[dy], cx[dx]]
            sum_d = sum_d + np.where(valid, d, F(0))
            cnt = cnt + np.where(valid, F(1), F(0))
            taps.append((dy, dx, valid, d))
    depth_av = sum_d / np.maximum(cnt, F(1))
    tr = tg = tb = total_d = total_w = zero
    for dy, dx, valid, d in taps:
        keep = valid & (d >= depth_av)
        tr = tr + np.where(keep, r[ry[dy], cx[dx]], F(0))
        tg = tg + np.where(keep, g[ry[dy], cx[dx]], F(0))
        tb = tb + np.where(keep, b[ry[dy], cx[dx]], F(0))
        total_d = total_d + np.where(keep, d, F(0))
        total_w = total_w + np.where(keep, F(1), F(0))
    w = np.maximum(total_w, F(1))
    centre = depth[ry[1], cx[1]]
    hole = centre < 1
    has = cnt > 0
    return [np.where(has, tr / w, F(0)),
            np.where(has, tg / w, np.where(hole, F(0), F(1))),
            np.where(has, tb / w, F(0)),
            np.where(has, F(1), np.where(hole, F(-1), F(0))),
            np.where(has, total_d / w, centre)]


def _push_as_kernel(planes0, levels):
    """csrc/holefill.cu push_kernel: LOD 0 [r, g, b, alpha] and the coarser
    levels' [r, g, b, alpha] (numpy f32) -> (filled planes, level)."""
    H, W = planes0[0].shape
    shapes = [(H, W), *(lv[0].shape for lv in levels)]
    L = len(shapes)
    yi, xi, yw, xw = _unpack_taps(shapes)
    lv = [planes0, *levels]
    y = np.arange(H)[:, None]
    x = np.arange(W)[None, :]
    level = np.full((H, W), L - 1, np.int32)
    found = planes0[3] > 0
    level[found] = 0
    for l in range(1, L):
        a = lv[l][3][yi[l, 0][y], xi[l, 0][x]]
        new = ~found & (a > 0)
        level[new] = l
        found |= new

    def bilinear(l):
        iy0, iy1 = yi[l, 1][y], yi[l, 2][y]
        wy0, wy1 = yw[l, 0][y], yw[l, 1][y]
        ix0, ix1 = xi[l, 1][x], xi[l, 2][x]
        wx0, wx1 = xw[l, 0][x], xw[l, 1][x]
        out = []
        for P in lv[l]:
            t0 = wy0 * P[iy0, ix0] + wy1 * P[iy1, ix0]
            t1 = wy0 * P[iy0, ix1] + wy1 * P[iy1, ix1]
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
        c1 = samples[min(lvl + 1, L - 1)]
        c2 = samples[min(lvl + 2, L - 1)]
        for c in range(4):
            blend = (c1[c] * w1 + c2[c] * w2) / denom
            out[c][sel] = blend[sel]
    return out, level


KERNEL_CASES = FILL_CASES + [((720, 1280), 7, "mixed")]


@pytest.mark.parametrize("shape,lods,kind", KERNEL_CASES)
def test_kernel_algorithm_equals_the_twin(shape, lods, kind):
    """Each pull level bit-equal to _pull_planar; the push's colours within
    atol 1e-6 of _push_planar, its level equal to the twin's."""
    planes = fill_planes(17, *shape, kind)
    tp = _torch_planes(planes)
    colors, depths = holefill._build_pyramid_planar(tp[:4], tp[4], lods)
    cur = planes
    for l in range(1, len(colors)):
        cur = _pull_as_kernel(cur)
        want = [*colors[l], depths[l]]
        for got, w in zip(cur, want):
            np.testing.assert_array_equal(got.view(np.uint32),
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
