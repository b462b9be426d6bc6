"""Pull-push hole filling over a mip pyramid (counterpart of
rgbd_recon_tpu/ops/holefill.py; the reference's fillColors,
recon_integration.cpp:280-339).

  pull  tsdf_inpaint.fs   LOD l -> l+1: 4x4 window (offsets -1..+2), invalid
        samples (alpha <= 0) dropped; of the valid ones only those at or
        behind the average depth contribute — holes fill from the far side.
  push  tsdf_colorfill.fs LOD0: walk up to the first valid level; if LOD0
        was invalid, blend the two coarser levels bilinearly with the
        reference's screen-position weight (kept for parity).

Channels are planar lists [r, g, b, a] of (H, W) tensors. The upsampling
fetches of the push are separable resample matrices (nearest selection and
GL bilinear weights), as in the JAX package.

``fill_colors_planar`` is the dispatch: CUDA tensors go to the kernels of
csrc/holefill.cu (kernels/holefill.py ``fill_cuda``: one call, a pull
launch for every two pyramid levels, one push launch), CPU tensors to the
plain twin ``fill_colors_plain``. The push kernel reads the resample
matrices as per-axis taps (``nearest_taps``, ``bilinear_taps``: each row's
nonzeros), packed by ``push_taps``; ``pyramid_offsets`` and
``push_layout`` place the levels in one buffer and the push's staged
rectangles in shared memory.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PLANES = 4  # r, g, b, alpha
# csrc/holefill.cu's tiles, (rows, columns) a block of 256 threads owns: a
# pull launch's last level by its steps (two: level l + 2, one: l + 1),
# and the push's LOD 0 (four pixels a thread); the library refuses a push
# whose ``push_layout`` is not its own tile's (push_layout_ok)
PULL_TILES = {2: (8, 8), 1: (8, 32)}
PUSH_TILE = (16, 64)
# the dynamic shared memory a push block may take (csrc/holefill.cu
# SMEM_MAX: no opt-in past 48 KB)
PUSH_SMEM_MAX = 48 * 1024
# each level of the pyramid buffer starts at a multiple of 64 floats (256
# bytes, as an allocation would)
_LEVEL_ALIGN = 64


def _pull_planar(planes: Sequence[torch.Tensor], depth: torch.Tensor):
    """One pull step: [r, g, b, a], depth (H, W) -> same at (H//2, W//2)."""
    H, W = depth.shape
    H2, W2 = max(H // 2, 1), max(W // 2, 1)
    stack = torch.stack(list(planes) + [depth])             # (5, H, W)
    q = F.pad(stack[None], (1, 2 + 2 * W2 - W, 1, 2 + 2 * H2 - H),
              mode="replicate")[0]

    def fetch(c, dy, dx):
        # input row 2j + dy sits at padded row 2j + dy + 1
        return q[c, 1 + dy: 1 + dy + 2 * H2: 2, 1 + dx: 1 + dx + 2 * W2: 2]

    sum_d = torch.zeros((H2, W2), dtype=torch.float32, device=depth.device)
    cnt = torch.zeros_like(sum_d)
    samples = []
    for dx in range(-1, 3):
        for dy in range(-1, 3):
            valid = fetch(3, dy, dx) > 0.0
            d = fetch(4, dy, dx)
            sum_d = sum_d + torch.where(valid, d, 0.0)
            cnt = cnt + valid.to(torch.float32)
            samples.append((fetch(0, dy, dx), fetch(1, dy, dx),
                            fetch(2, dy, dx), d, valid))
    depth_av = sum_d / torch.clamp_min(cnt, 1.0)

    tot = [torch.zeros_like(sum_d) for _ in range(3)]
    total_d = torch.zeros_like(sum_d)
    total_w = torch.zeros_like(sum_d)
    for r, g, b, d, valid in samples:
        keep = valid & (d >= depth_av)    # :77 — fill from the far side
        tot[0] = tot[0] + torch.where(keep, r, 0.0)
        tot[1] = tot[1] + torch.where(keep, g, 0.0)
        tot[2] = tot[2] + torch.where(keep, b, 0.0)
        total_d = total_d + torch.where(keep, d, 0.0)
        total_w = total_w + keep.to(torch.float32)
    w = torch.clamp_min(total_w, 1.0)

    center_d = fetch(4, 0, 0)
    hole = center_d < 1.0
    has = cnt > 0
    out = [
        torch.where(has, tot[0] / w, 0.0),
        torch.where(has, tot[1] / w, torch.where(hole, 0.0, 1.0)),
        torch.where(has, tot[2] / w, 0.0),
        torch.where(has, 1.0, torch.where(hole, -1.0, 0.0)),
    ]
    d_out = torch.where(has, total_d / w, center_d)
    return out, d_out


def pyramid_shapes(H: int, W: int, num_lods: int) -> List[Tuple[int, int]]:
    """The (H, W) of each level _build_pyramid_planar makes from an (H, W)
    LOD 0: halved (floor, at least 1) while both sides exceed 1, at most
    ``num_lods`` levels."""
    shapes = [(H, W)]
    for _ in range(num_lods - 1):
        h, w = shapes[-1]
        if min(h, w) <= 1:
            break
        shapes.append((max(h // 2, 1), max(w // 2, 1)))
    return shapes


def pull_launches(num_levels: int) -> int:
    """The pull kernel's launches for a pyramid of ``num_levels`` levels:
    two levels a launch, the last one alone when the steps are odd."""
    return num_levels // 2


def pyramid_offsets(shapes) -> Tuple[List[int], int]:
    """(offset of each level past LOD 0, floats in all) of the pyramid
    ``shapes`` (LOD 0 first) in one buffer: level l as (5, Hl, Wl) at its
    offset, each offset a multiple of 64 floats."""
    offsets, total = [], 0
    for h, w in shapes[1:]:
        offsets.append(total)
        total += -(-5 * h * w // _LEVEL_ALIGN) * _LEVEL_ALIGN
    return offsets, total


def push_rect_bound(n: int, n_l: int, t: int) -> int:
    """Texels along one axis of level ``n_l`` that the taps of ``t``
    consecutive pixels of an ``n``-pixel LOD 0 axis can reach: the nearest
    and the bilinear taps of pixels y0 .. y0 + t - 1 span at most
    ceil((t - 1) n_l / n) + 2 texels when n_l <= n (one more here, for the
    float64 rounding of the bilinear centres), and never more than n_l."""
    return min(n_l, -(-(t - 1) * n_l // n) + 3)


def push_layout(shapes, tile: Tuple[int, int] = PUSH_TILE
                ) -> Tuple[List[int], int, int]:
    """(each level's rectangle offset past LOD 0, in texels of a plane;
    the texels the rectangles reserve a plane; the push block's dynamic
    shared memory in bytes) for the pyramid ``shapes``: a level reserves
    its ``push_rect_bound`` rows times columns in each of the r, g, b,
    alpha planes, and its per-axis taps take 5 words a tile row and
    column."""
    (H, W), (ty, tx) = shapes[0], tile
    roff, texels = [], 0
    for h, w in shapes[1:]:
        roff.append(texels)
        texels += push_rect_bound(H, h, ty) * push_rect_bound(W, w, tx)
    return roff, texels, 16 * texels + 4 * 5 * (ty + tx) * (len(shapes) - 1)


def _build_pyramid_planar(planes0, depth0, num_lods: int):
    colors, depths = [list(planes0)], [depth0]
    for _ in range(num_lods - 1):
        if min(depths[-1].shape) <= 1:
            break
        c, d = _pull_planar(colors[-1], depths[-1])
        colors.append(c)
        depths.append(d)
    return colors, depths


@lru_cache(maxsize=64)
def _nearest_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) selection matrix: out[i] = in[i * n_in // n_out]."""
    m = np.zeros((n_out, n_in), np.float32)
    src = np.clip(np.arange(n_out) * n_in // n_out, 0, n_in - 1)
    m[np.arange(n_out), src] = 1.0
    return m


@lru_cache(maxsize=64)
def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) GL bilinear sampling of an n_in-texel axis at the n_out
    pixel centers (x = c*n_in - 0.5, edge-clamped taps)."""
    m = np.zeros((n_out, n_in), np.float32)
    c = (np.arange(n_out, dtype=np.float64) + 0.5) / n_out
    x = c * n_in - 0.5
    x0 = np.floor(x)
    fx = x - x0
    i0 = np.clip(x0.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, n_in - 1)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), (1.0 - fx).astype(np.float32))
    np.add.at(m, (rows, i1), fx.astype(np.float32))
    return m


@lru_cache(maxsize=64)
def nearest_taps(n_out: int, n_in: int) -> np.ndarray:
    """(n_out,) int32: the column of each row's one nonzero of
    _nearest_matrix(n_out, n_in)."""
    return np.argmax(_nearest_matrix(n_out, n_in) != 0, axis=1).astype(
        np.int32)


@lru_cache(maxsize=64)
def bilinear_taps(n_out: int, n_in: int) -> Tuple[np.ndarray, np.ndarray]:
    """((2, n_out) int32 columns, (2, n_out) f32 weights): the nonzeros of
    each row of _bilinear_matrix(n_out, n_in), its f32 entries, in column
    order; a row of one nonzero (merged edge taps, or a zero weight) gives
    its column twice, the second time with weight 0."""
    m = _bilinear_matrix(n_out, n_in)
    rows, cols = np.nonzero(m)
    count = np.bincount(rows, minlength=n_out)
    if count.min() < 1 or count.max() > 2:
        raise ValueError(f"bilinear rows of {count.min()}..{count.max()} "
                         "taps")
    first = np.cumsum(count) - count
    idx = np.stack([cols[first], cols[first + count - 1]])
    r = np.arange(n_out)
    w = np.stack([m[r, idx[0]], np.where(count == 2, m[r, idx[1]], 0.0)])
    return idx.astype(np.int32), w.astype(np.float32)


@lru_cache(maxsize=16)
def push_taps(shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """The per-axis taps the push kernel reads for the pyramid of level
    shapes ``shapes`` (LOD 0 first), one int32 buffer: rows (L, 3, H) =
    nearest, bilinear tap 0, tap 1 of each level's (H, Hl) matrices;
    columns (L, 3, W) alike; then the bilinear weights' f32 bits, (L, 2, H)
    and (L, 2, W). Level 0's entries are 0 and unread."""
    (H, W), L = shapes[0], len(shapes)
    yi = np.zeros((L, 3, H), np.int32)
    xi = np.zeros((L, 3, W), np.int32)
    yw = np.zeros((L, 2, H), np.float32)
    xw = np.zeros((L, 2, W), np.float32)
    for l, (h, w) in enumerate(shapes[1:], 1):
        yi[l, 0] = nearest_taps(H, h)
        yi[l, 1:], yw[l] = bilinear_taps(H, h)
        xi[l, 0] = nearest_taps(W, w)
        xi[l, 1:], xw[l] = bilinear_taps(W, w)
    return np.concatenate([yi.ravel(), xi.ravel(), yw.view(np.int32).ravel(),
                           xw.view(np.int32).ravel()])


def _resample(planes: Sequence[torch.Tensor], my: np.ndarray,
              mx: np.ndarray) -> List[torch.Tensor]:
    """[(Hl, Wl)] -> [(H, W)]: my @ plane @ mx^T per plane (f32, no TF32)."""
    dev = planes[0].device
    myt = torch.from_numpy(my).to(dev)
    mxt = torch.from_numpy(mx).to(dev)
    stack = torch.stack(list(planes))                       # (C, Hl, Wl)
    out = torch.matmul(torch.matmul(myt, stack), mxt.T)
    return list(out.unbind(0))


def _push_level(colors: List[List[torch.Tensor]], H: int, W: int):
    """The nearest fetch of every level at the (H, W) LOD 0 pixels, and the
    level each pixel takes: the first with alpha > 0, else the last
    (tsdf_colorfill.fs:36-40)."""
    L = len(colors)
    fetched = [
        colors[0] if l == 0 else _resample(
            colors[l], _nearest_matrix(H, colors[l][0].shape[0]),
            _nearest_matrix(W, colors[l][0].shape[1]))
        for l in range(L)
    ]
    valid = torch.stack([f[3] > 0.0 for f in fetched])      # (L, H, W)
    level = valid.to(torch.float32).argmax(dim=0).to(torch.int32)
    level = torch.where(valid.any(dim=0), level, L - 1)
    return fetched, level


def _push_planar(colors: List[List[torch.Tensor]], depths: List[torch.Tensor]):
    """Colorfill (tsdf_colorfill.fs:30-55) on planar channels."""
    H, W = depths[0].shape
    L = len(colors)
    dev = depths[0].device
    fetched, level = _push_level(colors, H, W)

    def select_level(per_level, lvl):
        out = list(per_level[L - 1])
        for l in range(L - 2, -1, -1):
            sel = lvl == l
            out = [torch.where(sel, per_level[l][c], out[c])
                   for c in range(PLANES)]
        return out

    base = select_level(fetched, level)
    zeros = [torch.zeros((H, W), dtype=torch.float32, device=dev)] * PLANES
    bilin = [zeros] + [
        _resample(colors[l], _bilinear_matrix(H, colors[l][0].shape[0]),
                  _bilinear_matrix(W, colors[l][0].shape[1]))
        for l in range(1, L)
    ]
    l1 = torch.clamp(level + 1, 0, L - 1)
    l2 = torch.clamp(level + 2, 0, L - 1)
    c1 = select_level(bilin, l1)
    c2 = select_level(bilin, l2)
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    w1 = torch.sqrt(uu * uu + vv * vv)   # the reference's weight quirk (:47-48)
    w2 = 1.0 - w1
    denom = torch.where(torch.abs(w1 + w2) < 1e-20, 1e-20, w1 + w2)
    filled = level > 0
    out = [torch.where(filled, (c1[c] * w1 + c2[c] * w2) / denom, base[c])
           for c in range(PLANES)]
    return out, depths[0]


def fill_colors_plain(planes0: Sequence[torch.Tensor], depth0: torch.Tensor,
                      num_lods: int = 7) -> Tuple[List[torch.Tensor],
                                                  torch.Tensor]:
    """Full pull-push in plain PyTorch: [r, g, b, a], depth (H, W) -> same
    at full res."""
    colors, depths = _build_pyramid_planar(planes0, depth0, num_lods)
    return _push_planar(colors, depths)


def fill_colors_planar(planes0: Sequence[torch.Tensor], depth0: torch.Tensor,
                       num_lods: int = 7) -> Tuple[List[torch.Tensor],
                                                   torch.Tensor]:
    """The pull-push of :func:`fill_colors_plain`: on CUDA tensors the
    kernels of csrc/holefill.cu in one call (``pull_launches`` pull
    launches, two levels each, then one push launch; the planes may be
    strided views), on CPU tensors the plain version. Same arguments and
    results; the depth is ``depth0`` itself."""
    if depth0.device.type == "cpu":
        return fill_colors_plain(planes0, depth0, num_lods)
    from ..kernels.holefill import fill_cuda

    return list(fill_cuda(planes0, depth0, num_lods).unbind(0)), depth0
