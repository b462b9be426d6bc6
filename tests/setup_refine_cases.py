"""Seeded inputs of the render's block set-up and crafted sample sequences
of the hit refine's widened bracket (numpy for the values; imported by the
CPU tests and by the card's kernel tests, which import no jax).

``setup_case(seed, Hb, Wb, sc, ds, ...)`` gives the arguments of
``ops/render_stages.py block_setup`` (geometry, the scan's (5, Hs, Ws)
planes, the camera) for a camera of Hb x Wb blocks of ds x ds pixels, scan
stride sc. The planes hold what a scan writes (arc lengths, and inf / -inf
/ 0 for rays without an interval); with ``specials`` also NaNs, signed
zeros and infinities sprinkled over them, at every corner and along every
edge of each plane.

``crafted_d(K)`` gives named sequences of K samples d_k for the refine's
first rising sign change (d_k > 0 and d_k-1 <= 0): none, at k = 1, at
K - 1, across a chunk's end, NaN before and after the rise, exact +-0.0.
"""

import types

import numpy as np
import torch

from rgbd_recon_tpu_torch.ops.render_stages import BlockGeometry

# the cells' constants (their 1 cm voxels, 10 cm bricks, 1 cm TSDF limit)
STEP_LEN = 0.0025
SD = 0.005
SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], np.float32)

# (Hb, Wb, sc, ds): the cells' camera (1280 x 720 in 4 x 4 blocks: 180 rows,
# not a multiple of the 8-row tile), tiles cut at the right and the bottom,
# Hs * sc > Hb, one tile exactly, one block, and scan strides 1 to 5
SETUP_GEOMETRIES = [(180, 320, 2, 4), (9, 13, 2, 4), (8, 32, 2, 4),
                    (17, 70, 1, 1), (23, 33, 3, 2), (1, 1, 1, 1),
                    (2, 3, 2, 8), (41, 97, 3, 4), (30, 65, 5, 3),
                    (16, 64, 4, 2)]


def geometry(Hb: int, Wb: int, sc: int, ds: int) -> BlockGeometry:
    """A camera of Hb x Wb blocks of ds x ds pixels (one pixel short of a
    whole block on each side where ds > 1), scan stride sc."""
    short = 1 if ds > 1 else 0
    return BlockGeometry(
        H=Hb * ds - short, W=Wb * ds - short, ds=ds, sc=sc, tan_half=0.4,
        bbox_size=(2.0, 2.2, 2.0), vol_shape=(200, 220, 200), brick_vox=10,
        n_scan=53, step_len=STEP_LEN, brick_norm=0.05, bracket_max_steps=6.0,
        bracket_margin_steps=1.5, sd=SD, per_block=False)


def _sprinkle(rng, x, p, plane):
    """``x`` with a share ``p`` of its entries, every corner and a share
    4p of its edges' entries replaced by SPECIALS (the corners' by the
    plane's index, so that a 1 x 1 grid's five planes hold all five)."""
    x = x.copy()
    at = rng.random(x.shape) < p
    edge = np.zeros(x.shape, bool)
    edge[[0, -1], :] = edge[:, [0, -1]] = True
    at |= edge & (rng.random(x.shape) < 4 * p)
    x[at] = SPECIALS[rng.integers(0, len(SPECIALS), int(at.sum()))]
    for i, (y, c) in enumerate(((0, 0), (0, -1), (-1, 0), (-1, -1))):
        x[y, c] = SPECIALS[(i + plane) % len(SPECIALS)]
    return x


def scan_planes(seed: int, Hs: int, Ws: int, specials: bool) -> np.ndarray:
    """(5, Hs, Ws) f32 first, last, first-surface, s0, s1 as a scan writes
    them (a sixth of the rays without an interval: inf, -inf, inf, s1 0),
    with SPECIALS sprinkled in where ``specials``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    shape = (Hs, Ws)
    s0 = rng.uniform(0.1, 0.3, shape).astype(f32)
    first = (s0 + rng.uniform(0.0, 0.9, shape)).astype(f32)
    last = (first + rng.uniform(0.0, 0.3, shape)).astype(f32)
    fsurf = (first + rng.uniform(0.0, 0.1, shape)).astype(f32)
    s1 = (last + rng.uniform(0.0, 0.4, shape)).astype(f32)
    none = rng.random(shape) < 1 / 6
    first[none], last[none], fsurf[none] = np.inf, -np.inf, np.inf
    s1[none] = 0.0
    planes = np.stack([first, last, fsurf, s0, s1])
    if specials:
        planes = np.stack([_sprinkle(rng, p, 0.05, k)
                           for k, p in enumerate(planes)])
    return planes


def camera(seed: int, device):
    ang = 0.3 + 0.1 * seed
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    return types.SimpleNamespace(
        eye_vol=torch.tensor([0.5, 0.55, 1.6], dtype=torch.float32,
                             device=device),
        rot=torch.from_numpy(rot).to(device))


def setup_case(seed: int, Hb: int, Wb: int, sc: int, ds: int, device,
               specials: bool = True):
    """(g, scan5, cam) on ``device``."""
    g = geometry(Hb, Wb, sc, ds)
    scan5 = torch.from_numpy(scan_planes(seed, g.Hs, g.Ws, specials))
    return g, scan5.to(device), camera(seed, device)


def crafted_d(K: int) -> dict:
    """{name: (K,) f32 samples} for the first rising sign change."""
    f32 = np.float32
    nan, inf = f32(np.nan), f32(np.inf)
    neg = -np.linspace(0.5, 0.1, K).astype(f32)
    pos = np.linspace(0.1, 0.5, K).astype(f32)
    out = {"all_negative": neg, "all_positive": pos,
           "falling": pos[::-1].copy()}

    def rise_at(k, before=None, after=None):
        d = neg.copy()
        d[k:] = pos[k:]
        if before is not None:
            d[k - 1] = before
        if after is not None and k + 1 < K:
            d[k + 1] = after
        return d

    out["rise_at_1"] = rise_at(1)
    out["rise_at_last"] = rise_at(K - 1)
    out["rise_mid"] = rise_at(K // 2)
    if K > 8:
        out["rise_across_chunk"] = rise_at(8)
    if K > 9:
        out["rise_after_chunk"] = rise_at(9)
    out["nan_first"] = rise_at(K - 1, before=None)
    out["nan_first"][0] = nan
    out["nan_before_rise"] = rise_at(K // 2, before=nan)
    out["nan_after_rise"] = rise_at(1, after=nan)
    out["all_nan"] = np.full(K, nan, f32)
    out["pos_zero_before"] = rise_at(K // 2, before=f32(0.0))
    out["neg_zero_before"] = rise_at(K // 2, before=f32(-0.0))
    zero_rise = rise_at(1)
    zero_rise[1] = f32(0.0)                 # +0.0 is not a rise
    out["zero_is_not_a_rise"] = zero_rise
    twice = neg.copy()
    twice[1], twice[K - 1] = f32(0.2), f32(0.3)   # two rises: the first
    out["two_rises"] = twice
    infs = rise_at(K - 1)
    infs[0], infs[K - 1] = -inf, inf
    out["infinities"] = infs
    return out
