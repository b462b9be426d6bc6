"""Seeded inputs of the render's bracket stage at any block size (numpy for
the values; imported by the CPU tests and by the card's kernel tests, which
import no jax).

``bracket_case(seed, ds, capB, ...)`` gives the arguments of
``ops/render_stages.py bracket`` (geometry, coarse grids, block rows,
interval ends, flags, the block list, the camera) for a camera of Hb x Wb
blocks of ds x ds pixels whose sides are not multiples of ds. The grids
hold NaNs, signed zeros and infinities, at the grid's edges and corners
too; the list holds every corner and edge block, then random ones,
ascending, padded with NB past its count.
"""

import types

import numpy as np
import torch

from rgbd_recon_tpu_torch.ops.render_stages import BlockGeometry

# the cells' constants (their 1 cm voxels, 10 cm bricks, 1 cm TSDF limit)
STEP_LEN = 0.0025
SD = 0.005
SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], np.float32)


def geometry(ds: int, Hb: int = 9, Wb: int = 13,
             per_block: bool = False) -> BlockGeometry:
    """A camera of Hb x Wb blocks of ds x ds pixels (one pixel short of a
    whole block on each side where ds > 1)."""
    short = 1 if ds > 1 else 0
    return BlockGeometry(
        H=Hb * ds - short, W=Wb * ds - short, ds=ds, sc=2, tan_half=0.4,
        bbox_size=(2.0, 2.2, 2.0), vol_shape=(200, 220, 200), brick_vox=10,
        n_scan=53, step_len=STEP_LEN, brick_norm=0.05, bracket_max_steps=6.0,
        bracket_margin_steps=1.5, sd=SD, per_block=per_block)


def _sprinkle(rng, x, p):
    """``x`` with a share ``p`` of its entries replaced by SPECIALS."""
    x = x.copy()
    at = rng.random(x.shape) < p
    x[at] = SPECIALS[rng.integers(0, len(SPECIALS), int(at.sum()))]
    return x


def bracket_case(seed: int, ds: int, capB: int, device, Hb: int = 9,
                 Wb: int = 13, per_block: bool = False, specials=0.06):
    """(g, grid, blk, s_end, flags, blk_idx, cam) on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    g = geometry(ds, Hb, Wb, per_block)
    NB = g.NB
    s_start = rng.uniform(0.2, 0.6, NB).astype(f32)
    s_end = (s_start + rng.uniform(0.05, 0.4, NB)).astype(f32)
    length = np.maximum(s_end - s_start, 0.0).astype(f32)
    hit = (rng.random(NB) < 0.85).astype(f32)
    lo = (s_start + rng.uniform(0.0, 0.15, NB)).astype(f32)
    hi = (lo + rng.uniform(0.0, 0.05, NB)).astype(f32)
    # the unset bracket's sentinels
    lo[hit == 0.0] = np.inf
    hi[hit == 0.0] = -np.inf
    grid = np.stack([_sprinkle(rng, hit, specials),
                     _sprinkle(rng, lo, specials),
                     _sprinkle(rng, hi, specials)])
    # every special at the grids' corners too
    corners = [0, Wb - 1, NB - Wb, NB - 1]
    if specials:
        for i, b in enumerate(corners):
            for k in range(3):
                grid[k, b] = SPECIALS[(i + k) % len(SPECIALS)]
    blk = rng.normal(0.0, 1.0, (NB, 8)).astype(f32)
    blk[:, 6] = _sprinkle(rng, length, specials / 2)
    blk[:, 7] = _sprinkle(rng, s_start, specials / 2)
    s_end = _sprinkle(rng, s_end, specials / 2)
    flags = rng.integers(0, 4, NB).astype(np.uint8)
    # the corners, the edges, then random blocks; a seventh of the slots
    # left as padding
    edge = [b for b in range(NB) if b not in corners and (
        b // Wb in (0, Hb - 1) or b % Wb in (0, Wb - 1))]
    rest = [int(b) for b in rng.permutation(NB)
            if b not in corners and b not in edge]
    count = capB - capB // 7
    listed = sorted(list(dict.fromkeys(corners + edge + rest))[:count])
    blk_idx = np.full(capB, NB, np.int64)
    blk_idx[: len(listed)] = listed
    ang = 0.3 + 0.1 * seed
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], f32)
    cam = types.SimpleNamespace(
        eye_vol=torch.tensor([0.5, 0.55, 1.6], dtype=torch.float32,
                             device=device),
        rot=torch.from_numpy(rot).to(device))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return g, t(grid), t(blk), t(s_end), t(flags), t(blk_idx), cam
