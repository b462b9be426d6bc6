"""Seeded inputs of the render's hit gather (``ops/render_stages.py
hit_gather_plain``, csrc/render_stages.cu ``hit_gather_kernel``), shared by
tests/test_torch_hit_gather.py (the CPU) and tests/test_torch_kernels.py
(the card).

A case is (ray8 (R, 8), st8 (R, 8), hit_idx (capH,)) as the render hands
them over: hit_idx ascending, its padding (the value R) one tail. Its rows
can hold NaN, +-0.0 and +-inf where the position pos0 + dir * hit_t reads
them, at most one NaN source an operation (a special value, or an inf * 0
or inf - inf that makes the NaN), so that the NaN each operation returns
does not depend on the order of its operands.
"""

import numpy as np
import torch

SPECIALS = (np.nan, 0.0, -0.0, np.inf, -np.inf)
# the hit lists: no padding, all padding, some of each
KINDS = ("live", "dead", "mixed")


def rows(rng, R, specials=True):
    """(ray8, st8) numpy f32 (R, 8): pos0, dir, full and bracket lengths;
    t, prev_t, prev, lo_t, hi_t, hit_t, hit, num."""
    ray8 = np.empty((R, 8), np.float32)
    ray8[:, :3] = rng.uniform(-1.0, 2.0, (R, 3))
    ray8[:, 3:6] = rng.normal(0.0, 1.0, (R, 3))
    ray8[:, 6:] = rng.uniform(0.0, 3.0, (R, 2))
    st8 = np.empty((R, 8), np.float32)
    st8[:, :6] = rng.uniform(0.0, 3.0, (R, 6))
    st8[:, 6] = rng.integers(0, 2, R)
    st8[:, 7] = rng.integers(0, 200, R)
    if specials and R > 1:
        # a special value in one of pos0's, dir's or hit_t's 7 columns of a
        # row in four; the copied columns (lo_t, hi_t, the rest) anywhere
        pick = np.flatnonzero(rng.random(R) < 0.25)
        col = rng.integers(0, 7, pick.size)
        val = np.array(SPECIALS, np.float32)[rng.integers(0, 5, pick.size)]
        for r, c, v in zip(pick, col, val):
            if c < 6:
                ray8[r, c] = v
            else:
                st8[r, 5] = v
        copied = rng.random((R, 2)) < 0.1
        st8[:, 3:5][copied] = np.array(SPECIALS, np.float32)[
            rng.integers(0, 5, int(copied.sum()))]
        # NaNs made by the position itself: inf * 0 and inf - inf
        free = np.setdiff1d(np.arange(R), pick)
        if free.size >= 2:
            a, b = free[:2]
            ray8[a, 3], st8[a, 5] = np.inf, 0.0
            ray8[b, 0], ray8[b, 3], st8[b, 5] = np.inf, -np.inf, 1.0
    return ray8, st8


def hit_list(rng, capH, R, kind):
    """(capH,) int64 ascending ray ids, padded with R: ``kind`` "live" (no
    padding), "dead" (all padding) or "mixed" (a random count live)."""
    live = {"live": capH, "dead": 0,
            "mixed": int(rng.integers(1, capH)) if capH > 1 else 1}[kind]
    if live <= R:
        ids = np.sort(rng.choice(R, live, replace=False))
    else:
        ids = np.sort(rng.integers(0, R, live))
    return np.concatenate([ids, np.full(capH - live, R)]).astype(np.int64)


def gather_case(seed, capH, R, kind, device, specials=True):
    """(ray8, st8, hit_idx) torch tensors on ``device``."""
    rng = np.random.default_rng(seed)
    ray8, st8 = rows(rng, R, specials)
    idx = hit_list(rng, capH, R, kind)
    return tuple(torch.from_numpy(x).to(device) for x in (ray8, st8, idx))
