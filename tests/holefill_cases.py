"""Seeded pre-fill planes for the pull-push tests (numpy only: imported by
the CPU tests and by the card's kernel tests, which import no jax)."""

import numpy as np


def fill_planes(seed: int, H: int, W: int, kind: str = "mixed"):
    """[r, g, b, alpha, depth] (H, W) float32 planes like a render's before
    its fill. ``mixed``: a third of the pixels holes (alpha -1, depth 1.0),
    a few with alpha 0 in front, and a hole rectangle a third of the image
    wide so that the push reaches coarse levels; ``invalid``: alpha <= 0
    everywhere (-1 or 0); ``valid``: alpha 1 everywhere. Depths of the
    surface in [0.9, 0.99), with ties."""
    rng = np.random.default_rng(seed)
    rgb = rng.random((3, H, W)).astype(np.float32)
    depth = rng.uniform(0.9, 0.99, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = np.float32(0.95)
    alpha = np.ones((H, W), np.float32)
    if kind == "mixed":
        hole = rng.random((H, W)) < 0.3
        hole[H // 3: H // 3 + max(H // 3, 1), W // 4: W // 4 + max(W // 3,
                                                                  1)] = True
        alpha[hole] = -1.0
        depth[hole] = 1.0
        front = ~hole & (rng.random((H, W)) < 0.05)
        alpha[front] = 0.0
    elif kind == "invalid":
        alpha = np.where(rng.random((H, W)) < 0.5, -1.0, 0.0).astype(
            np.float32)
        depth[rng.random((H, W)) < 0.5] = 1.0
    elif kind != "valid":
        raise ValueError(kind)
    return [*rgb, alpha, depth]
