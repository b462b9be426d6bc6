"""Seeded inputs of the preprocess chain's passes (numpy only: imported by
the CPU tests, which hold the port's twins against the JAX package, and by
the card's kernel tests, which import no jax)."""

import numpy as np

BBOX_MIN = (-1.0, 0.0, -1.0)
BBOX_MAX = (1.0, 2.2, 1.0)
NEAR, FAR = 0.5, 4.5
# the calibration volumes' depth planes: where the pixel models evaluate a
# degenerate depth (1 - 0.5 / D)
CV_DEPTH = 16


def chain_inputs(seed: int, n: int, h: int, w: int, hc: int, wc: int):
    """One frame of ``n`` sensors at (h, w) depth and (hc, wc) colour, as a
    dict of float32 arrays: ``depths`` (n, h, w) metric (a sphere-like
    surface with a depth step, sensor noise, invalid 0s, 0.3 and 4.8 out of
    the valid range, exact 0.5 and 4.5), ``colors`` (n, hc, wc, 3) in [0,
    1], ``depth_limits`` (n, 2), ``camera_positions`` (n, 3), ``bbox_min``
    / ``bbox_max`` (3,) and the pixel models ``ray_a``, ``ray_b`` (n, h, w,
    3), ``uv_p``, ``uv_q``, ``uv_r`` (n, h, w, 2) of pinhole sensors around
    the box. The colour texcoords span a little past [0, 1] on every side,
    so the pair taps reach left of the first texel and clamp at the
    edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
    base = np.where(r2 < 0.09, 2.2 - np.sqrt(np.maximum(0.09 - r2, 0.0)),
                    3.6)[None] + (yy > 0.7)[None] * 0.6
    depths = base + rng.normal(0, 0.004, (n, h, w))
    u = rng.random((n, h, w))
    depths[u < 0.04] = 0.0
    depths[(u >= 0.04) & (u < 0.05)] = 4.8
    depths[(u >= 0.05) & (u < 0.055)] = 0.3
    depths[(u >= 0.055) & (u < 0.057)] = 4.5
    depths[(u >= 0.057) & (u < 0.059)] = 0.5
    # a hole a few pixels wide, filled by neither morph pass
    depths[:, h // 5: h // 5 + 4, w // 7: w // 7 + 5] = 0.0

    yc, xc = np.meshgrid(np.arange(hc) / hc, np.arange(wc) / wc,
                         indexing="ij")
    colors = np.stack([0.5 + 0.4 * np.sin(xc * 9.0 + k) * np.cos(yc * 5.0)
                       for k in range(3)], -1)[None] + rng.normal(
        0, 0.03, (n, hc, wc, 3))
    colors = np.clip(colors, 0.0, 1.0)

    ray_a, ray_b, cams = [], [], []
    centre = np.array([0.0, 1.1, 0.0])
    up = np.array([0.0, 1.0, 0.0])
    for i in range(n):
        ang = 2.0 * np.pi * i / n + 0.3
        cam = centre + 2.6 * np.array([np.cos(ang), 0.1, np.sin(ang)])
        fwd = (centre - cam) / np.linalg.norm(centre - cam)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        upv = np.cross(right, fwd)
        dirs = (fwd[None, None] + (xx - 0.5)[..., None] * 1.2 * right
                + (0.5 - yy)[..., None] * 1.0 * upv)
        ray_a.append(cam + dirs * NEAR)
        ray_b.append(dirs * (FAR - NEAR))
        cams.append(cam)
    ray_a, ray_b = np.stack(ray_a), np.stack(ray_b)

    uv0 = np.stack([xx * 1.2 - 0.1, yy * 1.2 - 0.1], -1)[None]
    uv_r = rng.uniform(-0.05, 0.05, (n, h, w, 2))
    uv_q = rng.uniform(-0.02, 0.02, (n, h, w, 2))
    uv_p = np.broadcast_to(uv0, (n, h, w, 2)).copy()
    f32 = np.float32
    return {
        "depths": depths.astype(f32), "colors": colors.astype(f32),
        "depth_limits": np.tile(np.array([[NEAR, FAR]], f32), (n, 1)),
        "camera_positions": np.stack(cams).astype(f32),
        "bbox_min": np.array(BBOX_MIN, f32),
        "bbox_max": np.array(BBOX_MAX, f32),
        "ray_a": ray_a.astype(f32), "ray_b": ray_b.astype(f32),
        "uv_p": uv_p.astype(f32), "uv_q": uv_q.astype(f32),
        "uv_r": uv_r.astype(f32),
    }


PIXEL_MODEL_FIELDS = ("ray_a", "ray_b", "uv_p", "uv_q", "uv_r")


def depth_norm_cases(seed: int, n: int, h: int, w: int):
    """(n, h, w) normalized depths for the LAB pass: values in (0, 1), the
    degenerate ones (0, exactly 1, negative, past 1) that sample the far
    plane, and tiny positives."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.05, 0.95, (n, h, w))
    u = rng.random((n, h, w))
    d[u < 0.05] = 0.0
    d[(u >= 0.05) & (u < 0.08)] = 1.0
    d[(u >= 0.08) & (u < 0.11)] = -1.0
    d[(u >= 0.11) & (u < 0.13)] = 1.3
    d[(u >= 0.13) & (u < 0.14)] = 1e-7
    return d.astype(np.float32)


def depth2_cases(seed: int, n: int, h: int, w: int):
    """(n, h, w, 2) processed depth maps for the boundary, normals and
    quality passes: a smooth normalized depth with a step, culled 0s,
    invalidated -1s, exact 1s; range confidences around the boundary
    pass's 0.65 threshold, exactly 0.65 at some pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    d = (0.3 + 0.2 * np.sin(xx * 6.0) + (yy > 0.6) * 0.25)[None] \
        + rng.normal(0, 0.002, (n, h, w))
    u = rng.random((n, h, w))
    d[u < 0.06] = 0.0
    d[(u >= 0.06) & (u < 0.08)] = -1.0
    d[(u >= 0.08) & (u < 0.09)] = 1.0
    q = rng.uniform(0.3, 1.0, (n, h, w))
    q[rng.random((n, h, w)) < 0.05] = 0.65
    q[d <= 0.0] = 0.0
    return np.stack([d, q], -1).astype(np.float32)


def lab_cases(seed: int, n: int, h: int, w: int):
    """(n, h, w, 3) LAB maps of the compressed scale the chain makes
    (colours / 255: L below ~0.3, a and b of order 0.1), with patches of
    one colour so that some boundary pixels keep their depth."""
    rng = np.random.default_rng(seed)
    lab = np.stack([rng.uniform(0.0, 0.3, (n, h, w)),
                    rng.uniform(-0.1, 0.1, (n, h, w)),
                    rng.uniform(-0.1, 0.1, (n, h, w))], -1)
    lab[:, : h // 2, : w // 2] = lab[:, :1, :1]
    return lab.astype(np.float32)


def normal_cases(seed: int, n: int, h: int, w: int):
    """(n, h, w, 3) unit normals, zero where the map has no depth."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (n, h, w, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[rng.random((n, h, w)) < 0.05] = 0.0
    return v.astype(np.float32)


def quality_sums(seed: int, n: int, h: int, w: int):
    """quality13's (border count, range-weight sum) over (n, h, w): the
    count an integer in [0, 169], the sum at most the non-border taps."""
    rng = np.random.default_rng(seed)
    border = rng.integers(0, 170, (n, h, w)).astype(np.float32)
    border[rng.random((n, h, w)) < 0.3] = 0.0
    wr = (169.0 - border) * rng.uniform(0.0, 1.0, (n, h, w))
    return border, wr.astype(np.float32)
