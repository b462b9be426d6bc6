"""Seeded inputs of the fuse's brick marking and brick-compact integration
(ops/bricks.py mark_pixels, ops/tsdf.py integrate_compact), made with
numpy alone: tests/test_torch_fuse_kernels.py holds the port's plain
versions against the JAX package on them, and tests/test_torch_kernels.py
the kernels of csrc/fuse.cu against the plain versions on the card.

Integration cases (INTEGRATE_CASES): 4 sensors with (37, 53) maps (a smooth
normalized depth, qualities with zeros, silhouettes 0, 1 and in between),
projection rows (u, v in [-0.05, 1.05], so some taps truncate toward zero
and clamp; a normalized depth around the maps' so that voxels fall in
front of, inside and behind the band; validity +-1) and brick counts
around min_voxels, over a (12, 8, 12) volume in bricks of 4 voxels, a
(13, 10, 11) volume whose bricks are padded, a z-slab (8, 8, 9) of a
padded grid whose last brick row is padding (validity -1, count 0), as
the sharded step hands it, and a (15, 9, 22) volume in bricks of 7 voxels
(343 a brick: more than one item of the kernel's brick blocks, the last
partial; X % 4 != 0); at a capacity above the occupied bricks and below
them, with and without the phantom hull, at carve thresholds 1.0 and
0.5, with nearest and bilinear taps, and with 1 and 6 sensors (the
kernel's stages hold 4).

Marking cases (MARK_CASES): seeded pixels through pixel models or given
world points, 10 and 5 cm bricks, strides 1-3; and world points that all
fall near one brick's centre (no neighbour adds: every lane of a warp
adds to one brick), all at one brick corner (the eight bricks around it,
neighbours along all three axes), and one near each brick's centre in
turn (every brick counted).
"""

import numpy as np

N_SENSORS = 4
MAP_HW = (37, 53)
LIMIT = 0.05
MIN_VOXELS = 10
BRICK_VOX = 4

# volume shape, whether its last brick row is the sharded step's padding,
# and the voxels a brick's side
SHAPES = {"whole": ((12, 8, 12), False, BRICK_VOX),
          "padded": ((13, 10, 11), False, BRICK_VOX),
          "slab": ((8, 8, 9), True, BRICK_VOX),
          "big_bricks": ((15, 9, 22), False, 7)}
# name -> (taps, shape, capacity "above" / "below" the occupied count,
# phantom_hull, carve_sil_threshold, sensors)
INTEGRATE_CASES = {
    f"{taps}_{name}": (taps, *spec)
    for taps in ("nearest", "bilinear")
    for name, spec in {
        "whole": ("whole", "above", False, 1.0, N_SENSORS),
        "capacity_below": ("whole", "below", False, 1.0, N_SENSORS),
        "phantom_hull": ("whole", "above", True, 1.0, N_SENSORS),
        "carve_half": ("whole", "above", False, 0.5, N_SENSORS),
        "padded": ("padded", "above", False, 1.0, N_SENSORS),
        "padded_capacity_below": ("padded", "below", True, 0.5, N_SENSORS),
        "slab": ("slab", "above", False, 1.0, N_SENSORS),
        "big_bricks": ("big_bricks", "above", False, 1.0, N_SENSORS),
        "big_bricks_capacity_below": ("big_bricks", "below", True, 1.0,
                                      N_SENSORS),
        "one_sensor": ("big_bricks", "above", False, 1.0, 1),
        "six_sensors": ("big_bricks", "above", False, 0.5, 6),
    }.items()
}


def brick_grid(shape, v=BRICK_VOX):
    return tuple(-(-s // v) for s in shape)


def integrate_case(name: str, seed: int = 0) -> dict:
    """The arguments of integrate_compact for case ``name`` as numpy
    arrays and numbers (the maps, projections and counts from ``seed``)."""
    taps, shape_name, cap, phantom_hull, carve, n_sensors = (
        INTEGRATE_CASES[name])
    shape, slab, v = SHAPES[shape_name]
    rng = np.random.default_rng(seed + 1000 * list(SHAPES).index(shape_name)
                                + 100 * (n_sensors - N_SENSORS))
    H, W = MAP_HW
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depths = np.stack([0.45 + 0.15 * np.sin(4.0 * xx + i) * np.cos(3.0 * yy)
                       for i in range(n_sensors)]).astype(np.float32)
    depths += rng.normal(0, 0.01, depths.shape).astype(np.float32)
    qualities = rng.uniform(0.0, 1.0, depths.shape).astype(np.float32)
    qualities[rng.random(depths.shape) < 0.1] = 0.0
    silhouettes = np.ones(depths.shape, np.float32)
    silhouettes[rng.random(depths.shape) < 0.2] = 0.0
    mid = rng.random(depths.shape) < 0.1
    silhouettes[mid] = rng.choice([0.3, 0.5, 0.7], int(mid.sum()))
    Bz, By, Bx = brick_grid(shape, v)
    B, V = Bz * By * Bx, v ** 3
    N = n_sensors
    proj = np.empty((N, B, V, 4), np.float32)
    proj[..., 0] = rng.uniform(-0.05, 1.05, (N, B, V))
    proj[..., 1] = rng.uniform(-0.05, 1.05, (N, B, V))
    proj[..., 2] = rng.uniform(0.2, 0.7, (N, B, V))
    proj[..., 3] = np.where(rng.random((N, B, V)) < 0.85, 1.0, -1.0)
    counts = rng.integers(0, 25, (Bz, By, Bx)).astype(np.int32)
    if slab:
        # the padding brick row past the volume: no count, validity -1
        proj.reshape(N, Bz, By * Bx, V, 4)[:, -1] = 0.0
        proj.reshape(N, Bz, By * Bx, V, 4)[:, -1, ..., 3] = -1.0
        counts[-1] = 0
    occupied = int((counts > MIN_VOXELS).sum())
    capacity = B + 5 if cap == "above" else occupied // 2
    return dict(proj_bricks=proj, counts=counts, min_voxels=MIN_VOXELS,
                capacity=capacity, depths=depths, qualities=qualities,
                silhouettes=silhouettes, limit=LIMIT, vol_shape=shape,
                brick_vox=v, carve_sil_threshold=carve,
                phantom_hull=phantom_hull, taps=taps, occupied=occupied)


# marking cases: stride, whether the world points come from pixel models
# (else as given world points), the brick size, and where the points lie
# ("spread": through the box and a little past it; "one_brick": near one
# brick's centre; "corner": at one brick corner; "every_brick": near each
# brick's centre in turn)
MARK_CASES = {
    "stride1_models": (1, True, 0.1, "spread"),
    "stride3_models": (3, True, 0.1, "spread"),
    "stride1_worlds": (1, False, 0.1, "spread"),
    "stride3_worlds": (3, False, 0.1, "spread"),
    "stride2_models": (2, True, 0.1, "spread"),
    # 5 cm bricks: 70,400 counts, past the kernel's shared histogram
    "stride1_models_5cm": (1, True, 0.05, "spread"),
    "stride3_worlds_5cm": (3, False, 0.05, "spread"),
    "stride1_models_one_brick": (1, True, 0.1, "one_brick"),
    "stride1_worlds_one_brick_5cm": (1, False, 0.05, "one_brick"),
    "stride1_worlds_corner": (1, False, 0.1, "corner"),
    "stride3_models_corner": (3, True, 0.1, "corner"),
    "stride1_worlds_every_brick": (1, False, 0.1, "every_brick"),
}
# the brick (x, y, z) the "one_brick" and "corner" points gather at
GATHER_BRICK = (7, 13, 4)
MARK_HW = (41, 57)
BOX_MIN = (-1.0, 0.0, -1.0)
BOX_MAX = (1.0, 2.2, 1.0)


def brick_res(brick_size):
    """(Bx, By, Bz) of the box in bricks of ``brick_size`` (core/grid.py
    BrickGrid's rounding)."""
    size = np.asarray(BOX_MAX) - np.asarray(BOX_MIN)
    return tuple(int(np.ceil(s / brick_size - 1e-4)) for s in size)


def mark_case(name: str, seed: int = 0) -> dict:
    """The arguments of mark_pixels for case ``name``: an (N, H, W, 2)
    depth map whose channel 0 is the normalized depth (invalid <= 0 and >=
    1 included), pixel models that send each pixel's ray through the box
    (points a little outside it too, to reach the clamps), or the sampled
    pixels' world points."""
    stride, models, brick_size, points = MARK_CASES[name]
    rng = np.random.default_rng(seed)
    H, W = MARK_HW
    lo, hi = np.asarray(BOX_MIN), np.asarray(BOX_MAX)
    depth = rng.uniform(-0.1, 1.1, (N_SENSORS, H, W, 2)).astype(np.float32)
    depth[rng.random((N_SENSORS, H, W)) < 0.05, 0] = 0.0
    depth[rng.random((N_SENSORS, H, W)) < 0.02, 0] = 1.0
    out = dict(depth=depth, bbox_min=np.asarray(BOX_MIN, np.float32),
               brick_size=brick_size, brick_res=brick_res(brick_size),
               stride=stride, ray_a=None, ray_b=None, worlds=None)
    if points != "spread":
        # the points themselves: ray_a the point and ray_b 0 (ray_a + 0 d)
        Hs, Ws = len(range(stride // 2, H, stride)), len(range(stride // 2,
                                                               W, stride))
        shape = (N_SENSORS, H, W) if models else (N_SENSORS, Hs, Ws)
        w = gathered_points(points, shape, brick_size, rng)
        if models:
            out.update(ray_a=w, ray_b=np.zeros_like(w))
        else:
            out["worlds"] = w
        return out
    if models:
        a = rng.uniform(lo - 0.1, hi + 0.1, (N_SENSORS, H, W, 3))
        b = rng.uniform(-0.8, 0.8, (N_SENSORS, H, W, 3))
        out.update(ray_a=a.astype(np.float32), ray_b=b.astype(np.float32))
    else:
        Hs, Ws = len(range(stride // 2, H, stride)), len(range(stride // 2,
                                                               W, stride))
        w = rng.uniform(lo - 0.1, hi + 0.1, (N_SENSORS, Hs, Ws, 3))
        # points on brick faces and centres, where the index and the
        # neighbour rule turn
        k = rng.random((N_SENSORS, Hs, Ws)) < 0.2
        faces = np.round((w - lo) / brick_size) * brick_size + lo
        w[k] = faces[k]
        out["worlds"] = w.astype(np.float32)
    return out


def gathered_points(points: str, shape, brick_size, rng):
    """(*shape, 3) float32 world points of a "one_brick", "corner" or
    "every_brick" marking case."""
    lo = np.asarray(BOX_MIN)
    res = np.asarray(brick_res(brick_size))
    n = int(np.prod(shape))
    if points == "one_brick":
        # within 0.04 brick of GATHER_BRICK's centre: past no border
        c = lo + (np.asarray(GATHER_BRICK) + 0.5) * brick_size
        w = c + rng.uniform(-0.04, 0.04, (n, 3)) * brick_size
    elif points == "corner":
        # the corner of GATHER_BRICK's lowest x, y, z, most exactly on it
        # and the rest a hair to either side along each axis
        c = lo + np.asarray(GATHER_BRICK) * brick_size
        w = np.tile(c, (n, 1))
        k = rng.random(n) < 0.5
        w[k] += rng.choice([-1e-5, 1e-5], (int(k.sum()), 3))
    else:
        # pixel k near the centre of brick k mod B (x fastest), a third of
        # a brick off it: every brick counted, some past their border
        k = np.arange(n) % int(np.prod(res))
        idx = np.stack([k % res[0], (k // res[0]) % res[1],
                        k // (res[0] * res[1])], axis=1)
        w = lo + (idx + 0.5 + rng.uniform(-0.33, 0.33, (n, 3))) * brick_size
    return w.reshape(*shape, 3).astype(np.float32)
