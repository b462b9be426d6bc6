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
(13, 10, 11) volume whose bricks are padded, and a z-slab (8, 8, 9) of a
padded grid whose last brick row is padding (validity -1, count 0), as
the sharded step hands it; at a capacity above the occupied bricks and
below them, with and without the phantom hull, at carve thresholds 1.0
and 0.5, with nearest and bilinear taps.
"""

import numpy as np

N_SENSORS = 4
MAP_HW = (37, 53)
LIMIT = 0.05
MIN_VOXELS = 10
BRICK_VOX = 4

# volume shape and whether its last brick row is the sharded step's
# padding
SHAPES = {"whole": ((12, 8, 12), False), "padded": ((13, 10, 11), False),
          "slab": ((8, 8, 9), True)}
# name -> (taps, shape, capacity "above" / "below" the occupied count,
# phantom_hull, carve_sil_threshold)
INTEGRATE_CASES = {
    f"{taps}_{name}": (taps, *spec)
    for taps in ("nearest", "bilinear")
    for name, spec in {
        "whole": ("whole", "above", False, 1.0),
        "capacity_below": ("whole", "below", False, 1.0),
        "phantom_hull": ("whole", "above", True, 1.0),
        "carve_half": ("whole", "above", False, 0.5),
        "padded": ("padded", "above", False, 1.0),
        "padded_capacity_below": ("padded", "below", True, 0.5),
        "slab": ("slab", "above", False, 1.0),
    }.items()
}


def brick_grid(shape, v=BRICK_VOX):
    return tuple(-(-s // v) for s in shape)


def integrate_case(name: str, seed: int = 0) -> dict:
    """The arguments of integrate_compact for case ``name`` as numpy
    arrays and numbers (the maps, projections and counts from ``seed``)."""
    taps, shape_name, cap, phantom_hull, carve = INTEGRATE_CASES[name]
    shape, slab = SHAPES[shape_name]
    rng = np.random.default_rng(seed + 1000 * list(SHAPES).index(shape_name))
    H, W = MAP_HW
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depths = np.stack([0.45 + 0.15 * np.sin(4.0 * xx + i) * np.cos(3.0 * yy)
                       for i in range(N_SENSORS)]).astype(np.float32)
    depths += rng.normal(0, 0.01, depths.shape).astype(np.float32)
    qualities = rng.uniform(0.0, 1.0, depths.shape).astype(np.float32)
    qualities[rng.random(depths.shape) < 0.1] = 0.0
    silhouettes = np.ones(depths.shape, np.float32)
    silhouettes[rng.random(depths.shape) < 0.2] = 0.0
    mid = rng.random(depths.shape) < 0.1
    silhouettes[mid] = rng.choice([0.3, 0.5, 0.7], int(mid.sum()))
    v = BRICK_VOX
    Bz, By, Bx = brick_grid(shape)
    B, V = Bz * By * Bx, v ** 3
    proj = np.empty((N_SENSORS, B, V, 4), np.float32)
    proj[..., 0] = rng.uniform(-0.05, 1.05, (N_SENSORS, B, V))
    proj[..., 1] = rng.uniform(-0.05, 1.05, (N_SENSORS, B, V))
    proj[..., 2] = rng.uniform(0.2, 0.7, (N_SENSORS, B, V))
    proj[..., 3] = np.where(rng.random((N_SENSORS, B, V)) < 0.85, 1.0, -1.0)
    counts = rng.integers(0, 25, (Bz, By, Bx)).astype(np.int32)
    if slab:
        # the padding brick row past the volume: no count, validity -1
        proj.reshape(N_SENSORS, Bz, By * Bx, V, 4)[:, -1] = 0.0
        proj.reshape(N_SENSORS, Bz, By * Bx, V, 4)[:, -1, ..., 3] = -1.0
        counts[-1] = 0
    occupied = int((counts > MIN_VOXELS).sum())
    capacity = B + 5 if cap == "above" else occupied // 2
    return dict(proj_bricks=proj, counts=counts, min_voxels=MIN_VOXELS,
                capacity=capacity, depths=depths, qualities=qualities,
                silhouettes=silhouettes, limit=LIMIT, vol_shape=shape,
                brick_vox=v, carve_sil_threshold=carve,
                phantom_hull=phantom_hull, taps=taps, occupied=occupied)


# marking cases: (N, H, W) maps, stride, whether the world points come
# from pixel models (else as given world points), the box and brick size
MARK_CASES = {
    "stride1_models": (1, True, 0.1),
    "stride3_models": (3, True, 0.1),
    "stride1_worlds": (1, False, 0.1),
    "stride3_worlds": (3, False, 0.1),
    "stride2_models": (2, True, 0.1),
    # 5 cm bricks: 70,400 counts, past the kernel's shared histogram
    "stride1_models_5cm": (1, True, 0.05),
    "stride3_worlds_5cm": (3, False, 0.05),
}
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
    stride, models, brick_size = MARK_CASES[name]
    rng = np.random.default_rng(seed)
    H, W = MARK_HW
    lo, hi = np.asarray(BOX_MIN), np.asarray(BOX_MAX)
    depth = rng.uniform(-0.1, 1.1, (N_SENSORS, H, W, 2)).astype(np.float32)
    depth[rng.random((N_SENSORS, H, W)) < 0.05, 0] = 0.0
    depth[rng.random((N_SENSORS, H, W)) < 0.02, 0] = 1.0
    out = dict(depth=depth, bbox_min=np.asarray(BOX_MIN, np.float32),
               brick_size=brick_size, brick_res=brick_res(brick_size),
               stride=stride, ray_a=None, ray_b=None, worlds=None)
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
