"""Seeded inputs of the render bake's two chain kernels (csrc/bake.cu
brick_clearance and oct_table), numpy only: the CPU tests
(tests/test_torch_bake_chain.py) hold the twins against the JAX package on
them, and the card's tests (tests/test_torch_kernels.py -k bake_chain) the
kernels against the twins.

- ``clearance_case(name)``: a (Bz, By, Bx) bool surface-brick mask. A
  non-cubic grid, an empty one, a full one, one brick, bricks on each of
  the six faces, a z-slab cropped from a larger grid; for the card also
  the cells' 20 x 22 x 20 grid (a shell of bricks) and a larger
  30 x 30 x 30 grid.
- ``oct_case(name)``: (volume, occ, brick_vox, capacity): a TSDF-like f32
  volume whose sides are whole bricks, with exact bf16 ties and values
  around them, and a mask with fewer, as many and more set bricks than the
  capacity, or none; for the card also 20- and 23-voxel bricks (an
  extended brick of 37 KB staged in shared memory, one of 55.3 KB read
  from global memory).
"""

import numpy as np

ROUNDS = (0, 1, 6, 16)
CLEARANCE_CASES = ("non_cubic", "empty", "full", "one_brick", "faces",
                   "slab")
CARD_CLEARANCE_CASES = CLEARANCE_CASES + ("cells", "oversize")


def _shell(shape, radius, width, rng):
    """Bricks near a sphere's surface in a grid of ``shape``, with a few
    random ones."""
    z, y, x = np.meshgrid(*[np.arange(s) + 0.5 for s in shape],
                          indexing="ij")
    c = [s / 2 for s in shape]
    r = np.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
    return (np.abs(r - radius) < width) | (rng.random(shape) < 0.002)


def clearance_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(sorted(CARD_CLEARANCE_CASES).index(name))
    if name == "non_cubic":
        return rng.random((5, 7, 9)) < 0.06
    if name == "empty":
        return np.zeros((4, 6, 5), bool)
    if name == "full":
        return np.ones((4, 6, 5), bool)
    if name == "one_brick":
        occ = np.zeros((9, 8, 7), bool)
        occ[4, 3, 2] = True
        return occ
    if name == "faces":
        occ = np.zeros((8, 9, 10), bool)
        occ[0, 4, 5] = occ[-1, 2, 7] = True
        occ[3, 0, 2] = occ[5, -1, 8] = True
        occ[6, 6, 0] = occ[2, 3, -1] = True
        return occ
    if name == "slab":
        # the rows a slab of the sharded step holds of a larger grid
        return np.ascontiguousarray(
            _shell((20, 22, 20), 7.0, 0.6, rng)[6:11])
    if name == "cells":
        return _shell((20, 22, 20), 6.0, 0.6, rng)
    if name == "oversize":
        return _shell((30, 30, 30), 10.0, 0.6, rng)
    raise KeyError(name)


# name -> (volume shape, brick_vox, capacity, set bricks); a set count of
# None marks every brick the sphere's shell reaches
OCT_CASES = {
    "under": ((16, 12, 20), 4, 16, 9),
    "at": ((16, 12, 20), 4, 16, 16),
    "over": ((16, 12, 20), 4, 16, 31),
    "empty": ((16, 12, 20), 4, 16, 0),
}
CARD_OCT_CASES = dict(OCT_CASES, **{
    "cells_shell": ((200, 220, 200), 10, 768, None),
    "bricks_20": ((60, 40, 80), 20, 24, 10),
    "bricks_23": ((46, 23, 69), 23, 4, 3),
})


def oct_volume(shape, rng) -> np.ndarray:
    """A TSDF-like f32 volume in [-0.02, 0.02] with bf16 ties (exactly
    half-way between two bf16 values) and values one f32 ulp around
    them."""
    vol = rng.uniform(-0.02, 0.02, shape).astype(np.float32)
    bits = vol.reshape(-1).view(np.uint32)
    pick = rng.choice(bits.size, size=min(bits.size, 96), replace=False)
    for part, low in zip(np.array_split(pick, 3), (0x8000, 0x7FFF, 0x8001)):
        bits[part] = (bits[part] & np.uint32(0xFFFF0000)) | np.uint32(low)
    return vol


def oct_case(name: str):
    """(volume, occ, brick_vox, capacity) of the case ``name``."""
    shape, v, capacity, n_set = CARD_OCT_CASES[name]
    rng = np.random.default_rng(sorted(CARD_OCT_CASES).index(name) + 40)
    vol = oct_volume(shape, rng)
    grid = tuple(s // v for s in shape)
    if n_set is None:
        occ = _shell(grid, 6.0, 0.6, rng)
    else:
        occ = np.zeros(grid, bool).reshape(-1)
        occ[rng.choice(occ.size, size=n_set, replace=False)] = True
        occ = occ.reshape(grid)
    return vol, occ, v, capacity
