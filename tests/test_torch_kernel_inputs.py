"""The CPU side of rgbd_recon_tpu_torch/bench/kernel_inputs.py (the timing
of the compaction and the boundary pass needs the card): the library
compaction's list against compact_plain, the boundary maps' cases, the
bytes and operations the boundary pass needs, the bytes the oct table
needs. Imports torch only."""

import numpy as np
import pytest
import torch

from rgbd_recon_tpu_torch.bench import kernel_inputs
from rgbd_recon_tpu_torch.ops.compact import compact_plain
from rgbd_recon_tpu_torch.ops.preprocess import boundary_plain

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [0, 1, 2049, 20_011])
@pytest.mark.parametrize("bit", [0, 5])
def test_library_compact_is_compact_plains_list(n, bit):
    """torch.nonzero_static on the flags' bit lists what compact_plain
    lists, padded with n, at capacities 0, under, at and over the
    count."""
    flags = kernel_inputs.synthetic_flags(torch, n, 0.35, bit, 3, CPU)
    k = int(((flags >> bit) & 1).sum())
    for cap in sorted({0, k // 2, k, k + 7}):
        name, lib = kernel_inputs.library_compact(torch, flags, bit, cap)
        assert name == "torch.nonzero_static"
        ids, _ = compact_plain(flags, bit, cap,
                               torch.zeros(1, dtype=torch.int32), 0)
        assert torch.equal(lib()[:, 0], ids), cap


@pytest.mark.parametrize("shape", kernel_inputs.BOUNDARY_SHAPES[:3])
def test_boundary_maps_cases(shape):
    """The maps hold what the card's checks need: every flag value
    (invalidated, kept, outside) under refine; invalid pixels all along
    the edges; no unreliable pixel inside the left half."""
    n, h, w = shape
    d2, lab = kernel_inputs.boundary_maps(torch, shape, 40, CPU)
    assert d2.shape == (n, h, w, 2) and lab.shape == (n, h, w, 3)
    d, q = d2[..., 0], d2[..., 1]
    valid = (d > 0.0) & (q > 0.65)
    assert not bool(valid[:, 0].any() or valid[:, -1].any()
                    or valid[:, :, 0].any() or valid[:, :, -1].any())
    inner = (slice(None), slice(2, h - 2), slice(2, max(w // 2, 2)))
    assert not bool(((d[inner] > 0.0) & (q[inner] <= 0.65)).any())
    out, _ = boundary_plain(d2, lab, True)
    flags = set(out[..., 1].flatten().tolist())
    assert np.float32(0.1) in flags and 0.0 in flags
    if h * w >= 37 * 70:
        assert 1.0 in flags


def test_boundary_work_counts_what_the_data_needs():
    """The bytes: depth2 once, the two outputs once and the LAB of every
    pixel within 2 of a pixel whose flags read its colour difference
    (unreliable, refine on); the operations: 10 a pixel and 375 more a
    such pixel. With the refine off no LAB is needed."""
    d2 = torch.zeros((1, 6, 7, 2))
    d2[..., 0] = 0.5
    d2[..., 1] = 0.9
    d2[0, 0, 0, 1] = 0.65     # unreliable at a corner: a 3 x 3 window
    d2[0, 3, 6, 1] = 0.1      # at the right edge: a 5 x 3 window
    lab = torch.zeros((1, 6, 7, 3))
    pixels = 6 * 7
    nbytes, ops = kernel_inputs.boundary_work(torch, d2, lab, True)
    assert ops == 10 * pixels + 375 * 2
    assert nbytes == pixels * 8 + (9 + 15) * 12 + pixels * 12
    nbytes, ops = kernel_inputs.boundary_work(torch, d2, lab, False)
    assert (nbytes, ops) == (pixels * 20, 10 * pixels)


def test_library_compact_holds_its_list_to_the_compactions():
    """Given the compaction's list, the library call's list is held to it:
    a list that differs by one entry is refused."""
    flags = kernel_inputs.synthetic_flags(torch, 5000, 0.35, 2, 4, CPU)
    ids, _ = compact_plain(flags, 2, 900, torch.zeros(1, dtype=torch.int32),
                           0)
    name, _ = kernel_inputs.library_compact(torch, flags, 2, 900, ids=ids)
    assert name == "torch.nonzero_static"
    ids[17] += 1
    with pytest.raises(AssertionError, match="differs"):
        kernel_inputs.library_compact(torch, flags, 2, 900, ids=ids)


def _oct_bytes_by_box(shape, ids, v, itemsize):
    """oct_table_bytes by marking each read brick's extended box."""
    grid = tuple(s // v for s in shape)
    n_bricks = int(np.prod(grid))
    need = np.zeros(shape, bool)
    for b in {min(int(i), n_bricks - 1) for i in ids}:
        z, y, x = np.unravel_index(b, grid)
        need[z * v: z * v + v + 1, y * v: y * v + v + 1,
             x * v: x * v + v + 1] = True
    return (int(need.sum()) * 4 + len(ids) * 8
            + len(ids) * v ** 3 * 8 * itemsize)


# (volume shape, brick_vox, ids): neighbours sharing faces, edges and a
# corner, padding (the brick count) past the list, bricks on the high
# faces, every brick, no slot
OCT_BYTES_CASES = {
    "neighbours": ((12, 16, 20), 4, [0, 1, 5, 6, 26, 60, 60]),
    "padded": ((12, 16, 20), 4, [3, 17, 33, 60, 60, 60]),
    "high_faces": ((12, 16, 20), 4, [19, 39, 59]),
    "every_brick": ((6, 9, 6), 3, list(range(12)) + [12, 12]),
    "no_slot": ((6, 9, 6), 3, []),
}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", sorted(OCT_BYTES_CASES))
def test_oct_table_bytes_counts_each_voxel_once(name, itemsize):
    """The oct table's bytes: each voxel of the union of the read bricks'
    extended boxes once (the padding's brick B - 1 once, shared halo planes
    once, clipped at the volume's faces), the list, the rows; every brick
    read is the whole volume."""
    shape, v, ids = OCT_BYTES_CASES[name]
    idt = torch.tensor(ids, dtype=torch.int64)
    got = kernel_inputs.oct_table_bytes(torch, shape, idt, v, itemsize)
    assert got == _oct_bytes_by_box(shape, ids, v, itemsize)
    if name == "every_brick":
        assert got == (int(np.prod(shape)) * 4 + len(ids) * 8
                       + len(ids) * v ** 3 * 8 * itemsize)
