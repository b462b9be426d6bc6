"""Launch wrappers of csrc/bake.cu (surface-brick mask, sentinel bake,
brick clearance, oct hit table)."""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, library


def _brick_grid(shape, brick_vox: int):
    Z, Y, X = shape
    v = brick_vox
    return -(-Z // v), -(-Y // v), -(-X // v)


def _check_volume(volume: torch.Tensor, brick_vox: int) -> None:
    if volume.device.type != "cuda":
        raise ValueError(f"volume must be a CUDA tensor, got {volume.device}")
    if volume.dtype != torch.float32:
        raise ValueError(f"volume must be float32, got {volume.dtype}")
    if volume.dim() != 3:
        raise ValueError(f"volume must be (Z, Y, X), got {tuple(volume.shape)}")
    if not volume.is_contiguous():
        raise ValueError("volume must be contiguous")
    if brick_vox < 1:
        raise ValueError(f"brick_vox must be >= 1, got {brick_vox}")
    if volume.numel() >= 2 ** 31 or max(volume.shape) >= 2 ** 16:
        raise ValueError("volume must hold fewer than 2^31 voxels and "
                         "sides below 2^16")


def _positive_words(volume: torch.Tensor, planes: int = 0) -> torch.Tensor:
    """Scratch for volume > 0 packed into 32-voxel words along z, plus
    ``planes`` more arrays of the same size."""
    Z, Y, X = volume.shape
    return torch.empty(((1 + planes) * -(-Z // 32) * Y * X,),
                       dtype=torch.int32, device=volume.device)


def surface_occ_cuda(volume: torch.Tensor, brick_vox: int) -> torch.Tensor:
    """(Z, Y, X) f32 -> (Bz, By, Bx) bool surface-brick mask."""
    _check_volume(volume, brick_vox)
    Z, Y, X = volume.shape
    Bz, By, Bx = _brick_grid(volume.shape, brick_vox)
    out = torch.empty((Bz, By, Bx), dtype=torch.bool, device=volume.device)
    bits = _positive_words(volume)
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(volume.device):
        err = lib.rgbd_surface_occ(
            volume.data_ptr(), bits.data_ptr(), out.data_ptr(), Z, Y, X,
            brick_vox, Bz, By, Bx,
            torch.cuda.current_stream(volume.device).cuda_stream,
        )
    check(err, "surface_occ")
    LAUNCHES["surface_occ"] += 1
    return out


# the dilation rounds of one csrc/bake.cu dilate_count launch (a 32 x 32
# tile keeps a core of 32 - 2K columns), and the most in all (8 bit planes
# of counters): more rounds than one launch takes run in several
_PASS_ROUNDS = 15
MAX_ROUNDS = 255
_OUT_TYPES = (torch.bfloat16, torch.float32)


def sentinel_bake_cuda(volume: torch.Tensor, bs_scaled: torch.Tensor,
                       brick_vox: int, rounds: int,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Z, Y, X) f32 volume + (Bz, By, Bx) f32 brick clearance * brick_vox
    -> (Z, Y, X) sentinel-coded march table in ``out_dtype`` (bf16 or
    f32)."""
    _check_volume(volume, brick_vox)
    grid = _brick_grid(volume.shape, brick_vox)
    if (bs_scaled.device != volume.device
            or bs_scaled.dtype != torch.float32
            or tuple(bs_scaled.shape) != grid
            or not bs_scaled.is_contiguous()):
        raise ValueError(f"bs_scaled must be a contiguous {grid} float32 "
                         "tensor on the volume's device")
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"rounds must be in [0, {MAX_ROUNDS}], got {rounds}")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_TYPES}, "
                         f"got {out_dtype}")
    Z, Y, X = volume.shape
    out = torch.empty(volume.shape, dtype=out_dtype, device=volume.device)
    # the words, then the bit planes of the missed-round counters (one per
    # binary digit of rounds), then the dilated words between launches
    bits = _positive_words(volume,
                           rounds.bit_length() + int(rounds > _PASS_ROUNDS))
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(volume.device):
        err = lib.rgbd_sentinel_bake(
            volume.data_ptr(), bs_scaled.data_ptr(), out.data_ptr(),
            bits.data_ptr(), Z, Y, X, brick_vox, rounds, grid[1], grid[2],
            int(out_dtype == torch.float32),
            torch.cuda.current_stream(volume.device).cuda_stream,
        )
    check(err, "sentinel_bake")
    LAUNCHES["sentinel_bake"] += 1
    return out


# csrc/bake.cu's brick_clearance: the most rounds (distances capped at
# rounds + 1 fit a byte)
CLEARANCE_MAX_ROUNDS = 254


def brick_clearance_cuda(occ: torch.Tensor, rounds: int, brick_vox: int):
    """(Bz, By, Bx) bool surface-brick mask -> (bsafe, bs_scaled), two
    (Bz, By, Bx) f32 tensors: bsafe = min(max(D - 1, 0), rounds), D the
    Chebyshev distance in bricks to the nearest set brick (rounds where
    none is set), and bs_scaled = bsafe * brick_vox. One launch: a
    cooperative grid of a thread a brick."""
    if occ.dtype != torch.bool or occ.dim() != 3:
        raise ValueError(f"occ must be a (Bz, By, Bx) bool tensor, got "
                         f"{occ.dtype} {tuple(occ.shape)}")
    if occ.numel() == 0:
        raise ValueError("occ must hold at least one brick")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    if not 0 <= rounds <= CLEARANCE_MAX_ROUNDS:
        raise ValueError(f"rounds must be in [0, {CLEARANCE_MAX_ROUNDS}], "
                         f"got {rounds}")
    if not 1 <= brick_vox < 2 ** 16:
        raise ValueError(f"brick_vox must be in [1, 2^16), got {brick_vox}")
    n = occ.numel()
    if n >= 2 ** 31:
        raise ValueError("occ must hold fewer than 2^31 bricks")
    if occ.device.type != "cuda":
        raise ValueError(f"occ must be a CUDA tensor, got {occ.device}")
    bsafe = torch.empty(occ.shape, dtype=torch.float32, device=occ.device)
    bs = torch.empty_like(bsafe)
    scratch = torch.empty(2 * n, dtype=torch.uint8, device=occ.device)
    Bz, By, Bx = occ.shape
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(occ.device):
        err = lib.rgbd_brick_clearance(
            occ.data_ptr(), bsafe.data_ptr(), bs.data_ptr(),
            scratch.data_ptr(), Bz, By, Bx, rounds, brick_vox,
            torch.cuda.current_stream(occ.device).cuda_stream)
    check(err, "brick_clearance")
    LAUNCHES["brick_clearance"] += 1
    return bsafe, bs


def oct_table_cuda(volume: torch.Tensor, ids: torch.Tensor, brick_vox: int,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Z, Y, X) f32 volume (sides multiples of brick_vox) + (capacity,)
    int64 brick ids (compact's ascending list, padded with the brick count
    B; each id taken as min(id, B - 1)) -> (capacity * brick_vox^3, 8) cell
    corner rows in ``out_dtype`` (bf16 or f32): row (slot, lz, ly, lx) holds
    the corners dz*4 + dy*2 + dx of the cell at that voxel of the slot's
    brick, edge-clamped at the volume's faces. One launch (none for
    capacity 0)."""
    _check_volume(volume, brick_vox)
    if any(s % brick_vox for s in volume.shape):
        raise ValueError(f"the volume's sides {tuple(volume.shape)} must be "
                         f"multiples of brick_vox {brick_vox}")
    if (ids.device != volume.device or ids.dtype != torch.int64
            or ids.dim() != 1 or not ids.is_contiguous()):
        raise ValueError("ids must be a contiguous (capacity,) int64 tensor "
                         "on the volume's device")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_TYPES}, "
                         f"got {out_dtype}")
    capacity = ids.shape[0]
    V = brick_vox ** 3
    if capacity * V >= 2 ** 31 or brick_vox > 1024:
        raise ValueError("the table must hold fewer than 2^31 rows")
    rows = torch.empty((capacity * V, 8), dtype=out_dtype,
                       device=volume.device)
    if capacity == 0:
        return rows
    Z, Y, X = volume.shape
    lib = library()
    with torch.cuda.device(volume.device):
        err = lib.rgbd_oct_table(
            volume.data_ptr(), ids.data_ptr(), rows.data_ptr(), capacity, Z,
            Y, X, brick_vox, int(out_dtype == torch.float32),
            torch.cuda.current_stream(volume.device).cuda_stream)
    check(err, "oct_table")
    LAUNCHES["oct_table"] += 1
    return rows
