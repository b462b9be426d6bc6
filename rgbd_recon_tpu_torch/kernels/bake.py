"""Launch wrappers of csrc/bake.cu (surface-brick mask, sentinel bake)."""

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
