"""Launch wrappers of csrc/holefill.cu (the pull-push fill: one launch a
pull level, one push launch)."""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import LAUNCHES
from ._build import check, library
from ..ops.holefill import push_taps

# pixel and texel indices are int32 in the kernels
_MAX_ENTRIES = 2 ** 31
# levels of a pyramid the push takes (csrc/holefill.cu MAX_LODS)
_MAX_LODS = 32


def _check_planes(planes, n: int, what: str) -> None:
    """``n`` float32 (H, W) tensors of one shape on one CUDA device, fewer
    than 2^31 entries each; any strides."""
    if len(planes) != n:
        raise ValueError(f"{what}: {n} planes, got {len(planes)}")
    p0 = planes[0]
    for p in planes:
        if (not isinstance(p, torch.Tensor) or p.dtype != torch.float32
                or p.dim() != 2):
            raise ValueError(f"{what}: the planes must be float32 (H, W) "
                             "tensors")
        if p.device != p0.device or p.shape != p0.shape:
            raise ValueError(f"{what}: the planes must share one shape and "
                             "device")
    if p0.numel() == 0 or p0.numel() >= _MAX_ENTRIES:
        raise ValueError(f"{what}: planes of 1 to 2^31 - 1 entries, got "
                         f"{tuple(p0.shape)}")
    if p0.device.type != "cuda":
        raise ValueError(f"{what}: the planes must be CUDA tensors, got "
                         f"{p0.device}")


def _plane_args(planes):
    """Pointers, row strides and column strides (elements) of the planes."""
    k = len(planes)
    return ((ctypes.c_longlong * k)(*[p.data_ptr() for p in planes]),
            (ctypes.c_longlong * k)(*[p.stride(0) for p in planes]),
            (ctypes.c_longlong * k)(*[p.stride(1) for p in planes]))


def pull_cuda(planes) -> torch.Tensor:
    """One pull step of :func:`ops.holefill._pull_planar` in one launch:
    ``planes`` = [r, g, b, alpha, depth] of an (H, W) level, bit-equal to
    the twin -> a contiguous (5, H2, W2) tensor of the next level's planes
    in that order (H2 = max(H // 2, 1), W2 likewise)."""
    _check_planes(planes, 5, "holefill_pull")
    H, W = planes[0].shape
    dev = planes[0].device
    out = torch.empty((5, max(H // 2, 1), max(W // 2, 1)),
                      dtype=torch.float32, device=dev)
    ptrs, rows, cols = _plane_args(planes)
    lib = library()
    # launch on the tensors' device (the current one may be another)
    with torch.cuda.device(dev):
        err = lib.rgbd_holefill_pull(
            ptrs, rows, cols, out.data_ptr(), H, W,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "holefill_pull")
    LAUNCHES["holefill_pull"] += 1
    return out


@lru_cache(maxsize=16)
def _device_taps(shapes, dev) -> torch.Tensor:
    """The push's per-axis taps of a pyramid on a device: one upload per
    pyramid shape, none per frame."""
    return torch.from_numpy(push_taps(shapes)).to(dev)


def push_cuda(planes0, levels, return_level: bool = False):
    """:func:`ops.holefill._push_planar` in one launch. ``planes0`` = LOD 0
    [r, g, b, alpha]; ``levels`` = the coarser levels, each a contiguous
    (C >= 4, Hl, Wl) float32 tensor on their device whose first four planes
    are r, g, b, alpha (:func:`pull_cuda`'s outputs) -> a contiguous (4, H,
    W) tensor of the filled r, g, b, alpha; with ``return_level`` also the
    (H, W) int32 level each pixel took. The depth passes through
    untouched: the caller keeps its own."""
    _check_planes(planes0, 4, "holefill_push")
    H, W = planes0[0].shape
    dev = planes0[0].device
    L = len(levels) + 1
    if L > _MAX_LODS:
        raise ValueError(f"holefill_push: at most {_MAX_LODS} levels, got {L}")
    for lv in levels:
        if (not isinstance(lv, torch.Tensor) or lv.dtype != torch.float32
                or lv.dim() != 3 or lv.shape[0] < 4 or lv.numel() == 0
                or not lv.is_contiguous() or lv.device != dev):
            raise ValueError("holefill_push: each level must be a "
                             "contiguous float32 (C >= 4, Hl, Wl) tensor on "
                             f"the planes' device {dev}")
    shapes = ((H, W), *(tuple(lv.shape[1:]) for lv in levels))
    if 3 * L * (H + W) >= _MAX_ENTRIES:
        raise ValueError(f"holefill_push: the taps of {shapes} exceed 2^31")
    taps = _device_taps(shapes, dev)
    out = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    level = (torch.empty((H, W), dtype=torch.int32, device=dev)
             if return_level else None)
    ptrs, rows, cols = _plane_args(planes0)
    n = max(L - 1, 1)
    lvl_ptrs = (ctypes.c_longlong * n)(*[lv.data_ptr() for lv in levels])
    hw = (ctypes.c_int * (2 * n))(*[s for shape in shapes[1:] for s in shape])
    lib = library()
    with torch.cuda.device(dev):
        err = lib.rgbd_holefill_push(
            ptrs, rows, cols, lvl_ptrs, hw, L, taps.data_ptr(),
            out.data_ptr(), None if level is None else level.data_ptr(),
            H, W, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "holefill_push")
    LAUNCHES["holefill_push"] += 1
    return (out, level) if return_level else out
