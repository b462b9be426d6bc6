"""Launch wrappers of csrc/holefill.cu (the pull-push fill: a pull launch
makes two pyramid levels, one push launch fills LOD 0).

``fill_cuda`` is the render's fill: its arguments checked once, the
pyramid in one buffer, every launch from one call into the library.
``pull_cuda`` and ``push_cuda`` launch the two kernels alone (the tests and
``chip_smoke.py`` hold each against its twin)."""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple

import torch

from . import LAUNCHES
from ._build import check, library
from ..ops.holefill import (
    PUSH_SMEM_MAX,
    push_layout,
    push_taps,
    pyramid_offsets,
    pyramid_shapes,
)

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


class _Plan(NamedTuple):
    """A pyramid's arguments for the library, built once per shape."""
    shapes: tuple       # (Hl, Wl) of every level, LOD 0 first
    offsets: list       # each level's offset past LOD 0 in the buffer
    numel: int          # the buffer's floats
    c_hw: ctypes.Array  # (Hl, Wl) pairs past LOD 0
    c_offsets: ctypes.Array
    c_roff: ctypes.Array  # the push's rectangle offsets (texels of a plane)
    texels: int         # texels the rectangles reserve a plane
    smem: int           # the push block's dynamic shared memory (bytes)


@lru_cache(maxsize=32)
def _plan(shapes: tuple) -> _Plan:
    offsets, numel = pyramid_offsets(shapes)
    roff, texels, smem = push_layout(shapes)
    n = max(len(shapes) - 1, 1)
    return _Plan(shapes, offsets, numel,
                 (ctypes.c_int * (2 * n))(*[s for hw in shapes[1:]
                                            for s in hw]),
                 (ctypes.c_longlong * n)(*offsets),
                 (ctypes.c_int * n)(*roff), texels, smem)


@lru_cache(maxsize=16)
def _fill_plan(H: int, W: int, num_lods: int) -> _Plan:
    """The plan of the pyramid a fill of an (H, W) LOD 0 at ``num_lods``
    builds, its push checked once per shape."""
    plan = _plan(tuple(pyramid_shapes(H, W, num_lods)))
    _check_push(plan)
    return plan


def _check_push(plan: _Plan) -> None:
    (H, W), L = plan.shapes[0], len(plan.shapes)
    if L > _MAX_LODS:
        raise ValueError(f"holefill_push: at most {_MAX_LODS} levels, got {L}")
    if 3 * L * (H + W) >= _MAX_ENTRIES:
        raise ValueError(f"holefill_push: the taps of {plan.shapes} exceed "
                         "2^31")
    if plan.smem > PUSH_SMEM_MAX:
        raise ValueError(f"holefill_push: the staged taps and rectangles of "
                         f"{plan.shapes} take {plan.smem} B of shared "
                         f"memory, past {PUSH_SMEM_MAX}")


@lru_cache(maxsize=16)
def _device_taps(shapes, dev) -> torch.Tensor:
    """The push's per-axis taps of a pyramid on a device: one upload per
    pyramid shape, none per frame."""
    return torch.from_numpy(push_taps(shapes)).to(dev)


def _levels(buf: torch.Tensor, plan: _Plan) -> List[torch.Tensor]:
    """The (5, Hl, Wl) levels past LOD 0 in the pyramid buffer."""
    return [buf[o: o + 5 * h * w].view(5, h, w)
            for o, (h, w) in zip(plan.offsets, plan.shapes[1:])]


def pull_cuda(planes, steps: int = 1) -> List[torch.Tensor]:
    """``steps`` pull steps of :func:`ops.holefill._pull_planar`, two a
    launch (the last alone when ``steps`` is odd): ``planes`` = [r, g, b,
    alpha, depth] of an (H, W) level -> the next ``steps`` levels, each a
    contiguous (5, Hl, Wl) view of one buffer, planes in that order, bit-
    equal to the twin (each side max(side above // 2, 1))."""
    _check_planes(planes, 5, "holefill_pull")
    H, W = planes[0].shape
    dev = planes[0].device
    shapes = [(H, W)]
    for _ in range(steps):
        h, w = shapes[-1]
        shapes.append((max(h // 2, 1), max(w // 2, 1)))
    plan = _plan(tuple(shapes))
    buf = torch.empty(plan.numel, dtype=torch.float32, device=dev)
    ptrs, rows, cols = _plane_args(planes)
    launches = ctypes.c_int(0)
    lib = library()
    # launch on the tensors' device (the current one may be another)
    with torch.cuda.device(dev):
        err = lib.rgbd_holefill_pull(
            ptrs, rows, cols, buf.data_ptr(), plan.c_offsets, plan.c_hw,
            steps, H, W, ctypes.byref(launches),
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["holefill_pull"] += launches.value
    check(err, "holefill_pull")
    return _levels(buf, plan)


def push_cuda(planes0, levels, return_level: bool = False):
    """:func:`ops.holefill._push_planar` in one launch. ``planes0`` = LOD 0
    [r, g, b, alpha]; ``levels`` = the coarser levels of its pyramid
    (:func:`ops.holefill.pyramid_shapes`), each a contiguous (C >= 4, Hl,
    Wl) float32 tensor on their device whose first four planes are r, g,
    b, alpha (:func:`pull_cuda`'s outputs) -> a contiguous (4, H, W)
    tensor of the filled r, g, b, alpha; with ``return_level`` also the
    (H, W) int32 level each pixel took. The depth passes through
    untouched: the caller keeps its own."""
    _check_planes(planes0, 4, "holefill_push")
    H, W = planes0[0].shape
    dev = planes0[0].device
    L = len(levels) + 1
    for lv in levels:
        if (not isinstance(lv, torch.Tensor) or lv.dtype != torch.float32
                or lv.dim() != 3 or lv.shape[0] < 4 or lv.numel() == 0
                or not lv.is_contiguous() or lv.device != dev):
            raise ValueError("holefill_push: each level must be a "
                             "contiguous float32 (C >= 4, Hl, Wl) tensor on "
                             f"the planes' device {dev}")
    shapes = ((H, W), *(tuple(lv.shape[1:]) for lv in levels))
    if list(shapes) != pyramid_shapes(H, W, L):
        raise ValueError(f"holefill_push: levels of {shapes}, not the "
                         f"pyramid {pyramid_shapes(H, W, L)}")
    plan = _plan(shapes)
    _check_push(plan)
    taps = _device_taps(shapes, dev)
    out = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    level = (torch.empty((H, W), dtype=torch.int32, device=dev)
             if return_level else None)
    ptrs, rows, cols = _plane_args(planes0)
    lvl_ptrs = (ctypes.c_longlong * max(L - 1, 1))(
        *[lv.data_ptr() for lv in levels])
    lib = library()
    with torch.cuda.device(dev):
        err = lib.rgbd_holefill_push(
            ptrs, rows, cols, lvl_ptrs, plan.c_hw, plan.c_roff, plan.texels,
            plan.smem, L, taps.data_ptr(), out.data_ptr(),
            None if level is None else level.data_ptr(), H, W,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "holefill_push")
    LAUNCHES["holefill_push"] += 1
    return (out, level) if return_level else out


def fill_cuda(planes0, depth0: torch.Tensor, num_lods: int) -> torch.Tensor:
    """:func:`ops.holefill.fill_colors_plain`'s colours in one call into
    the library: the pull launches (two levels each) into one pyramid
    buffer, then the push. ``planes0`` = LOD 0 [r, g, b, alpha], ``depth0``
    its depth, any strides -> a contiguous (4, H, W) tensor of the filled
    r, g, b, alpha. The arguments are checked here, once a fill."""
    planes = [*planes0, depth0]
    _check_planes(planes, 5, "holefill")
    H, W = depth0.shape
    dev = depth0.device
    plan = _fill_plan(H, W, num_lods)
    taps = _device_taps(plan.shapes, dev)
    pyr = torch.empty(plan.numel, dtype=torch.float32, device=dev)
    out = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    ptrs, rows, cols = _plane_args(planes)
    launches = ctypes.c_int(0)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.rgbd_holefill_fill(
            ptrs, rows, cols, pyr.data_ptr(), plan.c_offsets, plan.c_hw,
            plan.c_roff, plan.texels, plan.smem, len(plan.shapes),
            taps.data_ptr(), out.data_ptr(), H, W, ctypes.byref(launches),
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["holefill_pull"] += launches.value
    LAUNCHES["holefill_push"] += int(err == 0)
    check(err, "holefill")
    return out
