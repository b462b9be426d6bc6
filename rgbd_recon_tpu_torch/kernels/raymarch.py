"""Launch wrapper of csrc/march.cu (the stepwise ray march, one thread a
ray)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from ._build import check, library

_TABLE_TYPES = (torch.bfloat16, torch.float32)
_MODES = ("nearest", "trilinear")
# flat indices and ray indices are int32 in the kernel
_MAX_ENTRIES = 2 ** 31


def march_cuda(table: torch.Tensor, limit: float, max_steps: int,
               start_end, dirs, mode: str = "nearest",
               sentinel_skip: bool = True, sentinel_scale: float = 1.0,
               resume=None):
    """:func:`ops.raymarch.march_plain` in one launch: same arguments, same
    (hit, num, (t, prev_t, prev, lo_t, hi_t, hit_t)). The per-ray inputs
    are f32 CUDA tensors on the table's device of one broadcast shape; they
    may be strided views (read through their strides). ``limit`` and
    ``sentinel_scale`` are rounded to f32 here, as the twin's torch ops
    round them."""
    # the table's device last: every other check runs on any tensor
    if table.dtype not in _TABLE_TYPES:
        raise ValueError(f"table must be one of {_TABLE_TYPES}, got "
                         f"{table.dtype}")
    if table.dim() != 3 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (Z, Y, X) tensor, got "
                         f"{tuple(table.shape)}")
    if table.numel() >= _MAX_ENTRIES:
        raise ValueError(f"table must hold fewer than 2^31 entries, got "
                         f"{table.numel()}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    pos0, ray_len = start_end
    ins = [*pos0, *dirs, ray_len]
    if resume is not None:
        ins += list(resume)
    for x in ins:
        if (not isinstance(x, torch.Tensor) or x.device != table.device
                or x.dtype != torch.float32):
            raise ValueError("the per-ray inputs must be float32 tensors on "
                             f"the table's device {table.device}")
    shape = torch.broadcast_shapes(*(x.shape for x in ins))
    n = int(np.prod(shape, dtype=np.int64))
    if n >= _MAX_ENTRIES:
        raise ValueError(f"at most 2^31 - 1 rays, got {n}")
    if table.device.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    # 1-D views: no copy for 1-D inputs (column views included) and
    # contiguous ones; a stride of 0 for a broadcast scalar
    flat = [torch.broadcast_to(x, shape).reshape(-1) for x in ins]
    dev = table.device
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    num = torch.empty(shape, dtype=torch.int32, device=dev)
    state = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(6))
    if n == 0:
        return hit, num, state
    ptrs = (ctypes.c_longlong * 10)(*[x.data_ptr() for x in flat],
                                    *[0] * (10 - len(flat)))
    strides = (ctypes.c_longlong * 10)(*[x.stride(0) for x in flat],
                                       *[0] * (10 - len(flat)))
    outs = (ctypes.c_longlong * 8)(hit.data_ptr(), num.data_ptr(),
                                   *[s.data_ptr() for s in state])
    limit = float(limit)
    sd = np.float32(limit) * np.float32(0.5)
    D, H, W = table.shape
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(dev):
        err = lib.rgbd_march(
            table.data_ptr(), int(table.dtype == torch.float32), D, H, W,
            ptrs, strides, int(resume is not None), outs, n, int(max_steps),
            int(mode == "trilinear"), int(bool(sentinel_skip)),
            float(np.float32(-limit)), float(sd),
            float(np.float32(sentinel_scale)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "march")
    LAUNCHES["march"] += 1
    return hit, num, state


def _row_march_args(table, limit, max_steps, mode, sentinel_skip,
                    sentinel_scale):
    """The table checks and the scalar arguments shared by the row
    marches."""
    if table.dtype not in _TABLE_TYPES:
        raise ValueError(f"table must be one of {_TABLE_TYPES}, got "
                         f"{table.dtype}")
    if (table.dim() != 3 or not table.is_contiguous()
            or table.device.type != "cuda"):
        raise ValueError("table must be a contiguous (Z, Y, X) CUDA tensor")
    if table.numel() >= _MAX_ENTRIES:
        raise ValueError(f"table must hold fewer than 2^31 entries, got "
                         f"{table.numel()}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    limit = float(limit)
    D, H, W = table.shape
    return (table.data_ptr(), int(table.dtype == torch.float32), D, H, W,
            int(max_steps), int(mode == "trilinear"),
            int(bool(sentinel_skip)), float(np.float32(-limit)),
            float(np.float32(limit) * np.float32(0.5)),
            float(np.float32(sentinel_scale)))


def _rows(x, name, dev, cols=8):
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
            or x.dim() != 2 or x.shape[1] != cols or not x.is_contiguous()
            or x.device != dev):
        raise ValueError(f"{name} must be a contiguous (N, {cols}) float32 "
                         f"tensor on {dev}")
    if x.numel() >= _MAX_ENTRIES:
        raise ValueError(f"{name}: at most 2^31 - 1 entries")
    return x.shape[0]


def _ids(ids, dev):
    if (not isinstance(ids, torch.Tensor) or ids.dtype != torch.int64
            or ids.dim() != 1 or not ids.is_contiguous()
            or ids.device != dev):
        raise ValueError(f"ids must be a contiguous (n,) int64 tensor on "
                         f"{dev}")
    if ids.numel() >= _MAX_ENTRIES:
        raise ValueError("at most 2^31 - 1 ids")
    return ids.numel()


def _launch_rows(scalars, mode, ray8, st8, flags, ids, grid, n, rows,
                 len_col, dev):
    tab, f32, D, H, W, steps, tri, skip, neg_limit, sd, scale = scalars
    lib = library()
    with torch.cuda.device(dev):
        err = lib.rgbd_march_rows(
            tab, f32, D, H, W, mode, ray8.data_ptr(),
            st8.data_ptr() if st8 is not None else None,
            flags.data_ptr() if flags is not None else None,
            ids.data_ptr() if ids is not None else None,
            grid.data_ptr() if grid is not None else None, n, rows, len_col,
            steps, tri, skip, neg_limit, sd, scale,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "march")
    LAUNCHES["march"] += 1


def march_rows_cuda(table: torch.Tensor, limit: float, max_steps: int,
                    ray8: torch.Tensor, len_col: int = 6, *,
                    mode: str = "nearest", sentinel_skip: bool = True,
                    sentinel_scale: float = 1.0, st8=None, flags=None,
                    ids=None):
    """:func:`ops.raymarch.march_rows_plain` in one launch: same arguments,
    same (st8, flags); with ``ids`` the listed rows of ``st8`` and
    ``flags`` are updated in place."""
    scalars = _row_march_args(table, limit, max_steps, mode, sentinel_skip,
                              sentinel_scale)
    dev = table.device
    R = _rows(ray8, "ray8", dev)
    if not 0 <= len_col <= 7:
        raise ValueError(f"len_col must be in [0, 7], got {len_col}")
    if ids is None:
        st8 = torch.empty((R, 8), dtype=torch.float32, device=dev)
        flags = torch.empty(R, dtype=torch.uint8, device=dev)
        n, mode_code = R, 0
    else:
        n, mode_code = _ids(ids, dev), 1
        if _rows(st8, "st8", dev) != R:
            raise ValueError("st8 must have ray8's rows")
        if (not isinstance(flags, torch.Tensor) or flags.dtype != torch.uint8
                or tuple(flags.shape) != (R,) or flags.device != dev
                or not flags.is_contiguous()):
            raise ValueError("flags must be a contiguous (R,) uint8 tensor "
                             f"on {dev}")
    _launch_rows(scalars, mode_code, ray8, st8, flags, ids, None, n, R,
                 len_col, dev)
    return st8, flags


def march_grid_cuda(table: torch.Tensor, limit: float, max_steps: int,
                    blk: torch.Tensor, ids: torch.Tensor,
                    grid: torch.Tensor, *, mode: str = "nearest",
                    sentinel_skip: bool = True,
                    sentinel_scale: float = 1.0) -> torch.Tensor:
    """:func:`ops.raymarch.march_grid_plain` in one launch (the row march's
    grid mode): ``grid`` is updated in place and returned."""
    scalars = _row_march_args(table, limit, max_steps, mode, sentinel_skip,
                              sentinel_scale)
    dev = table.device
    NB = _rows(blk, "blk", dev)
    n = _ids(ids, dev)
    if (not isinstance(grid, torch.Tensor) or grid.dtype != torch.float32
            or tuple(grid.shape) != (3, NB) or not grid.is_contiguous()
            or grid.device != dev):
        raise ValueError(f"grid must be a contiguous (3, {NB}) float32 "
                         f"tensor on {dev}")
    _launch_rows(scalars, 2, blk, None, None, ids, grid, n, NB, 6, dev)
    return grid
