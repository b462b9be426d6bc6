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
