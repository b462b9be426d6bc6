"""Launch wrappers of csrc/gather.cu (the gather-rate probe's kernels).

Indices are int32 in [0, n) along the gathered axis; the kernels clamp
others into the table only so as not to read outside it (see the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES
from ._build import check, library


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} must hold fewer than 2^31 elements")


def _inputs(table: torch.Tensor, idx: torch.Tensor, dim: int) -> None:
    _check("table", table, torch.float32, dim)
    _check("idx", idx, torch.int32, dim)
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, the table on "
                         f"{table.device}")
    if table.numel() == 0:
        raise ValueError("the table is empty")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_flat_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n,) f32 table, (m,) i32 indices -> (m,) f32 ``table[idx]``: one
    thread per lookup through the read-only path."""
    _inputs(table, idx, 1)
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = library().rgbd_gather_flat(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table.numel(), _stream(table))
    check(err, "gather_flat")
    LAUNCHES["gather_flat"] += 1
    return out


def smem_table_entries(device) -> int:
    """The most entries a table of :func:`gather_flat_smem_cuda` may hold on
    ``device``: its opt-in shared memory per block over 4 bytes."""
    device = torch.device(device)
    return _smem_entries(torch.cuda.current_device() if device.index is None
                         else device.index)


@functools.lru_cache(maxsize=None)
def _smem_entries(index: int) -> int:
    entries = ctypes.c_int(0)
    with torch.cuda.device(index):
        check(library().rgbd_gather_smem_entries(ctypes.byref(entries)),
              "gather_flat_smem")
    return entries.value


def gather_flat_smem_cuda(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` from a copy of the table in each block's shared
    memory, on a persistent grid; the table may hold at most
    :func:`smem_table_entries` entries. With no lookups the launch only
    stages the table in every block of the grid (the probe times that load
    on its own)."""
    _inputs(table, idx, 1)
    most = smem_table_entries(table.device)
    if table.numel() > most:
        raise ValueError(f"the table holds {table.numel()} entries; shared "
                         f"memory takes at most {most}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = library().rgbd_gather_flat_smem(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table.numel(), _stream(table))
    check(err, "gather_flat_smem")
    LAUNCHES["gather_flat_smem"] += 1
    return out


def gather_rows_cuda(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) f32, (R, M) i32 -> (R, M) f32 ``take_along_axis(t, idx,
    axis=1)``."""
    _inputs(t, idx, 2)
    if idx.shape[0] != t.shape[0]:
        raise ValueError(f"idx {tuple(idx.shape)} must have the table's "
                         f"{t.shape[0]} rows")
    R, C = t.shape
    out = torch.empty(idx.shape, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        err = library().rgbd_gather_rows(
            t.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, idx.shape[1],
            _stream(t))
    check(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_cols_cuda(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) f32, (M, C) i32 -> (M, C) f32 ``take_along_axis(t, idx,
    axis=0)``."""
    _inputs(t, idx, 2)
    if idx.shape[1] != t.shape[1]:
        raise ValueError(f"idx {tuple(idx.shape)} must have the table's "
                         f"{t.shape[1]} columns")
    R, C = t.shape
    out = torch.empty(idx.shape, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        err = library().rgbd_gather_cols(
            t.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, idx.shape[0],
            _stream(t))
    check(err, "gather_cols")
    LAUNCHES["gather_cols"] += 1
    return out
