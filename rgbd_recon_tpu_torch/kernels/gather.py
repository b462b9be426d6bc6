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


def _rows_inputs(t: torch.Tensor, idx: torch.Tensor) -> None:
    _inputs(t, idx, 2)
    if idx.shape[0] != t.shape[0]:
        raise ValueError(f"idx {tuple(idx.shape)} must have the table's "
                         f"{t.shape[0]} rows")


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


def _plan(fn, args, keys, device, name) -> dict:
    plan = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        check(fn(*args, plan), name)
    return dict(zip(keys, plan))


def rows_plan(R: int, C: int, M: int, device) -> dict:
    """The launch of :func:`gather_rows_cluster_cuda` at (R, C) rows and M
    lookups a row on ``device``: ``cluster`` blocks a cluster, ``slice``
    entries a block, ``clusters_per_row``, ``blocks``, ``smem_bytes`` a
    block, ``threads`` a block, and ``capacity``, the longest row a
    cluster of that size holds. Raises for a row that does not fit."""
    return _plan(library().rgbd_gather_rows_cluster_plan, (R, C, M),
                 ("cluster", "slice", "clusters_per_row", "blocks",
                  "smem_bytes", "threads", "capacity"), torch.device(device),
                 "gather_rows_cluster")


def rows_capacities(device) -> tuple:
    """The longest row :func:`gather_rows_cluster_cuda` holds on
    ``device`` in its smaller cluster, then in its larger (longer rows are
    refused)."""
    small = rows_plan(1, 1, 1, device)["capacity"]
    return small, rows_plan(1, small + 1, 1, device)["capacity"]


def smem_plan(n: int, size: int, device) -> dict:
    """The persistent grid of :func:`gather_flat_smem_cuda` for ``n``
    lookups into ``size`` entries on ``device``: ``blocks``, ``smem_bytes``
    a block, ``threads`` a block."""
    return _plan(library().rgbd_gather_flat_smem_plan, (n, size),
                 ("blocks", "smem_bytes", "threads"), torch.device(device),
                 "gather_flat_smem")


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
    _rows_inputs(t, idx)
    R, C = t.shape
    out = torch.empty(idx.shape, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        err = library().rgbd_gather_rows(
            t.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, idx.shape[1],
            _stream(t))
    check(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_cluster_cuda(t: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows_cuda` with each row held in the shared memory of
    a thread-block cluster (see :func:`rows_plan`), every lookup read from
    the owning block's shared memory: the probe's measure of random
    lookups from distributed shared memory. On no path, and not behind
    ``ops.gather.gather_rows``: slower than the L2 kernel on the H100
    (PERF.md). The launch is refused, and this raises, for rows longer
    than :func:`rows_capacities` allows."""
    _rows_inputs(t, idx)
    R, C = t.shape
    out = torch.empty(idx.shape, dtype=torch.float32, device=t.device)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(t.device):
        err = library().rgbd_gather_rows_cluster(
            t.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, idx.shape[1],
            _stream(t))
    check(err, "gather_rows_cluster")
    LAUNCHES["gather_rows_cluster"] += 1
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
