"""The gather-rate probe's four gathers: CUDA kernels and their plain twins.

Counterpart of the Pallas gathers of scripts/probe_pallas_gather.py
(``pallas_take`` / ``pallas_take2``: ``table[idx]``; ``pallas_taa`` /
``pallas_taas``: ``take_along_axis`` along axis 1 / 0). Each function runs
the plain PyTorch version for CPU tensors and the CUDA kernel
(csrc/gather.cu) for CUDA tensors. Indices are int32 in [0, n) along the
gathered axis.
"""

from __future__ import annotations

import torch


def gather_flat_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` of a 1-D table."""
    return table[idx]


def gather_rows_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx, axis=1)``: out[r, j] = t[r, idx[r, j]]."""
    return torch.take_along_dim(t, idx.long(), dim=1)


def gather_cols_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx, axis=0)``: out[m, c] = t[idx[m, c], c]."""
    return torch.take_along_dim(t, idx.long(), dim=0)


def gather_flat(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; the read-only-path kernel on a CUDA tensor."""
    if table.device.type == "cpu":
        return gather_flat_plain(table, idx)
    from ..kernels.gather import gather_flat_cuda

    return gather_flat_cuda(table, idx)


def gather_flat_smem(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; the shared-memory kernel on a CUDA tensor (tables up
    to the block's opt-in shared memory)."""
    if table.device.type == "cpu":
        return gather_flat_plain(table, idx)
    from ..kernels.gather import gather_flat_smem_cuda

    return gather_flat_smem_cuda(table, idx)


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx, axis=1)``; the kernel on a CUDA tensor."""
    if t.device.type == "cpu":
        return gather_rows_plain(t, idx)
    from ..kernels.gather import gather_rows_cuda

    return gather_rows_cuda(t, idx)


def gather_cols(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx, axis=0)``; the kernel on a CUDA tensor."""
    if t.device.type == "cpu":
        return gather_cols_plain(t, idx)
    from ..kernels.gather import gather_cols_cuda

    return gather_cols_cuda(t, idx)
