"""The collectives of the single-controller mesh, as explicit copies.

One process holds every shard: a shard is a tensor on its mesh device, and
a collective is a set of ``Tensor.to(device, non_blocking=True)`` copies
plus the arithmetic that joins them, in shard order so that the result does
not depend on the devices. A copy between tensors on one device is no copy.
Every function here counts bytes by collective: in :data:`BYTES` those it
copies between two devices, in :data:`SHARD_BYTES` those it hands from one
shard to another whatever their devices (what a mesh of one device per
shard would copy; shard 0 is the one on the first device, where gathers
and sums land). A ``torch.distributed`` backend would replace these
functions and nothing else.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# collective -> bytes copied between two devices, and bytes handed between
# two shards, in this process (reset_bytes() zeroes both)
BYTES = {"all_gather": 0, "psum": 0, "halo": 0, "broadcast": 0,
         "scatter": 0}
SHARD_BYTES = dict(BYTES)


def reset_bytes() -> None:
    for counts in (BYTES, SHARD_BYTES):
        for k in counts:
            counts[k] = 0


def bytes_moved() -> dict:
    return {"between_devices": dict(BYTES),
            "between_shards": dict(SHARD_BYTES)}


def copy_to(x: torch.Tensor, device: torch.device, kind: str = "scatter",
            between_shards: bool = False) -> torch.Tensor:
    """``x`` on ``device``: ``x`` itself when it is there already, else a
    non-blocking copy; its bytes count under ``kind``, in SHARD_BYTES too
    when it goes from one shard to another."""
    n = x.numel() * x.element_size()
    if between_shards:
        SHARD_BYTES[kind] += n
    if x.device == device:
        return x
    BYTES[kind] += n
    return x.to(device, non_blocking=True)


def scatter(x: torch.Tensor, shard: int, device: torch.device):
    """Shard 0's ``x`` handed to shard ``shard`` on ``device``."""
    return copy_to(x, device, "scatter", shard != 0)


def broadcast(x: torch.Tensor,
              devices: Sequence[torch.device]) -> Dict[torch.device,
                                                       torch.Tensor]:
    """{device: shard 0's ``x`` on it} for the distinct devices of the
    shards ``devices``."""
    out = {}
    for i, d in enumerate(devices):
        if d in out:      # a later shard on a device that has x already
            SHARD_BYTES["broadcast"] += x.numel() * x.element_size()
        else:
            out[d] = copy_to(x, d, "broadcast", i != 0)
    return out


def all_gather(shards: Sequence[torch.Tensor], device: torch.device,
               dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` in shard order, on ``device``,
    shard 0's (each destination of an all-gather calls this once)."""
    return torch.cat([copy_to(t, device, "all_gather", i != 0)
                      for i, t in enumerate(shards)], dim=dim)


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' partials on ``device``, shard 0's, added in
    shard order (((p0 + p1) + p2) + ...), so that it is the same on any
    mesh."""
    acc = copy_to(parts[0], device, "psum")
    for p in parts[1:]:
        acc = acc + copy_to(p, device, "psum", True)
    return acc


def halo_shift(slabs: Sequence[torch.Tensor], halo: int, fill=None):
    """Per slab (its axis 0 the sharded z): (the ``halo`` rows below it,
    the ``halo`` rows above it), each on the slab's device. Interior ghosts
    are the neighbours' edge rows; beyond the global faces the ghosts are
    the slab's own edge row repeated, or the value ``fill`` when it is
    given."""
    n = len(slabs)
    if not 1 <= halo <= min(s.shape[0] for s in slabs):
        raise ValueError(f"halo must be in [1, the smallest slab "
                         f"({min(s.shape[0] for s in slabs)})], got {halo}")
    out = []
    for i, s in enumerate(slabs):
        dev = s.device
        if i > 0:
            lo = copy_to(slabs[i - 1][-halo:], dev, "halo", True)
        elif fill is None:
            lo = s[:1].expand((halo,) + tuple(s.shape[1:]))
        else:
            lo = torch.full((halo,) + tuple(s.shape[1:]), fill,
                            dtype=s.dtype, device=dev)
        if i < n - 1:
            hi = copy_to(slabs[i + 1][:halo], dev, "halo", True)
        elif fill is None:
            hi = s[-1:].expand((halo,) + tuple(s.shape[1:]))
        else:
            hi = torch.full((halo,) + tuple(s.shape[1:]), fill,
                            dtype=s.dtype, device=dev)
        out.append((lo, hi))
    return out
