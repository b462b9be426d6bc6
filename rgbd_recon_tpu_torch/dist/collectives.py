"""The collectives of the mesh, as explicit copies.

A process holds its own shards: a shard is a tensor on its mesh device, and
a collective is a set of ``Tensor.to(device, non_blocking=True)`` copies
plus the arithmetic that joins them, in shard order so that the result does
not depend on the devices or the processes. A copy between tensors on one
device is no copy. When the mesh spans several processes (``dist/process.py``),
each process passes its own shards' parts, and the parts of the others
arrive by ``torch.distributed.all_gather`` over the process group: NCCL on
the process's first shard's card, or gloo through the host (CUDA tensors
are staged through host memory explicitly). Every function counts bytes by
collective: in :data:`BYTES` those it copies between two devices of this
process, in :data:`SHARD_BYTES` those it hands from one shard to another
whatever their devices and processes (what a mesh of one device per shard
would copy; a gather or a sum lands on this process's first shard), in
:data:`PROCESS_BYTES` those this process receives from the others, and in
:data:`HOST_BYTES` those staged through the host on their way (to the host
and back).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

# collective -> bytes copied between two devices, handed between two
# shards, received from other processes and staged through the host, in
# this process (reset_bytes() zeroes them)
BYTES = {"all_gather": 0, "psum": 0, "halo": 0, "broadcast": 0,
         "scatter": 0}
SHARD_BYTES = dict(BYTES)
PROCESS_BYTES = dict(BYTES)
HOST_BYTES = dict(BYTES)


def reset_bytes() -> None:
    for counts in (BYTES, SHARD_BYTES, PROCESS_BYTES, HOST_BYTES):
        for k in counts:
            counts[k] = 0


def bytes_moved() -> dict:
    return {"between_devices": dict(BYTES),
            "between_shards": dict(SHARD_BYTES),
            "between_processes": dict(PROCESS_BYTES),
            "through_host": dict(HOST_BYTES)}


def _spans(mesh) -> bool:
    return mesh is not None and mesh.multiprocess


def _exchange(local: Sequence[torch.Tensor], kind: str,
              mesh) -> List[torch.Tensor]:
    """Every shard's part in shard order: this process's own ``local`` (one
    per local shard, in order, all of one shape and dtype) as they are,
    the other processes' received on the device of this process's first
    shard. One all-gather of the raw bytes, so that any dtype crosses."""
    import torch.distributed as tdist

    stage = local[0].device
    mine = torch.stack([copy_to(t, stage, kind) for t in local])
    raw = mine.reshape(-1).view(torch.uint8)
    nccl = tdist.get_backend() == "nccl"
    if not nccl and raw.device.type != "cpu":
        HOST_BYTES[kind] += raw.numel()
        raw = raw.cpu()
    bufs = [torch.empty_like(raw) for _ in range(tdist.get_world_size())]
    tdist.all_gather(bufs, raw)
    parts = []
    for p, buf in enumerate(bufs):
        if p == mesh.process:
            parts.extend(local)
            continue
        PROCESS_BYTES[kind] += buf.numel()
        if buf.device != stage:
            HOST_BYTES[kind] += buf.numel()
            buf = buf.to(stage)
        parts.extend(buf.view(mine.dtype).reshape(mine.shape).unbind(0))
    return parts


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


def _every_part(parts: Sequence[torch.Tensor], kind: str, mesh):
    """(every shard's part in shard order, the shard they land on): the
    given parts and shard 0 in one process; across processes, each process
    passes its own shards' parts and they land on its first shard."""
    if _spans(mesh):
        return _exchange(parts, kind, mesh), mesh.local[0]
    return parts, 0


def all_gather(shards: Sequence[torch.Tensor], device: torch.device,
               dim: int = 0, mesh=None) -> torch.Tensor:
    """The shards concatenated along ``dim`` in shard order, on ``device``,
    shard 0's (each destination of an all-gather calls this once). Over a
    mesh of several processes, ``shards`` are this process's own and
    ``device`` is its first shard's; every process gets the whole."""
    parts, dest = _every_part(shards, "all_gather", mesh)
    return torch.cat([copy_to(t, device, "all_gather", i != dest)
                      for i, t in enumerate(parts)], dim=dim)


def psum(parts: Sequence[torch.Tensor], device: torch.device,
         mesh=None) -> torch.Tensor:
    """The sum of the shards' partials on ``device``, shard 0's, added in
    shard order (((p0 + p1) + p2) + ...), so that it is the same on any
    mesh. Over several processes it is an all-gather of the partials and
    that sum on each (never ``all_reduce``, whose order is the
    backend's)."""
    parts, dest = _every_part(parts, "psum", mesh)
    acc = copy_to(parts[0], device, "psum", dest != 0)
    for i, p in enumerate(parts[1:], 1):
        acc = acc + copy_to(p, device, "psum", i != dest)
    return acc


def halo_shift(slabs: Sequence[torch.Tensor], halo: int, fill=None,
               mesh=None):
    """Per slab (its axis 0 the sharded z): (the ``halo`` rows below it,
    the ``halo`` rows above it), each on the slab's device. Interior ghosts
    are the neighbours' edge rows; beyond the global faces the ghosts are
    the slab's own edge row repeated, or the value ``fill`` when it is
    given. Over a mesh of several processes, ``slabs`` are this process's
    own (all of one shape) and every slab's edge rows cross in one
    all-gather."""
    if not 1 <= halo <= min(s.shape[0] for s in slabs):
        raise ValueError(f"halo must be in [1, the smallest slab "
                         f"({min(s.shape[0] for s in slabs)})], got {halo}")
    shards = range(len(slabs))
    # each shard's (first halo rows, last halo rows)
    edges = [(s[:halo], s[-halo:]) for s in slabs]
    if _spans(mesh):
        shards = mesh.local
        edges = _exchange([torch.stack(e) for e in edges], "halo", mesh)
    n = len(edges)
    out = []
    for i, s in zip(shards, slabs):
        dev = s.device
        if i > 0:
            lo = copy_to(edges[i - 1][1], dev, "halo", True)
        elif fill is None:
            lo = s[:1].expand((halo,) + tuple(s.shape[1:]))
        else:
            lo = torch.full((halo,) + tuple(s.shape[1:]), fill,
                            dtype=s.dtype, device=dev)
        if i < n - 1:
            hi = copy_to(edges[i + 1][0], dev, "halo", True)
        elif fill is None:
            hi = s[-1:].expand((halo,) + tuple(s.shape[1:]))
        else:
            hi = torch.full((halo,) + tuple(s.shape[1:]), fill,
                            dtype=s.dtype, device=dev)
        out.append((lo, hi))
    return out
