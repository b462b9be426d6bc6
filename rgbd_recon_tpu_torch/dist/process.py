"""Processes of a mesh that spans several (the counterpart of
``jax.distributed`` in rgbd_recon_tpu/dist/mesh.py).

    from rgbd_recon_tpu_torch import dist
    dist.initialize("127.0.0.1:12655", num_processes=2, process_id=rank,
                    backend="gloo")
    mesh = dist.make_mesh(devices_per_process=4, device="cpu")

Every process builds the same pipeline from the same inputs, then runs the
same sharded step over the global mesh: each launches only its own shards,
and the collectives (``dist/collectives.py``) carry the parts of the others
over the process group. The caller picks the backend and nothing picks it
for them:

- ``"nccl"``: one GPU per process. NCCL refuses two ranks on one GPU, so a
  mesh that puts two processes on one card raises under it;
- ``"gloo"``: CPU shards, or processes that share a card (their CUDA
  tensors are staged through the host, and counted).
"""

from __future__ import annotations

import datetime
import socket
from typing import Sequence

import torch

BACKENDS = ("gloo", "nccl")
# the group that carries Python objects between the processes: a gloo group
# beside an NCCL one (so that a mesh NCCL cannot carry is refused before
# NCCL is asked for anything), else the default group
_objects_group = None


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str, timeout_s: float = 300.0) -> None:
    """Join the process group at ``coordinator`` ("host:port", process 0
    listens there) as ``process_id`` of ``num_processes``."""
    global _objects_group
    import torch.distributed as tdist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device; use gloo "
                           "for CPU shards")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, "
                         f"{num_processes})")
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _objects_group = (tdist.new_group(backend="gloo") if backend == "nccl"
                      else None)


def initialized() -> bool:
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as tdist

    global _objects_group
    if initialized():
        tdist.destroy_process_group()
    _objects_group = None


def device_key(device: torch.device) -> tuple:
    """What names ``device`` across the processes of one job: (host,
    device type, the card's UUID), since a process may see a card under
    another index, or (host, device type, its name) where there is no
    UUID."""
    name = str(device)
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        name = name if uuid is None else str(uuid)
    return (socket.gethostname(), device.type, name)


def check_backend(backend: str, keys_by_process: Sequence[Sequence[tuple]]
                  ) -> None:
    """Raise when ``backend`` cannot carry a mesh whose processes hold the
    devices ``keys_by_process`` (each process's shards' :func:`device_key`):
    NCCL takes CUDA devices only, and one process per GPU."""
    if backend != "nccl":
        return
    owner = {}
    for p, keys in enumerate(keys_by_process):
        for k in keys:
            if k[1] != "cuda":
                raise ValueError(f"the nccl backend carries CUDA tensors "
                                 f"only; process {p} has a shard on {k}: "
                                 "use gloo")
            if owner.setdefault(k, p) != p:
                raise ValueError(
                    f"NCCL refuses two ranks on one GPU: processes "
                    f"{owner[k]} and {p} both have shards on {k}; give each "
                    "process its own card or use the gloo backend")


def all_objects(obj) -> list:
    """``obj`` of every process, in rank order."""
    import torch.distributed as tdist

    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj, group=_objects_group)
    return out
