"""Halo exchange for z-sharded volumes (counterpart of
rgbd_recon_tpu/dist/halo.py).

A stencil over a z-sharded volume needs ``halo`` ghost rows from each
neighbouring shard. The volume is the tuple of its z-slabs in order, each
on its mesh device; the exchange copies the neighbours' edge rows
(collectives.halo_shift). Beyond the global z faces the ghosts repeat the
edge slab, as the JAX package's docstring says; its body fills them with
the first ``halo`` rows of the shard instead, which agrees only at
halo = 1 (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .collectives import halo_shift


def halo_exchange_z(slabs: Sequence[torch.Tensor], halo: int = 1,
                    fill=None, mesh=None) -> Tuple[torch.Tensor, ...]:
    """Each (Zl, ...) slab extended to (Zl + 2 halo, ...) with its ghost
    rows: the neighbours' edge rows inside, the edge row repeated at the
    global faces (or the value ``fill`` there when it is given). Over a
    ``mesh`` of several processes, ``slabs`` are this process's own. Use
    :func:`crop_halo_z` to drop them after the stencil."""
    return tuple(torch.cat([lo, s, hi], dim=0) for s, (lo, hi) in zip(
        slabs, halo_shift(slabs, halo, fill, mesh)))


def crop_halo_z(slabs: Sequence[torch.Tensor],
                halo: int = 1) -> Tuple[torch.Tensor, ...]:
    """Drop the ghost rows that :func:`halo_exchange_z` added."""
    return tuple(s[halo:-halo] for s in slabs)
