"""Fixed-capacity stream compaction of a flag array (the render's block,
tail and hit lists; counterpart of the ``jnp.nonzero(size=, fill_value=)``
compactions of rgbd_recon_tpu/recon/tsdf_pipeline.py:1292, :1425, :1465).

``compact`` is the dispatch: CUDA tensors go to csrc/compact.cu (one
launch, kernels/compact.py), CPU tensors to the plain twin
``compact_plain``. Neither reads anything back to the host. On the card
each stream keeps its own scratch for the kernel's look-back, so
compactions on different streams may run at once.
"""

from __future__ import annotations

import torch


def compact_plain(flags: torch.Tensor, bit: int, capacity: int,
                  counts: torch.Tensor, count_slot: int,
                  want_slot: bool = False):
    """The first ``capacity`` indices i of the (n,) uint8 ``flags`` whose
    bit ``bit`` is set, in ascending order, padded with n: (ids (capacity,)
    int64, slot (n,) int32 or None). ``counts[count_slot]`` receives the
    number of set flags as int32 (it may exceed ``capacity``). ``slot[i]``
    is i's position in ``ids``, -1 where i is not listed (unset, or past
    the capacity). Built on a cumulative sum: no host sync."""
    n = flags.shape[0]
    dev = flags.device
    m = (flags & (1 << bit)) != 0
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    keep = m & (pos < capacity)
    # listed positions get their index, the rest write the spare entry
    target = torch.where(keep, pos, capacity)
    ids = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev)
    ids.scatter_(0, target, torch.arange(n, dtype=torch.int64, device=dev))
    ids = ids[:capacity]
    counts[count_slot] = m.sum(dtype=torch.int32)
    slot = (torch.where(keep, pos, -1).to(torch.int32) if want_slot
            else None)
    return ids, slot


def compact(flags: torch.Tensor, bit: int, capacity: int,
            counts: torch.Tensor, count_slot: int,
            want_slot: bool = False):
    """:func:`compact_plain`: one launch of csrc/compact.cu on CUDA
    tensors, the plain version on CPU tensors. Same arguments and
    results."""
    if flags.device.type == "cpu":
        return compact_plain(flags, bit, capacity, counts, count_slot,
                             want_slot)
    from ..kernels.compact import compact_cuda

    return compact_cuda(flags, bit, capacity, counts, count_slot, want_slot)

