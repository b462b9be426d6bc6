"""Launch wrapper of csrc/compact.cu (the render's fixed-capacity
compaction: one launch a list, no host sync)."""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, library

_MAX_ENTRIES = 2 ** 31

# the look-back's zeroed scratch, one a (device index, stream handle): each
# launch leaves it zeroed for the next on its stream (and for the replays
# of a graph captured there), and launches on other streams, which may run
# at the same time, have their own
_SCRATCH: dict = {}


def _scratch(lib, dev: torch.device, stream) -> torch.Tensor:
    """The scratch of ``stream``, the current stream of ``dev``, made
    (zeroed, on that stream) at its first launch there; a stream that is
    capturing a graph must have launched a compaction before."""
    key = (dev.index, stream.cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("compact: launch once on a stream before "
                               "capturing a graph of it (its scratch is "
                               "made then)")
        buf = torch.zeros(lib.rgbd_compact_scratch_words(),
                          dtype=torch.int64, device=dev)
        _SCRATCH[key] = buf
    return buf


def compact_cuda(flags: torch.Tensor, bit: int, capacity: int,
                 counts: torch.Tensor, count_slot: int,
                 want_slot: bool = False):
    """:func:`ops.compact.compact_plain` in one launch: same arguments,
    same (ids, slot). ``flags`` is a contiguous (n,) uint8 CUDA tensor on
    an 8-byte boundary, ``counts`` a contiguous int32 tensor on its
    device. Compactions on one stream share a scratch (``_scratch``), so a
    graph captured with one must not be replayed while another compaction
    runs on the stream it was captured on."""
    if (not isinstance(flags, torch.Tensor) or flags.dtype != torch.uint8
            or flags.dim() != 1 or not flags.is_contiguous()):
        raise ValueError("flags must be a contiguous (n,) uint8 tensor")
    if flags.data_ptr() % 8:
        raise ValueError("flags must start on an 8-byte boundary")
    if not 0 <= bit <= 7:
        raise ValueError(f"bit must be in [0, 7], got {bit}")
    n = flags.shape[0]
    if n >= _MAX_ENTRIES or not 0 <= capacity < _MAX_ENTRIES:
        raise ValueError(f"at most 2^31 - 1 flags and list entries, got {n} "
                         f"and {capacity}")
    if (not isinstance(counts, torch.Tensor) or counts.dtype != torch.int32
            or counts.device != flags.device or not counts.is_contiguous()
            or not 0 <= count_slot < counts.numel()):
        raise ValueError("counts must be a contiguous int32 tensor on the "
                         f"flags' device with an entry {count_slot}")
    dev = flags.device
    if dev.type != "cuda":
        raise ValueError(f"flags must be a CUDA tensor, got {dev}")
    ids = torch.empty(capacity, dtype=torch.int64, device=dev)
    slot = (torch.empty(n, dtype=torch.int32, device=dev) if want_slot
            else None)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        scratch = _scratch(lib, dev, stream)
        err = lib.rgbd_compact(
            flags.data_ptr(), n, bit, capacity, ids.data_ptr(),
            slot.data_ptr() if slot is not None else None,
            counts.data_ptr() + 4 * count_slot, scratch.data_ptr(),
            stream.cuda_stream)
    check(err, "compact")
    LAUNCHES["compact"] += 1
    return ids, slot
