"""The device an entry point runs on: the card, unless the caller names
another. Without a card a call that names none raises; it never falls back
to the CPU."""

from __future__ import annotations

import torch

DEFAULT = torch.device("cuda")


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device; raises when it is a CUDA device and
    this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run on the CPU")
    return dev
