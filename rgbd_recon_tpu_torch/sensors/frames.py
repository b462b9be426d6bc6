"""Frame container: one synchronized multi-sensor capture (counterpart of
rgbd_recon_tpu/sensors/frames.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FrameSet:
    """One synchronized frame from N sensors."""

    colors: torch.Tensor     # (N, Hc, Wc, 3) float32 [0,1]
    depths: torch.Tensor     # (N, H, W) float32 meters
    timestamp: torch.Tensor  # () float32 seconds

    @property
    def num_sensors(self) -> int:
        return self.colors.shape[0]

    @property
    def depth_size(self):
        return tuple(self.depths.shape[1:3])

    @property
    def color_size(self):
        return tuple(self.colors.shape[1:3])
