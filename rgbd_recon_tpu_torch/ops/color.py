"""RGB to CIE LAB (counterpart of rgbd_recon_tpu/ops/color.py).

Replicates glsl/inc_color.glsl including its quirk of dividing [0, 1]
texture values by 255 again (inc_color.glsl:14-16); the reference's color
thresholds are tuned against that compressed scale.
"""

from __future__ import annotations

import torch

_WHITE_REFERENCE = (95.047, 100.000, 108.883)
_EPSILON = 0.008856
_KAPPA = 903.3


def _pivot_rgb(n: torch.Tensor) -> torch.Tensor:
    return torch.where(
        n > 0.04045,
        torch.pow(torch.clamp_min((n + 0.055) / 1.055, 1e-12), 2.4),
        n / 12.92,
    ) * 100.0


def _pivot_xyz(n: torch.Tensor) -> torch.Tensor:
    # cube root of a non-negative value
    return torch.where(
        n > _EPSILON,
        torch.pow(torch.clamp_min(n, 0.0), 1.0 / 3.0),
        (_KAPPA * n + 16.0) / 116.0,
    )


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> (..., 3) LAB (reference-scaled)."""
    n = _pivot_rgb(rgb / 255.0)
    r, g, b = n[..., 0], n[..., 1], n[..., 2]
    x = r * 0.4124 + g * 0.3576 + b * 0.1805
    y = r * 0.2126 + g * 0.7152 + b * 0.0722
    z = r * 0.0193 + g * 0.1192 + b * 0.9505
    px = _pivot_xyz(x / _WHITE_REFERENCE[0])
    py = _pivot_xyz(y / _WHITE_REFERENCE[1])
    pz = _pivot_xyz(z / _WHITE_REFERENCE[2])
    lum = torch.clamp_min(116.0 * py - 16.0, 0.0)
    a = 500.0 * (px - py)
    bb = 200.0 * (py - pz)
    return torch.stack([lum, a, bb], dim=-1)
