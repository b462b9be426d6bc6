"""13x13 preprocessing window sums: CUDA kernels and their plain twins.

Counterpart of rgbd_recon_tpu/ops/stencil_pallas.py. ``bilateral13`` and
``quality13`` run the plain PyTorch fold for CPU tensors and the CUDA kernel
(csrc/stencil13.cu) for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KS = 6  # window radius: 13x13 (pre_depth.fs / pre_quality.fs)
# dist_range_max = 0.35 * d / 4.5 (pre_depth.fs:89-91) with the constants
# folded into one f32 factor, as the compiled JAX reference evaluates it;
# a multiply also rounds the same in the CUDA kernel and in PyTorch (which
# turns a division by a Python scalar into a reciprocal multiply on CUDA)
_DRM_SCALE = float(np.float32(0.35 / 4.5))

# gauss_space per (dy, dx): 1 - sqrt(dy^2 + dx^2) / 6, rounded once in f32
_GAUSS_SPACE = [
    [float(np.float32(1.0) - np.sqrt(np.float32(dy * dy + dx * dx))
           / np.float32(KS)) for dx in range(-KS, KS + 1)]
    for dy in range(-KS, KS + 1)
]


def _edge_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W) -> (N, H+2k, W+2k), edge-replicated."""
    return F.pad(x, (k, k, k, k), mode="replicate")


def bilateral13_plain(depth_m: torch.Tensor, depth_limits: torch.Tensor):
    """(N, H, W) metric depth + (N, 2) [near, far] -> (sum w*s, sum w,
    sum gauss_range): the tap fold of stencil_pallas._bilateral_kernel
    (dy outer, dx inner)."""
    N, H, W = depth_m.shape
    near = depth_limits[:, 0].view(N, 1, 1)
    far = depth_limits[:, 1].view(N, 1, 1)
    d = depth_m
    drm = d * _DRM_SCALE
    drm_safe = torch.clamp_min(drm, 1e-20)
    pad = _edge_pad(d, KS)
    bf = torch.zeros_like(d)
    w = torch.zeros_like(d)
    wr = torch.zeros_like(d)
    for iy, dy in enumerate(range(-KS, KS + 1)):
        for ix, dx in enumerate(range(-KS, KS + 1)):
            s = pad[:, KS + dy: KS + dy + H, KS + dx: KS + dx + W]
            rng = torch.abs(s - d)
            border = (s < near) | (s > far) | (rng > drm)
            gauss_range = 1.0 - torch.minimum(rng, drm) / drm_safe
            w_s = torch.where(border, 0.0, _GAUSS_SPACE[iy][ix] * gauss_range)
            bf = bf + w_s * s
            w = w + w_s
            wr = wr + torch.where(border, 0.0, gauss_range)
    return bf, w, wr


def quality13_plain(depth_norm: torch.Tensor):
    """(N, H, W) normalized depth -> (border count, range-weight sum): the
    census fold of stencil_pallas._quality_kernel."""
    N, H, W = depth_norm.shape
    d = depth_norm
    drm = 0.35 * d
    drm_safe = torch.clamp_min(drm, 1e-20)
    pad = _edge_pad(d, KS)
    border_n = torch.zeros_like(d)
    wr = torch.zeros_like(d)
    for dy in range(-KS, KS + 1):
        for dx in range(-KS, KS + 1):
            s = pad[:, KS + dy: KS + dy + H, KS + dx: KS + dx + W]
            rng = torch.abs(s - d)
            border = (s <= 0.0) | (s >= 1.0) | (rng > drm)
            gauss_range = 1.0 - torch.minimum(rng, drm) / drm_safe
            border_n = border_n + border.to(d.dtype)
            wr = wr + torch.where(border, 0.0, gauss_range)
    return border_n, wr


def bilateral13(depth_m: torch.Tensor, depth_limits: torch.Tensor):
    """Bilateral window sums; CUDA kernel on a CUDA tensor, plain fold on a
    CPU tensor."""
    if depth_m.device.type == "cpu":
        return bilateral13_plain(depth_m, depth_limits)
    from ..kernels.stencil13 import bilateral13_cuda

    return bilateral13_cuda(depth_m, depth_limits)


def quality13(depth_norm: torch.Tensor):
    """Quality census sums; CUDA kernel on a CUDA tensor, plain fold on a
    CPU tensor."""
    if depth_norm.device.type == "cpu":
        return quality13_plain(depth_norm)
    from ..kernels.stencil13 import quality13_cuda

    return quality13_cuda(depth_norm)
