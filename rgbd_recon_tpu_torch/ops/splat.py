"""Point/fragment splatting, the substitute for rasterization (counterpart
of rgbd_recon_tpu/ops/splat.py).

The reference's non-TSDF modes rasterize proxy geometry (GL_POINTS per
depth pixel, screen-space triangle grids). Here that is a z-buffered
scatter: project the points, scatter-min a depth buffer, then resolve the
attributes of the fragments that won. Every candidate fragment is computed
and losers are masked, so shapes do not depend on the data; a masked
fragment scatters ``inf`` (or 0) to index 0.

The z-buffer is a min, which does not depend on the order of the scatter,
so it is the same on every device. The epsilon accumulation is a float
scatter-add: on a CUDA device ``index_add_`` adds with atomics in an order
that changes from run to run, so its sums spread in the last bits there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# |pixel index| beyond this is off-screen for any image; clamping before
# the int32 conversion keeps far-off fragments from wrapping around
_INDEX_BOUND = float(1 << 24)


def project_points(world: torch.Tensor, camera):
    """World positions (..., 3) -> (pixel xy (..., 2) float, view_z (...)).

    ``camera`` is an ops.raymarch.ViewCamera. view_z is the positive
    distance along the view direction (GL -z)."""
    view = camera.world_to_view(world)
    z = -view[..., 2]
    safe_z = torch.clamp_min(z, 1e-6)
    tan_half = float(np.tan(np.radians(camera.fov_y) * 0.5))
    aspect = camera.width / camera.height
    ndc_x = view[..., 0] / (safe_z * tan_half * aspect)
    ndc_y = view[..., 1] / (safe_z * tan_half)
    px = (ndc_x * 0.5 + 0.5) * camera.width - 0.5
    py = (0.5 - ndc_y * 0.5) * camera.height - 0.5
    return torch.stack([px, py], dim=-1), z


def _pixel_ids(xy: torch.Tensor):
    """Round half to even (jnp.round and torch.round agree) to int32."""
    r = torch.clamp(torch.round(xy), -_INDEX_BOUND, _INDEX_BOUND)
    return r[:, 0].to(torch.int32), r[:, 1].to(torch.int32)


def _taps(xy, valid, radius, max_radius: int, H: int, W: int):
    """For each (dy, dx) of the (2 max_radius + 1)^2 footprint: (flat pixel
    index (0 where masked), in-bounds mask) of every fragment; a fragment
    covers the tap when its radius reaches max(|dx|, |dy|)."""
    xi, yi = _pixel_ids(xy)
    for dy in range(-max_radius, max_radius + 1):
        for dx in range(-max_radius, max_radius + 1):
            r = float(max(abs(dx), abs(dy)))
            xx = xi + dx
            yy = yi + dy
            inb = (valid & (radius >= r) & (xx >= 0) & (xx < W) & (yy >= 0)
                   & (yy < H))
            flat = torch.where(inb, yy * W + xx, 0).to(torch.int64)
            yield flat, inb


def zbuffer_min(xy: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                shape: Tuple[int, int], radius: Optional[torch.Tensor] = None,
                max_radius: int = 2) -> torch.Tensor:
    """Scatter-min depth buffer of (P,) fragments with splat radii in
    pixels (None: 1 px). Returns (H, W) float32, inf where empty."""
    H, W = shape
    zbuf = torch.full((H * W,), float("inf"), dtype=torch.float32,
                      device=z.device)
    if radius is None:
        radius = torch.zeros_like(z)
    for flat, inb in _taps(xy, valid, radius, max_radius, H, W):
        zval = torch.where(inb, z, float("inf"))
        zbuf.scatter_reduce_(0, flat, zval, reduce="amin")
    return zbuf.reshape(H, W)


def accumulate_epsilon(xy, z, valid, values: torch.Tensor,
                       weights: torch.Tensor, zbuf: torch.Tensor,
                       epsilon: float, radius: Optional[torch.Tensor] = None,
                       max_radius: int = 2):
    """Visibility-epsilon additive accumulation (the trigrid second pass,
    glsl/trigrid_accum.fs:61-76): fragments within ``epsilon`` of the
    pass-1 depth at their pixel add their premultiplied (P, C) values and
    (P,) weights. Returns (accum (H, W, C), weight (H, W))."""
    H, W = zbuf.shape
    C = values.shape[-1]
    acc = torch.zeros((H * W, C), dtype=torch.float32, device=z.device)
    wacc = torch.zeros((H * W,), dtype=torch.float32, device=z.device)
    zflat = zbuf.reshape(-1)
    if radius is None:
        radius = torch.zeros_like(z)
    for flat, inb in _taps(xy, valid, radius, max_radius, H, W):
        zhere = zflat[flat]
        visible = (inb & (torch.abs(z - zhere) <= epsilon)
                   & torch.isfinite(zhere))
        acc.index_add_(0, flat, torch.where(visible[:, None], values, 0.0))
        wacc.index_add_(0, flat, torch.where(visible, weights, 0.0))
    return acc.reshape(H, W, C), wacc.reshape(H, W)


def resolve_winners(xy, z, valid, values: torch.Tensor, zbuf: torch.Tensor,
                    radius: Optional[torch.Tensor] = None,
                    max_radius: int = 2, z_tol: float = 1e-5):
    """Nearest-fragment resolve: each pixel takes the (P, C) attribute of
    the fragment that won the z-buffer (point-mode rendering); fragments
    within ``z_tol`` of the winner average. Returns (image, covered)."""
    acc, w = accumulate_epsilon(xy, z, valid, values, torch.ones_like(z),
                                zbuf, epsilon=z_tol, radius=radius,
                                max_radius=max_radius)
    return acc / torch.clamp_min(w, 1.0)[..., None], w > 0
