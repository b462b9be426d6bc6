"""Brick occupancy marking (counterpart of rgbd_recon_tpu/ops/bricks.py).

mark_brick (inc_bricks.glsl:40-58): every valid depth pixel's world position
counts toward its brick and, near a brick border, toward the neighbor brick
along the dominant offset axis. The counts are an exact integer histogram
(``bincount``) where the reference atomically increments SSBO counters.
"""

from __future__ import annotations

import torch


def mark_bricks(world_pos: torch.Tensor, valid: torch.Tensor,
                bbox_min: torch.Tensor, brick_size: float,
                brick_res: tuple) -> torch.Tensor:
    """Brick counters for one frame, (Bz, By, Bx) int32. Keeps the
    reference's quirk of testing only the x offset for the neighbor
    condition (inc_bricks.glsl:52)."""
    bx, by, bz = brick_res
    p = world_pos.reshape(-1, 3)
    v = valid.reshape(-1)
    hi = torch.tensor([bx - 1, by - 1, bz - 1], dtype=torch.int32,
                      device=p.device)
    zero = torch.zeros_like(hi)

    rel = (p - bbox_min) / brick_size
    idx = torch.minimum(torch.maximum(torch.floor(rel).to(torch.int32), zero),
                        hi)
    flat_own = (idx[:, 2] * by + idx[:, 1]) * bx + idx[:, 0]

    brick_center = (idx.to(torch.float32) + 0.5) * brick_size + bbox_min
    diff = p - brick_center
    d_abs = torch.abs(diff)
    min_v = d_abs.max(dim=-1, keepdim=True).values
    min_c = torch.where(d_abs < min_v, 0.0, 1.0)
    offset = torch.sign(diff * min_c).to(torch.int32)
    nidx = torch.minimum(torch.maximum(idx + offset, zero), hi)
    flat_n = (nidx[:, 2] * by + nidx[:, 1]) * bx + nidx[:, 0]
    near_border = d_abs[:, 0] > brick_size * 0.1

    flat = torch.cat([flat_own[v], flat_n[v & near_border]]).to(torch.int64)
    B = bz * by * bx
    counts = torch.bincount(flat, minlength=B)
    return counts.to(torch.int32).reshape(bz, by, bx)


def occupied_mask(counts: torch.Tensor, min_voxels: int = 10) -> torch.Tensor:
    """(Bz, By, Bx) bool occupancy (brick_occupied, inc_bricks.glsl:60-62)."""
    return counts > min_voxels


def expand_mask_to_voxel_grid(mask: torch.Tensor, vol_shape: tuple,
                              bbox_size: tuple,
                              brick_size: float) -> torch.Tensor:
    """(Bz, By, Bx) brick mask -> (Z, Y, X) voxel mask: each voxel takes
    the brick containing its center, floor(world offset / brick_size),
    clamped to the brick grid."""
    Z, Y, X = vol_shape
    sx, sy, sz = bbox_size
    Bz, By, Bx = mask.shape

    def axis_idx(R, B, size):
        i = torch.arange(R, dtype=torch.float32, device=mask.device)
        b = torch.floor((i + 0.5) / R * (size / brick_size)).to(torch.int64)
        return torch.clamp(b, 0, B - 1)

    iz = axis_idx(Z, Bz, sz)
    iy = axis_idx(Y, By, sy)
    ix = axis_idx(X, Bx, sx)
    return mask[iz][:, iy][:, :, ix]
