"""Brick occupancy marking (counterpart of rgbd_recon_tpu/ops/bricks.py).

mark_brick (inc_bricks.glsl:40-58): every valid depth pixel's world position
counts toward its brick and, near a brick border, toward the neighbor brick
along the dominant offset axis. The counts are an exact integer histogram
(``bincount``) where the reference atomically increments SSBO counters.

``mark_pixels`` is the fuse's marking (TsdfPipeline._mark_bricks): one
launch of csrc/fuse.cu on CUDA tensors (kernels/fuse.py), its plain twin
``mark_pixels_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch


def sample_pixels(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The stride-sampled pixels (n, s//2 + s i, s//2 + s j) of an (N, H,
    W, ...) map."""
    return x[:, stride // 2::stride, stride // 2::stride] if stride > 1 else x


def mark_pixels_plain(depth: torch.Tensor, bbox_min: torch.Tensor,
                      brick_size: float, brick_res: tuple, stride: int,
                      ray_a=None, ray_b=None, worlds=None) -> torch.Tensor:
    """The fuse's brick counts, (Bz, By, Bx) int32: every ``stride``-th
    pixel of the (N, H, W) normalized ``depth`` with 0 < d < 1 marks
    :func:`mark_bricks` at its world point and counts stride^2. The world
    point is ray_a + ray_b * d from the (N, H, W, 3) pixel models, or the
    given (N, Hs, Ws, 3) ``worlds`` of the sampled pixels (the calibration
    volumes' lookup)."""
    d = sample_pixels(depth, stride)
    valid = (d > 0.0) & (d < 1.0)
    if worlds is None:
        ra, rb = sample_pixels(ray_a, stride), sample_pixels(ray_b, stride)
        worlds = torch.stack([ra[..., j] + rb[..., j] * d for j in range(3)],
                             dim=-1)
    counts = mark_bricks(worlds, valid, bbox_min, brick_size, brick_res)
    return counts * (stride * stride)


def mark_pixels(depth: torch.Tensor, bbox_min: torch.Tensor,
                brick_size: float, brick_res: tuple, stride: int,
                ray_a=None, ray_b=None, worlds=None) -> torch.Tensor:
    """:func:`mark_pixels_plain`: one launch of csrc/fuse.cu on CUDA
    tensors, no host sync; the plain version on CPU tensors. Same
    arguments and result."""
    if depth.device.type == "cpu":
        return mark_pixels_plain(depth, bbox_min, brick_size, brick_res,
                                 stride, ray_a, ray_b, worlds)
    from ..kernels.fuse import brick_mark_cuda

    return brick_mark_cuda(depth, bbox_min, brick_size, brick_res, stride,
                           ray_a, ray_b, worlds)


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
