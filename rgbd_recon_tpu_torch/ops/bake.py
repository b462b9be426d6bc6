"""March-volume bake: CUDA kernels and their plain twins.

Counterpart of rgbd_recon_tpu/ops/bake_pallas.py plus the jnp reference
forms it fuses (tsdf_pipeline._surface_brick_mask, fine_safe_field,
sentinel_volume and the bf16 cast of PackedVolume.from_volume), and of the
render's brick clearance (tsdf_pipeline.brick_safe_field).
``surface_occ``, ``brick_clearance`` and ``sentinel_bake`` run the plain
PyTorch version for CPU tensors and the CUDA kernel (csrc/bake.cu) for
CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .tsdf import brick_layout


def dilate3(mask: torch.Tensor) -> torch.Tensor:
    """1-step Chebyshev (3x3x3 box) dilation of a bool (Z, Y, X) mask with
    zero padding at the faces (tsdf_pipeline._dilate3)."""
    m = mask.to(torch.float32)[None, None]
    return F.max_pool3d(m, 3, stride=1, padding=1)[0, 0] > 0.0


def brick_any(mask: torch.Tensor, brick_vox: int) -> torch.Tensor:
    """(Z, Y, X) bool -> (Bz, By, Bx) bool any-pool (tsdf_pipeline._brick_any)."""
    Z, Y, X = mask.shape
    (Bz, By, Bx), (Zp, Yp, Xp) = brick_layout((Z, Y, X), brick_vox)
    v = brick_vox
    m = F.pad(mask, (0, Xp - X, 0, Yp - Y, 0, Zp - Z))
    return m.reshape(Bz, v, By, v, Bx, v).any(dim=5).any(dim=3).any(dim=1)


def surface_occ_plain(volume: torch.Tensor, brick_vox: int) -> torch.Tensor:
    """Bricks whose 1-voxel-dilated positive set is non-empty."""
    return brick_any(dilate3(volume > 0.0), brick_vox)


def fine_safe_field(pos_mask: torch.Tensor, rounds: int) -> torch.Tensor:
    """(Z, Y, X) f32 count of dilation rounds 1..rounds that have not reached
    a voxel = clamp(chebyshev distance to pos_mask - 1, 0, rounds)."""
    reach = pos_mask
    safe = torch.zeros(pos_mask.shape, dtype=torch.float32,
                       device=pos_mask.device)
    for _ in range(rounds):
        reach = dilate3(reach)
        safe = safe + (~reach).to(torch.float32)
    return safe


def brick_clearance_plain(occ: torch.Tensor, rounds: int, brick_vox: int):
    """(Bz, By, Bx) bool surface-brick mask -> (bsafe, bs_scaled), f32:
    bsafe counts the ``rounds`` dilation rounds of the mask that have not
    reached a brick (fine_safe_field over the brick grid, the JAX
    brick_safe_field), bs_scaled = bsafe * brick_vox (sentinel_bake's
    input)."""
    bsafe = fine_safe_field(occ, rounds)
    return bsafe, bsafe * float(brick_vox)


def sentinel_bake_plain(volume: torch.Tensor, bs_scaled: torch.Tensor,
                        brick_vox: int, rounds: int,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """-(2 + max(fine_safe, bs_scaled broadcast over its brick)) where that
    field is positive, else the TSDF value; cast to ``out_dtype`` (bf16,
    or f32 for an f32 march table)."""
    return sentinel_encode(volume, fine_safe_field(volume > 0.0, rounds),
                           bs_scaled, brick_vox, out_dtype)


def sentinel_encode(volume: torch.Tensor, fine: torch.Tensor,
                    bs_scaled: torch.Tensor, brick_vox: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The encode of :func:`sentinel_bake_plain` from a given voxel
    clearance ``fine``: ``bs_scaled``'s first brick row covers the
    volume's first voxel row (a z-slab passes its own brick rows)."""
    Z, Y, X = volume.shape
    v = brick_vox
    bs_vox = (bs_scaled.repeat_interleave(v, 0).repeat_interleave(v, 1)
              .repeat_interleave(v, 2))[:Z, :Y, :X]
    field = torch.maximum(fine, bs_vox)
    return torch.where(field > 0.0, -(2.0 + field), volume).to(out_dtype)


def uses_kernel_bake(brick_vox: int, rounds: int) -> bool:
    """Whether a render's march table comes from ``sentinel_bake`` (the
    kernel, on the card) or from ``sentinel_bake_plain``: a choice by
    configuration, as the JAX package makes it. Its Pallas bake runs only
    when brick_vox >= skip_fine_rounds (rgbd_recon_tpu/recon/
    tsdf_pipeline.py:1114-1118), its jnp bake otherwise (:1151-1166). The
    JAX rule's other terms are the Pallas kernel's layout limits (a
    brick-aligned half-pair table, its fused surface mask); the CUDA kernel
    takes any layout."""
    return rounds <= brick_vox


def surface_occ(volume: torch.Tensor, brick_vox: int) -> torch.Tensor:
    """(Bz, By, Bx) bool surface-brick mask; CUDA kernel on a CUDA tensor,
    plain version on a CPU tensor."""
    if volume.device.type == "cpu":
        return surface_occ_plain(volume, brick_vox)
    from ..kernels.bake import surface_occ_cuda

    return surface_occ_cuda(volume, brick_vox)


def sentinel_bake(volume: torch.Tensor, bs_scaled: torch.Tensor,
                  brick_vox: int, rounds: int,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Z, Y, X) sentinel-coded march table in ``out_dtype``; CUDA kernel
    on a CUDA tensor, plain version on a CPU tensor."""
    if volume.device.type == "cpu":
        return sentinel_bake_plain(volume, bs_scaled, brick_vox, rounds,
                                   out_dtype)
    from ..kernels.bake import sentinel_bake_cuda

    return sentinel_bake_cuda(volume, bs_scaled, brick_vox, rounds,
                              out_dtype)


def brick_clearance(occ: torch.Tensor, rounds: int, brick_vox: int):
    """(bsafe, bs_scaled) of :func:`brick_clearance_plain`; one CUDA
    kernel launch on a CUDA tensor, the plain version on a CPU tensor."""
    if occ.device.type == "cpu":
        return brick_clearance_plain(occ, rounds, brick_vox)
    from ..kernels.bake import brick_clearance_cuda

    return brick_clearance_cuda(occ.contiguous(), rounds, brick_vox)
