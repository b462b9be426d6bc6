"""TSDF integration (counterpart of rgbd_recon_tpu/ops/tsdf.py).

Per voxel (volume-normalized position p), per sensor i in order, the exact
branch structure of glsl/tsdf_integration.vs:23-58: silhouette carve while
nothing is written yet, behind-surface clamp to -limit, in-band quality-
weighted running average. The brick-compact path integrates only occupied
bricks (every other voxel holds the clear value -limit) in a brick-major
layout: the padded volume viewed as (B, V) with B bricks of V =
brick_vox^3 voxels. The dense path integrates every voxel, optionally
gated by a per-voxel mask.

``integrate_compact`` is the fuse's brick-compact integration: on CUDA
tensors the occupied flags, one ops/compact.py compaction (its slot map)
and one launch of csrc/fuse.cu (kernels/fuse.py), with no host sync; on
CPU tensors its plain twin ``integrate_compact_plain``
(``occupied_brick_ids`` then ``integrate_bricks``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import compact as compact_ops
from .sampling import bilinear_2d, quad_bilinear, trilinear_3d


def brick_layout(vol_shape: Tuple[int, int, int], brick_vox: int):
    """((Bz, By, Bx), padded_shape) for viewing a (Z, Y, X) volume as bricks
    of brick_vox^3 voxels."""
    Z, Y, X = vol_shape
    v = brick_vox
    Bz, By, Bx = -(-Z // v), -(-Y // v), -(-X // v)
    return (Bz, By, Bx), (Bz * v, By * v, Bx * v)


def voxel_centers(vol_shape: Tuple[int, int, int],
                  true_shape: Optional[Tuple[int, int, int]] = None,
                  device=None, z0: int = 0) -> torch.Tensor:
    """(Z, Y, X, 3) volume-normalized voxel-center positions (x, y, z) of
    the voxel rows z0 .. z0 + Z; ``true_shape`` normalizes a padded grid
    (or a z-slab of one) by the true resolution so the padding lands
    outside [0, 1]."""
    Z, Y, X = vol_shape
    tz, ty, tx = true_shape or vol_shape
    f32 = torch.float32
    zi = torch.arange(z0, z0 + Z, dtype=f32, device=device).view(Z, 1, 1)
    yi = torch.arange(Y, dtype=f32, device=device).view(1, Y, 1)
    xi = torch.arange(X, dtype=f32, device=device).view(1, 1, X)
    return torch.stack(torch.broadcast_tensors(
        (xi + 0.5) / tx, (yi + 0.5) / ty, (zi + 0.5) / tz), dim=-1)


def bake_projections(cv_xyz_inv: torch.Tensor,
                     vol_shape: Tuple[int, int, int],
                     true_shape: Optional[Tuple[int, int, int]] = None,
                     z0: int = 0):
    """Dense per-voxel projections (pos_calib (N, Z, Y, X, 3), in_frustum
    (N, Z, Y, X) bool): each voxel center's trilinear cv_xyz_inv lookup,
    valid when the interpolated validity channel is > 0.99. ``true_shape``
    and ``z0`` place a z-slab of a (padded) grid as in voxel_centers.
    One-time setup cost."""
    pos = voxel_centers(vol_shape, true_shape, cv_xyz_inv.device, z0)
    pos_calib, in_frustum = [], []
    for inv in cv_xyz_inv:
        look = trilinear_3d(inv, pos)
        pos_calib.append(look[..., :3])
        in_frustum.append(look[..., 3] > 0.99)
        del look
    return torch.stack(pos_calib), torch.stack(in_frustum)


def integrate(vol_shape: Tuple[int, int, int], cv_xyz_inv: torch.Tensor,
              depths: torch.Tensor, qualities: torch.Tensor,
              silhouettes: torch.Tensor, limit: float,
              voxel_mask: Optional[torch.Tensor] = None,
              projections=None, carve_sil_threshold: float = 1.0,
              phantom_hull: bool = False, return_observers: bool = False,
              true_shape: Optional[Tuple[int, int, int]] = None,
              z0: int = 0):
    """Dense integration of every voxel with bilinear map taps; returns the
    (Z, Y, X) volume, -limit outside ``voxel_mask`` when one is given.
    ``projections`` are :func:`bake_projections`' output; without them the
    lookups are made here, at the voxel rows that ``true_shape`` and ``z0``
    give (a z-slab of a padded grid). ``return_observers`` also returns
    the (Z, Y, X) f32 count of sensors that saw each voxel in frustum,
    within the band (|sdist| < limit) and with positive quality:
    (volume, observers)."""
    if projections is None:
        projections = bake_projections(cv_xyz_inv, vol_shape, true_shape, z0)
    pos_calib, in_frustum = projections
    N = depths.shape[0]
    dev = depths.device
    tsd = torch.full(tuple(vol_shape), limit, dtype=torch.float32,
                     device=dev)
    total_w = torch.zeros_like(tsd)
    observers = torch.zeros_like(tsd) if return_observers else None
    maps = torch.stack([silhouettes, depths, qualities], dim=-1)
    for i in range(N):
        vals = bilinear_2d(maps[i], pos_calib[i, ..., :2])
        tsd, total_w = fuse_sensor(
            tsd, total_w, pos_calib[i, ..., 2], vals[..., 1], vals[..., 2],
            vals[..., 0], in_frustum[i], limit, carve_sil_threshold,
        )
        if return_observers:
            sdist = pos_calib[i, ..., 2] - vals[..., 1]
            observers += (in_frustum[i] & (sdist > -limit) & (sdist < limit)
                          & (vals[..., 2] > 0.0)).to(torch.float32)
        del vals
    if not phantom_hull:
        tsd = torch.where((total_w <= 0.0) & (tsd >= limit), -limit, tsd)
    if voxel_mask is not None:
        tsd = torch.where(voxel_mask, tsd, -limit)
    if return_observers:
        return tsd, observers
    return tsd


def bake_projections_bricks(cv_xyz_inv: torch.Tensor,
                            vol_shape: Tuple[int, int, int],
                            brick_vox: int) -> torch.Tensor:
    """(N, B, V, 4) brick-major per-voxel projections, rows
    (u, v, depth_norm, +1 valid / -1 invalid). A voxel is valid when the
    interpolated validity channel is > 0.99 (all 8 source texels valid) and
    it lies inside the true volume. One-time setup cost."""
    (Bz, By, Bx), padded = brick_layout(vol_shape, brick_vox)
    v = brick_vox
    pos = voxel_centers(padded, true_shape=vol_shape,
                        device=cv_xyz_inv.device)
    inside = ((pos >= 0.0) & (pos <= 1.0)).all(dim=-1)
    out = []
    for inv in cv_xyz_inv:
        look = trilinear_3d(inv, pos)                    # (Zp, Yp, Xp, 4)
        valid = (look[..., 3] > 0.99) & inside
        look[..., 3] = torch.where(valid, 1.0, -1.0)
        bm = look.reshape(Bz, v, By, v, Bx, v, 4).permute(0, 2, 4, 1, 3, 5, 6)
        out.append(bm.reshape(Bz * By * Bx, v * v * v, 4))
        del look
    return torch.stack(out)


def occupied_brick_ids(counts: torch.Tensor, min_voxels: int,
                       capacity: int) -> torch.Tensor:
    """The first ``capacity`` occupied brick ids in ascending order, padded
    with ``num_bricks`` (out of range: dropped by the scatter). Bricks beyond
    capacity are dropped, as in the reference's fixed-size compaction."""
    occ = (counts > min_voxels).reshape(-1)
    B = occ.shape[0]
    ids = torch.nonzero(occ).reshape(-1)[:capacity].to(torch.int64)
    pad = torch.full((capacity - ids.shape[0],), B, dtype=torch.int64,
                     device=counts.device)
    return torch.cat([ids, pad])


def fuse_sensor(tsd, total_w, pos_z, depth, qual, sil, in_frustum, limit,
                carve_sil_threshold):
    """One sensor's update of the running (tsd, total_w) fold
    (tsdf_integration.vs:30-55)."""
    carve = (sil < carve_sil_threshold) & (tsd >= limit) & in_frustum
    sdist = pos_z - depth
    behind = (sdist <= -limit) & in_frustum
    skip = (sdist >= limit) | ~in_frustum
    new_w = total_w + qual
    updated = torch.where(
        new_w > 0.0,
        (tsd * total_w + qual * sdist) / torch.clamp_min(new_w, 1e-20),
        tsd,
    )
    tsd_next = torch.where(behind, -limit, torch.where(skip, tsd, updated))
    w_next = torch.where(behind | skip, total_w, new_w)
    tsd = torch.where(carve, -limit, tsd_next)
    total_w = torch.where(carve, total_w, w_next)
    return tsd, total_w


def integrate_bricks(proj_bricks: torch.Tensor, ids: torch.Tensor,
                     depths: torch.Tensor, qualities: torch.Tensor,
                     silhouettes: torch.Tensor, limit: float,
                     vol_shape: Tuple[int, int, int], brick_vox: int,
                     carve_sil_threshold: float = 1.0,
                     phantom_hull: bool = False,
                     taps: str = "nearest") -> torch.Tensor:
    """Occupied-bricks-only integration; returns the dense (Z, Y, X)
    volume. ``taps="nearest"`` fetches the maps at the nearest texel, with
    quality and silhouette rounded to bf16 as the reference's fast path
    stores them (tsdf.py:337-354) and depth in f32; ``taps="bilinear"``
    interpolates the f32 maps with the four-corner rule of
    sampling.quad_bilinear (tsdf.py:363-407)."""
    N, B, V, _ = proj_bricks.shape
    H, W = depths.shape[1:3]
    ids_c = torch.clamp_max(ids, B - 1)
    proj = proj_bricks[:, ids_c]                         # (N, K, V, 4)
    in_frustum = proj[..., 3] > 0.0
    if taps != "nearest":
        maps = torch.stack([depths, qualities, silhouettes], dim=-1)
        vals = torch.stack([quad_bilinear(maps[i], proj[i, ..., 0],
                                          proj[i, ..., 1])
                            for i in range(N)])          # (N, K, V, 3)
        return fold_and_scatter(
            proj[..., 2], vals[..., 0], vals[..., 1], vals[..., 2],
            in_frustum, ids, limit, vol_shape, brick_vox,
            carve_sil_threshold, phantom_hull,
        )
    qs = torch.stack([qualities, silhouettes], dim=-1).to(torch.bfloat16)
    qs = qs.to(torch.float32).reshape(N, H * W, 2)
    dflat = depths.reshape(N, H * W)
    xi = torch.clamp((proj[..., 0] * W).to(torch.int32), 0, W - 1)
    yi = torch.clamp((proj[..., 1] * H).to(torch.int32), 0, H - 1)
    idx = (yi * W + xi).to(torch.int64)
    depth = torch.stack([dflat[i][idx[i]] for i in range(N)])
    qs_t = torch.stack([qs[i][idx[i]] for i in range(N)])  # (N, K, V, 2)
    return fold_and_scatter(
        proj[..., 2], depth, qs_t[..., 0], qs_t[..., 1], in_frustum, ids,
        limit, vol_shape, brick_vox, carve_sil_threshold, phantom_hull,
    )


def fold_and_scatter(proj_z, depth, qual, sil, in_frustum, ids, limit,
                     vol_shape, brick_vox, carve_sil_threshold,
                     phantom_hull):
    """Sensor fold over the sampled (N, K, V) map values, then the block
    scatter of the K bricks back into the dense volume."""
    N, K, V = depth.shape
    (Bz, By, Bx), padded = brick_layout(vol_shape, brick_vox)
    v = brick_vox
    num_bricks = Bz * By * Bx
    tsd = torch.full((K, V), limit, dtype=torch.float32, device=depth.device)
    total_w = torch.zeros_like(tsd)
    for i in range(N):
        tsd, total_w = fuse_sensor(
            tsd, total_w, proj_z[i], depth[i], qual[i], sil[i],
            in_frustum[i], limit, carve_sil_threshold,
        )
    if not phantom_hull:
        # unobserved voxels still at the +limit init become unknown (-limit)
        tsd = torch.where((total_w <= 0.0) & (tsd >= limit), -limit, tsd)
    vol_bm = torch.full((num_bricks, V), -limit, dtype=torch.float32,
                        device=depth.device)
    keep = ids < num_bricks
    vol_bm[ids[keep]] = tsd[keep]
    dense = vol_bm.reshape(Bz, By, Bx, v, v, v).permute(0, 3, 1, 4, 2, 5)
    Z, Y, X = vol_shape
    return dense.reshape(padded)[:Z, :Y, :X].contiguous()


def integrate_compact_plain(proj_bricks: torch.Tensor, counts: torch.Tensor,
                            min_voxels: int, capacity: int,
                            depths: torch.Tensor, qualities: torch.Tensor,
                            silhouettes: torch.Tensor, limit: float,
                            vol_shape: Tuple[int, int, int], brick_vox: int,
                            carve_sil_threshold: float = 1.0,
                            phantom_hull: bool = False,
                            taps: str = "nearest") -> torch.Tensor:
    """The dense (Z, Y, X) volume of the first ``capacity`` bricks whose
    count is > ``min_voxels``: :func:`occupied_brick_ids` then
    :func:`integrate_bricks`."""
    ids = occupied_brick_ids(counts, min_voxels, capacity)
    return integrate_bricks(
        proj_bricks, ids, depths, qualities, silhouettes, limit, vol_shape,
        brick_vox, carve_sil_threshold=carve_sil_threshold,
        phantom_hull=phantom_hull, taps=taps)


def integrate_compact(proj_bricks: torch.Tensor, counts: torch.Tensor,
                      min_voxels: int, capacity: int, depths: torch.Tensor,
                      qualities: torch.Tensor, silhouettes: torch.Tensor,
                      limit: float, vol_shape: Tuple[int, int, int],
                      brick_vox: int, carve_sil_threshold: float = 1.0,
                      phantom_hull: bool = False,
                      taps: str = "nearest") -> torch.Tensor:
    """:func:`integrate_compact_plain`. On CUDA tensors: the flags
    counts > min_voxels, one compaction (its list is occupied_brick_ids'
    but padded with B; its slot map is -1 exactly for the bricks
    occupied_brick_ids drops: unset, or past the capacity) and one
    brick_integrate launch, no host sync; on CPU tensors the plain
    version. Same arguments and result."""
    if depths.device.type == "cpu":
        return integrate_compact_plain(
            proj_bricks, counts, min_voxels, capacity, depths, qualities,
            silhouettes, limit, vol_shape, brick_vox, carve_sil_threshold,
            phantom_hull, taps)
    from ..kernels.fuse import brick_integrate_cuda

    flags = (counts > min_voxels).reshape(-1).view(torch.uint8)
    listed = torch.empty(1, dtype=torch.int32, device=counts.device)
    ids, slot = compact_ops.compact(flags, 0, capacity, listed, 0,
                                    want_slot=True)
    return brick_integrate_cuda(
        proj_bricks, ids, slot, depths, qualities, silhouettes, limit,
        vol_shape, brick_vox, carve_sil_threshold=carve_sil_threshold,
        phantom_hull=phantom_hull, taps=taps)
