"""Baking analytic sensor models into calibration lookup volumes (numpy).

A copy of rgbd_recon_tpu/calib/bake.py: that package's __init__ imports
jax and flax, which the port does not depend on.

The reference consumes *pre-baked* volumes produced by an upstream tool
(rgbd-calib, via natural-neighbour interpolation of measured samples —
SURVEY.md §0). For a self-contained framework we bake equivalents from an
analytic pinhole model, yielding the exact same runtime artifact shapes:

  cv_xyz (D, H, W, 3):  (u, v, depth_norm) texel -> world position
    (reference format: CalibVolumes.cpp:132-137, res e.g. 128 x 256 x 128)
  cv_uv  (D, H, W, 2):  (u, v, depth_norm) texel -> color-camera texcoord
  cv_xyz_inv (Dz, Hy, Wx, 4): bbox-normalized world voxel ->
    (u, v, depth_norm, valid) (reference: calibration_inverter.cpp:99-155)

Texel-center convention everywhere: texel i of an N-texel axis represents
coordinate (i + 0.5) / N (reference: calibration_inverter.cpp:108 "important,
start with offset of a half voxel").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.camera import RGBDSensor
from ..core.grid import BoundingBox


def _texel_grid(res: Tuple[int, int, int]) -> np.ndarray:
    """(D, H, W, 3) of (u, v, d) texel-center coords; res given as (W, H, D)."""
    W, H, D = res
    us = (np.arange(W, dtype=np.float32) + 0.5) / W
    vs = (np.arange(H, dtype=np.float32) + 0.5) / H
    ds = (np.arange(D, dtype=np.float32) + 0.5) / D
    dd, vv, uu = np.meshgrid(ds, vs, us, indexing="ij")
    return np.stack([uu, vv, dd], axis=-1)


def bake_cv_xyz(sensor: RGBDSensor, res: Tuple[int, int, int] = (128, 256, 128)) -> np.ndarray:
    """Bake the (u, v, depth_norm) -> world-position volume for the depth
    camera. res is (W, H, D) like the reference's (res.x, res.y, res.z)."""
    g = _texel_grid(res)
    depth_m = sensor.depth.denormalize_depth(g[..., 2])
    world = sensor.depth.unproject(g[..., :2], depth_m)
    return world.astype(np.float32)


def bake_cv_uv(sensor: RGBDSensor, res: Tuple[int, int, int] = (128, 256, 128)) -> np.ndarray:
    """Bake the (u, v, depth_norm) -> color-camera texcoord volume."""
    g = _texel_grid(res)
    depth_m = sensor.depth.denormalize_depth(g[..., 2])
    world = sensor.depth.unproject(g[..., :2], depth_m)
    uv, _ = sensor.color.project(world)
    return uv.astype(np.float32)


def bake_cv_xyz_inv_analytic(
    sensor: RGBDSensor,
    bbox: BoundingBox,
    res: Tuple[int, int, int],
) -> np.ndarray:
    """Directly bake the world -> sensor volume from the analytic model.

    The reference computes this numerically (k-NN + IDW over cv_xyz samples,
    calibration_inverter.cpp:99-155 — see inverter.py for that parity path);
    with an analytic model the exact inverse is available. Output matches the
    reference artifact: (Dz, Hy, Wx, 4) over bbox voxel centers, channels
    (u, v, depth_norm, 1.0) inside the camera's view, all -1.0 outside
    (calibration_inverter.cpp:128, 141).

    res is (X, Y, Z) world-grid resolution.
    """
    rx, ry, rz = res
    xs = (np.arange(rx, dtype=np.float32) + 0.5) / rx
    ys = (np.arange(ry, dtype=np.float32) + 0.5) / ry
    zs = (np.arange(rz, dtype=np.float32) + 0.5) / rz
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    norm = np.stack([xx, yy, zz], axis=-1)
    world = bbox.denormalize(norm)

    uv, depth_m = sensor.depth.project(world)
    d_norm = sensor.depth.normalize_depth(depth_m)

    valid = (
        (uv[..., 0] > 0.0)
        & (uv[..., 0] < 1.0)
        & (uv[..., 1] > 0.0)
        & (uv[..., 1] < 1.0)
        & (d_norm > 0.0)
        & (d_norm < 1.0)
    )
    out = np.full(world.shape[:-1] + (4,), -1.0, np.float32)
    out[..., 0] = np.where(valid, uv[..., 0], -1.0)
    out[..., 1] = np.where(valid, uv[..., 1], -1.0)
    out[..., 2] = np.where(valid, d_norm, -1.0)
    out[..., 3] = np.where(valid, 1.0, -1.0)
    return out
