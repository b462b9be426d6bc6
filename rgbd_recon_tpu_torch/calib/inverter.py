"""Calibration-volume inversion: world grid -> sensor-space lookup volume.

The k-NN inverter of rgbd_recon_tpu/calib/inverter.py in numpy (that
package's __init__ imports jax and flax), the reference's offline
``calib_inverter`` (calibration_inverter.cpp): for each voxel center of the
target world grid (half-voxel offset, :105-108)

  - outside the sensor frustum -> (-1, -1, -1, -1)             (:127-129)
  - else the k=8 nearest cv_xyz samples (kd-tree, :134) -> inverse-
    distance-weighted average of their integer texel indices (:55-69)
    -> +0.5, normalized by the cv_xyz resolution (:141)
    -> (u, v, depth_norm, 1.0)

The k-NN runs on the host with scipy's cKDTree, the role CGAL plays in the
reference (an offline precompute).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rgbd_recon_tpu.core.grid import BoundingBox

from .frustum import frustum_from_cv_xyz


def _target_voxel_centers(bbox: BoundingBox,
                          res: Tuple[int, int, int]) -> np.ndarray:
    rx, ry, rz = res
    xs = (np.arange(rx, dtype=np.float32) + 0.5) / rx
    ys = (np.arange(ry, dtype=np.float32) + 0.5) / ry
    zs = (np.arange(rz, dtype=np.float32) + 0.5) / rz
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    return bbox.denormalize(np.stack([xx, yy, zz], axis=-1))


def invert_calibration_knn(cv_xyz: np.ndarray, bbox: BoundingBox,
                           res: Tuple[int, int, int], k: int = 8
                           ) -> np.ndarray:
    """Numerically invert a (D, H, W, 3) cv_xyz volume over the world grid
    of ``bbox`` at resolution ``res`` (X, Y, Z) with ``k`` neighbors.
    Returns a (Z, Y, X, 4) float32 volume of (u, v, depth_norm, valid)."""
    from scipy.spatial import cKDTree

    D, H, W, _ = cv_xyz.shape
    samples = cv_xyz.reshape(-1, 3).astype(np.float64)
    # integer texel indices (u=x, v=y, d=z) in getXyzSamples order
    dz, vy, ux = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    indices = np.stack([ux, vy, dz], axis=-1).reshape(-1, 3).astype(
        np.float64)

    tree = cKDTree(samples)
    targets = _target_voxel_centers(bbox, res).reshape(-1, 3).astype(
        np.float64)
    inside = frustum_from_cv_xyz(cv_xyz).inside(targets)

    out = np.full((targets.shape[0], 4), -1.0, np.float32)
    q = targets[inside]
    if q.shape[0] > 0:
        dist, nn = tree.query(q, k=k, workers=-1)
        w = 1.0 / np.maximum(dist, 1e-12)
        widx = (np.einsum("nk,nkc->nc", w, indices[nn])
                / w.sum(axis=1, keepdims=True))
        dims = np.array([W, H, D], np.float64)
        out[inside, :3] = ((widx + 0.5) / dims).astype(np.float32)
        out[inside, 3] = 1.0
    rx, ry, rz = res
    return out.reshape(rz, ry, rx, 4)
