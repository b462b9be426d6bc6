"""Sensor frustum apex from calibration-volume corner samples (numpy).

The part of rgbd_recon_tpu/calib/frustum.py that the synthetic calibration
needs (framework/calibration/frustum.cpp:21-33): the camera position is the
average of the pairwise closest points between the four frustum edge rays
and the central view ray. Copied because that package's __init__ imports
jax and flax.

Corner ordering (getCornerPoints, calibration_inverter.cpp:157-172):
  0: (0, 0, 0)    1: (0, ymax, 0)    2: (xmax, ymax, 0)    3: (xmax, 0, 0)
  4: (0, 0, zmax) 5: (0, ymax, zmax) 6: (xmax, ymax, zmax) 7: (xmax, 0, zmax)
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _closest_point(p, u, q, v):
    # frustum.cpp:97-111 — midpoint of the shortest segment between two lines
    w0 = p - q
    a = np.dot(u, u)
    b = np.dot(u, v)
    c = np.dot(v, v)
    d = np.dot(u, w0)
    e = np.dot(v, w0)
    denom = a * c - b * b
    sc = (b * e - c * d) / denom
    tc = (a * e - b * d) / denom
    return (p + u * sc + q + v * tc) * 0.5


@dataclasses.dataclass(frozen=True)
class Frustum:
    corners: np.ndarray  # (8, 3) float32

    def camera_position(self) -> np.ndarray:
        """Frustum apex = camera center (frustum.cpp:21-33)."""
        c = self.corners
        center_near = c[:4].mean(axis=0)
        center_far = c[4:].mean(axis=0)
        view_dir = center_far - center_near
        pts = [
            _closest_point(c[i], c[i] - c[i + 4], center_near, view_dir)
            for i in range(4)
        ]
        return np.stack(pts).mean(axis=0).astype(np.float32)


def frustum_from_cv_xyz(cv_xyz: np.ndarray) -> Frustum:
    """Frustum from a (D, H, W, 3) cv_xyz volume's 8 extreme texels."""
    corners = np.stack(
        [
            cv_xyz[0, 0, 0], cv_xyz[0, -1, 0], cv_xyz[0, -1, -1], cv_xyz[0, 0, -1],
            cv_xyz[-1, 0, 0], cv_xyz[-1, -1, 0], cv_xyz[-1, -1, -1], cv_xyz[-1, 0, -1],
        ]
    ).astype(np.float32)
    return Frustum(corners=corners)
