"""Sensor view frustums from calibration-volume corner samples (numpy).

A copy of rgbd_recon_tpu/calib/frustum.py (that package's __init__ imports
jax and flax): 8 corner texels of cv_xyz define 6 half-space planes
(frustum.cpp:113-177); the camera position is the average of the pairwise
closest points between the four frustum edge rays and the central view
ray (frustum.cpp:21-33).

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


def _edge_centers(c):
    # frustum.cpp:130-147
    pairs = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    return np.stack([(c[i] + c[j]) * 0.5 for i, j in pairs])


def _side_centers(c):
    # frustum.cpp:113-128: near, far, left, right, top, bottom
    quads = [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 4, 5),
        (2, 3, 6, 7), (1, 2, 5, 6), (0, 3, 4, 7),
    ]
    return np.stack([(c[a] + c[b] + c[d] + c[e]) * 0.25
                     for a, b, d, e in quads])


def _side_normals(c):
    # frustum.cpp:149-166
    e = _edge_centers(c)
    n = np.stack([
        np.cross(e[0] - e[2], e[3] - e[2]),       # near
        np.cross(e[4] - e[6], e[5] - e[7]),       # far
        np.cross(e[0] - e[4], e[9] - e[8]),       # left
        np.cross(e[2] - e[6], e[11] - e[10]),     # right
        np.cross(e[9] - e[10], e[1] - e[5]),      # top
        np.cross(e[8] - e[11], e[7] - e[3]),      # bottom
    ])
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class Frustum:
    corners: np.ndarray  # (8, 3) float32

    @property
    def planes(self) -> np.ndarray:
        """(6, 4) plane equations [n, -n.center] (frustum.cpp:167-177)."""
        centers = _side_centers(self.corners)
        normals = _side_normals(self.corners)
        d = -np.sum(normals * centers, axis=-1, keepdims=True)
        return np.concatenate([normals, d], axis=-1).astype(np.float32)

    def inside(self, points: np.ndarray) -> np.ndarray:
        """Vectorized half-space containment test (frustum.cpp:36-43)."""
        p = np.asarray(points, np.float32)
        homo = np.concatenate([p, np.ones(p.shape[:-1] + (1,), p.dtype)],
                              axis=-1)
        return np.all(homo @ self.planes.T >= 0.0, axis=-1)

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
