"""Camera and sensor-rig structures.

The reference never uses analytic pinhole math at runtime — all projections
go through baked calibration volumes (SURVEY.md §0). We keep the same runtime
design, but we *do* need analytic cameras to (a) synthesize test scenes and
calibrations, and (b) seed pose refinement. The reference's analytic model
lives in its .yml calibration files (framework/calibration/
KinectCalibrationFile.cpp:148-580: intrinsics fx/fy/cx/cy, distortion,
relative R/T depth->color, world pose from .ext).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole intrinsics + world pose + Brown-Conrady distortion.

    Distortion coefficients (k1, k2, p1, p2, k3) follow the OpenCV layout of
    the reference's .yml files (rgb_distortion/depth_distortion,
    KinectCalibrationFile.cpp:196-230) and are APPLIED in project/unproject
    — since all runtime projections go through baked calibration volumes,
    this is exactly where distortion must enter: at bake time
    (calib/bake.py), like the upstream rgbd-calib baking pipeline."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    # camera-to-world rotation (3,3) and translation (3,)
    r_cw: Tuple[Tuple[float, ...], ...] = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    t_cw: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    near: float = 0.5
    far: float = 4.5
    distortion: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )

    @property
    def R(self) -> np.ndarray:
        return np.asarray(self.r_cw, np.float32)

    @property
    def t(self) -> np.ndarray:
        return np.asarray(self.t_cw, np.float32)

    @property
    def position(self) -> np.ndarray:
        """Camera center in world space."""
        return self.t

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.distortion)

    def _distort(self, x: np.ndarray, y: np.ndarray):
        """Normalized image coords -> distorted (Brown-Conrady, the OpenCV
        model of the reference's calibration files)."""
        k1, k2, p1, p2, k3 = (list(self.distortion) + [0.0] * 5)[:5]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return xd, yd

    def _undistort(self, xd: np.ndarray, yd: np.ndarray, iters: int = 5):
        """Inverse of :meth:`_distort` by fixed-point iteration (the usual
        OpenCV undistortPoints scheme; converges in a few steps for
        realistic coefficients)."""
        x, y = xd.copy(), yd.copy()
        k1, k2, p1, p2, k3 = (list(self.distortion) + [0.0] * 5)[:5]
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return x, y

    def unproject(self, uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Normalized texture coords (...,2) in [0,1] + metric depth (...) ->
        world positions (...,3). Texel centers: pixel (i,j) maps to
        ((i+0.5)/W, (j+0.5)/H). Pixel coords are DISTORTED image positions;
        the ray direction comes from the undistorted normalized coords."""
        uv = np.asarray(uv, np.float32)
        depth = np.asarray(depth, np.float32)
        px = uv[..., 0] * self.width - 0.5
        py = uv[..., 1] * self.height - 0.5
        xn = (px - self.cx) / self.fx
        yn = (py - self.cy) / self.fy
        if self.has_distortion:
            xn, yn = self._undistort(xn, yn)
        cam = np.stack([xn * depth, yn * depth, depth], axis=-1)
        return cam @ self.R.T + self.t

    def project(self, world: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """World positions (...,3) -> (normalized uv (...,2), metric depth).
        Inverse of :meth:`unproject`."""
        world = np.asarray(world, np.float32)
        cam = (world - self.t) @ self.R
        z = cam[..., 2]
        safe_z = np.where(np.abs(z) < 1e-9, 1e-9, z)
        xn = cam[..., 0] / safe_z
        yn = cam[..., 1] / safe_z
        if self.has_distortion:
            xn, yn = self._distort(xn, yn)
        px = xn * self.fx + self.cx
        py = yn * self.fy + self.cy
        u = (px + 0.5) / self.width
        v = (py + 0.5) / self.height
        return np.stack([u, v], axis=-1), z

    def normalize_depth(self, depth: np.ndarray) -> np.ndarray:
        """Metric depth -> [0,1] normalized by the sensor's depth limits
        (reference: pre_depth.fs normalize_depth, cv depth_limits)."""
        return (np.asarray(depth, np.float32) - self.near) / (self.far - self.near)

    def denormalize_depth(self, d: np.ndarray) -> np.ndarray:
        return np.asarray(d, np.float32) * (self.far - self.near) + self.near


@dataclasses.dataclass(frozen=True)
class RGBDSensor:
    """One RGBD sensor = a depth camera + a color camera with a rigid offset
    (reference: KinectCalibrationFile holds both rgb and depth intrinsics
    plus relative R/T)."""

    depth: PinholeCamera
    color: PinholeCamera
    serial: str = ""


@dataclasses.dataclass(frozen=True)
class SensorRig:
    """A calibrated set of N RGBD sensors observing a common working volume
    (the reference's .ks scene: N kinect .yml files + bbox)."""

    sensors: Tuple[RGBDSensor, ...]

    @property
    def num_sensors(self) -> int:
        return len(self.sensors)


def look_at_rotation(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world rotation for a camera at `eye` looking at `target`,
    camera convention +z forward, +x right, +y down (image coordinates)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float32)
    right = np.cross(fwd, upv)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # columns are camera axes expressed in world space
    return np.stack([right, down, fwd], axis=1)
