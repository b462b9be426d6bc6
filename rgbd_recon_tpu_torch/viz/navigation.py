"""Camera navigation — the arcball orbit/pan/zoom controller (the port's
copy of rgbd_recon_tpu/viz/navigation.py, on the port's ViewCamera).

Replicates framework/navigation/CameraNavigator.{h,cpp} (mouse orbit around
a poi at arcball radius, xy pan, wheel zoom, reset; CameraNavigator.cpp:29-58)
as a small functional controller producing ViewCamera instances. The
reference couples this to GLFW mouse callbacks (kinect_client.cpp mouse
handlers); here the inputs are explicit method calls so it works headless,
in notebooks, or driven by a live viewer loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.raymarch import ViewCamera


@dataclasses.dataclass
class OrbitNavigator:
    """Spherical-orbit camera rig: position = poi + R(azimuth, elevation)
    applied to a distance-scaled offset (the arcball parameterization)."""

    poi: tuple = (0.0, 1.1, 0.0)     # point of interest (scene center)
    distance: float = 2.8            # arcball radius (m_zoom * radius)
    azimuth: float = 0.0             # radians around +y
    elevation: float = 0.15          # radians above the horizon
    width: int = 1280
    height: int = 720
    fov_y: float = 50.0
    min_distance: float = 0.2
    max_elevation: float = 1.45      # keep away from the poles

    _initial: tuple = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self._initial is None:
            self._initial = (self.poi, self.distance, self.azimuth, self.elevation)

    # -- input handling (CameraNavigator.cpp:29-58 equivalents) -------------

    def orbit(self, d_azimuth: float, d_elevation: float) -> "OrbitNavigator":
        """Mouse-drag rotate (left button motion)."""
        self.azimuth = (self.azimuth + d_azimuth) % (2.0 * np.pi)
        self.elevation = float(
            np.clip(self.elevation + d_elevation, -self.max_elevation, self.max_elevation)
        )
        return self

    def pan(self, dx: float, dy: float) -> "OrbitNavigator":
        """Middle-drag pan: move the poi in the camera's right/up plane."""
        rot = self.camera().rotation()
        off = rot[:, 0] * dx + rot[:, 1] * dy
        self.poi = tuple((np.asarray(self.poi, np.float32) + off).tolist())
        return self

    def zoom(self, factor: float) -> "OrbitNavigator":
        """Wheel zoom: scale the arcball radius."""
        self.distance = max(self.min_distance, self.distance * factor)
        return self

    def reset(self) -> "OrbitNavigator":
        """Reset to construction state (the reference's 'r' key behavior)."""
        self.poi, self.distance, self.azimuth, self.elevation = self._initial
        return self

    # -- output --------------------------------------------------------------

    def eye(self) -> np.ndarray:
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        offset = np.array([sa * ce, se, ca * ce], np.float32) * self.distance
        return np.asarray(self.poi, np.float32) + offset

    def camera(self) -> ViewCamera:
        return ViewCamera(
            width=self.width,
            height=self.height,
            fov_y=self.fov_y,
            eye=tuple(self.eye().tolist()),
            target=tuple(np.asarray(self.poi, np.float32).tolist()),
        )
