"""Synthetic RGBD scene renderer — the framework's reproducible test source.

A numpy copy of rgbd_recon_tpu/sensors/synthetic.py; frames come back as
torch tensors.

The reference's reproducibility mechanism is .stream file replay
(NetKinectArray.cpp:724-764); ours adds an analytic generator: scenes with a
known signed distance function (sphere / box / ground plane) are raycast from
each sensor's depth camera to produce exact depth maps and procedurally
colored views. Because the SDF is known analytically, reconstruction error
has a ground truth — this is what pins the TSDF kernels' math (SURVEY.md §7
step 2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

import torch

from ..core.camera import (
    PinholeCamera,
    RGBDSensor,
    SensorRig,
    look_at_rotation,
)
from ..core.grid import BoundingBox
from ..device import DEFAULT, resolve
from .frames import FrameSet


@dataclasses.dataclass
class SyntheticScene:
    """Analytic scene: union of spheres and an optional ground plane."""

    spheres: List[Tuple[Tuple[float, float, float], float]] = dataclasses.field(
        default_factory=lambda: [((0.0, 1.1, 0.0), 0.4)]
    )
    ground_y: float = None  # y of ground plane, None = no plane

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """Signed distance at world points (..., 3)."""
        p = np.asarray(p, np.float32)
        d = np.full(p.shape[:-1], np.inf, np.float32)
        for center, radius in self.spheres:
            c = np.asarray(center, np.float32)
            d = np.minimum(d, np.linalg.norm(p - c, axis=-1) - radius)
        if self.ground_y is not None:
            d = np.minimum(d, p[..., 1] - self.ground_y)
        return d

    def color(self, p: np.ndarray) -> np.ndarray:
        """Procedural surface color in [0,1]: smooth world-position ramp plus
        a checker component so color-consistency logic has gradients."""
        p = np.asarray(p, np.float32)
        base = 0.5 + 0.4 * np.sin(p * np.array([3.0, 5.0, 7.0], np.float32))
        checker = (
            np.floor(p[..., 0] * 8) + np.floor(p[..., 1] * 8) + np.floor(p[..., 2] * 8)
        ) % 2.0
        return np.clip(base * (0.7 + 0.3 * checker[..., None]), 0.0, 1.0)

    def raycast(
        self, origins: np.ndarray, dirs: np.ndarray, t_max: float = 6.0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sphere-trace the SDF. Returns (t, hit_mask); t = distance along
        (unit) dirs."""
        origins = np.asarray(origins, np.float32)
        dirs = np.asarray(dirs, np.float32)
        t = np.zeros(dirs.shape[:-1], np.float32)
        hit = np.zeros(dirs.shape[:-1], bool)
        for _ in range(128):
            p = origins + dirs * t[..., None]
            d = self.sdf(p)
            hit = hit | (d < 1e-4)
            step = np.where(hit, 0.0, np.maximum(d, 1e-4))
            t = np.minimum(t + step, t_max)
        return t, hit & (t < t_max)


def _render_camera(
    scene: SyntheticScene, cam: PinholeCamera
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (depth [H,W] meters, color [H,W,3]) from one pinhole camera.
    Depth is z-depth (distance along the camera z axis), like a real sensor."""
    H, W = cam.height, cam.width
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    uv = np.stack([uu, vv], axis=-1)
    # unit-depth ray directions in world space
    pts = cam.unproject(uv, np.ones((H, W), np.float32))
    dirs = pts - cam.position
    ray_len = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_n = dirs / ray_len

    t, hit = scene.raycast(np.broadcast_to(cam.position, dirs_n.shape), dirs_n)
    # convert ray distance to z-depth: t corresponds to |dirs|*z for z=1
    zdepth = t / ray_len[..., 0]
    surf = cam.position + dirs_n * t[..., None]
    color = scene.color(surf)
    bgcolor = np.full_like(color, 0.25)
    depth = np.where(hit, zdepth, 0.0).astype(np.float32)
    color = np.where(hit[..., None], color, bgcolor).astype(np.float32)
    return depth, color


def render_rig_frames(scene: SyntheticScene, rig: SensorRig,
                      timestamp: float = 0.0, device=DEFAULT) -> FrameSet:
    """Render one synchronized FrameSet for all sensors of a rig (depth from
    the depth camera, color from the color camera), rendered in numpy and
    returned as tensors on ``device`` (the card unless the caller names
    another)."""
    device = resolve(device)
    depths, colors = [], []
    for sensor in rig.sensors:
        d, _ = _render_camera(scene, sensor.depth)
        _, c = _render_camera(scene, sensor.color)
        depths.append(d)
        colors.append(c)
    return FrameSet(
        colors=torch.from_numpy(np.stack(colors)).to(device),
        depths=torch.from_numpy(np.stack(depths)).to(device),
        timestamp=torch.tensor(np.float32(timestamp), device=device),
    )


def default_test_rig(
    num_sensors: int = 4,
    depth_size: Tuple[int, int] = (64, 56),   # (W, H); reference 512 x 424
    color_size: Tuple[int, int] = (80, 64),   # reference 1280 x 1080
    bbox: BoundingBox = None,
    radius: float = 1.9,
    height: float = 1.3,
    focal_factor: float = 1.25,
) -> SensorRig:
    """N sensors on a circle around the bbox center, looking inward — the
    canonical multi-Kinect capture arrangement of the reference scenes."""
    if bbox is None:
        bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    target = bbox.center
    sensors = []
    for i in range(num_sensors):
        ang = 2.0 * np.pi * i / num_sensors + 0.3
        eye = np.array(
            [target[0] + radius * np.cos(ang), height, target[2] + radius * np.sin(ang)],
            np.float32,
        )
        r = look_at_rotation(eye, target)
        dw, dh = depth_size
        cw, ch = color_size
        # color camera sits a few cm to the side of the depth camera,
        # like the Kinect's rgb/ir baseline
        color_eye = eye + r @ np.array([0.05, 0.0, 0.0], np.float32)
        depth_cam = PinholeCamera(
            width=dw, height=dh,
            fx=dw * focal_factor, fy=dw * focal_factor,
            cx=dw / 2 - 0.5, cy=dh / 2 - 0.5,
            r_cw=tuple(map(tuple, r.tolist())), t_cw=tuple(eye.tolist()),
        )
        color_cam = PinholeCamera(
            width=cw, height=ch,
            fx=cw * focal_factor, fy=cw * focal_factor,
            cx=cw / 2 - 0.5, cy=ch / 2 - 0.5,
            r_cw=tuple(map(tuple, r.tolist())), t_cw=tuple(color_eye.tolist()),
        )
        sensors.append(RGBDSensor(depth=depth_cam, color=color_cam, serial=f"synth{i}"))
    return SensorRig(sensors=tuple(sensors))
