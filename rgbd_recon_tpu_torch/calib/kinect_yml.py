"""Kinect calibration file parsing (.yml + sidecars).

A copy of rgbd_recon_tpu/calib/kinect_yml.py: that package's __init__
imports jax and flax, which the port does not depend on.

Parity reimplementation of KinectCalibrationFile::parse
(framework/calibration/KinectCalibrationFile.cpp:148-580): the RGBDemo-style
OpenCV-YAML files carry rgb/depth intrinsics + distortion, the depth->rgb
relative transform R/T, image sizes, near/far and compression flags; sidecar
files supply the world pose (`.ext`/`.ext2`/`.ext3`, :362-520), clip boxes
(`.bbx`, :523-575), a local transform (`.local`, :773-791) and the sensor
serial (`.serial`).

The reference parser is token-stream based and tolerant of OpenCV YAML
syntax ('[', ',', ']' glued to numbers); this one replicates that tolerance
by stripping non-numeric characters per token.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from rgbd_recon_tpu.core.camera import PinholeCamera, RGBDSensor

_NUM_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def _floats_after(tokens, key, count):
    """Scan the token stream for `key`, then pull the next `count` numeric
    values (skipping brackets/commas), like advanceToNextToken +
    getNextTokenAsFloat (:98-146)."""
    try:
        i = tokens.index(key)
    except ValueError:
        return None
    # OpenCV matrices may carry a `rows:/cols:/dt:` header before `data:`
    # whose integers must not be read as matrix entries; skip to `data:`
    # when present (the reference token scanner does the same by seeking
    # the value stream, KinectCalibrationFile.cpp:98-146).
    rest = tokens[i + 1:]
    for j, tok in enumerate(rest[:8]):
        if tok == "data:":
            rest = rest[j + 1:]
            break
    vals = []
    for tok in rest:
        for m in _NUM_RE.finditer(tok):
            vals.append(float(m.group()))
            if len(vals) == count:
                return vals
    return vals if len(vals) == count else None


@dataclasses.dataclass
class KinectCalibration:
    """Parsed per-sensor calibration (KinectCalibrationFile fields)."""

    intrinsics_rgb: np.ndarray = None      # (3,3)
    intrinsics_depth: np.ndarray = None    # (3,3)
    distortion_rgb: np.ndarray = None      # (5,)
    distortion_depth: np.ndarray = None    # (5,)
    relative_rotation: np.ndarray = None   # (3,3) depth->rgb
    relative_translation: np.ndarray = None  # (3,)
    rgb_size: Tuple[int, int] = (1280, 1080)
    depth_size: Tuple[int, int] = (512, 424)
    near: float = 0.5
    far: float = 4.5
    compressed_rgb: int = 0
    compressed_depth: bool = False
    # secondary/tertiary world poses (.ext2/.ext3 sidecars — parsed by the
    # reference for alternative tracking frames, KinectCalibrationFile.cpp
    # :416-520; identity/zero when absent like the reference's defaults)
    world_translation2: np.ndarray = None
    world_rotation2: np.ndarray = None
    world_translation3: np.ndarray = None
    world_rotation3: np.ndarray = None
    # .local sidecar: local transform as translation xyz + Euler rotation
    # rx ry rz in degrees (loadLocalTransform, :779-795)
    local_translation: np.ndarray = None
    local_rotation_deg: np.ndarray = None
    min_length: float = 0.0125             # :96
    world_rotation: np.ndarray = None      # (3,3) from .ext
    world_translation: np.ndarray = None   # (3,)
    serial: str = ""
    pos_min: Optional[np.ndarray] = None   # .bbx clip box
    pos_max: Optional[np.ndarray] = None
    neg_min: Optional[np.ndarray] = None
    neg_max: Optional[np.ndarray] = None

    def to_rgbd_sensor(self) -> RGBDSensor:
        """Analytic sensor model for volume baking. The depth camera's
        camera-to-world pose comes from the .ext world transform; the color
        camera hangs off it by the relative R/T."""
        fx_d, fy_d = self.intrinsics_depth[0, 0], self.intrinsics_depth[1, 1]
        cx_d, cy_d = self.intrinsics_depth[0, 2], self.intrinsics_depth[1, 2]
        fx_c, fy_c = self.intrinsics_rgb[0, 0], self.intrinsics_rgb[1, 1]
        cx_c, cy_c = self.intrinsics_rgb[0, 2], self.intrinsics_rgb[1, 2]
        dw, dh = self.depth_size
        cw, ch = self.rgb_size
        r_w = self.world_rotation if self.world_rotation is not None else np.eye(3)
        t_w = (
            self.world_translation
            if self.world_translation is not None
            else np.zeros(3)
        )
        depth_cam = PinholeCamera(
            width=int(dw), height=int(dh), fx=fx_d, fy=fy_d, cx=cx_d, cy=cy_d,
            r_cw=tuple(map(tuple, np.asarray(r_w, np.float64).tolist())),
            t_cw=tuple(np.asarray(t_w, np.float64).tolist()),
            near=self.near, far=self.far,
            distortion=tuple(
                (self.distortion_depth if self.distortion_depth is not None
                 else np.zeros(5)).tolist()
            ),
        )
        # color cam pose: x_rgb = R_rel x_depth + T_rel  (cam coords) =>
        # cam-to-world of rgb = (R_w R_rel^T, t_w - R_w R_rel^T T_rel)
        r_rel = (
            self.relative_rotation if self.relative_rotation is not None
            else np.eye(3)
        )
        t_rel = (
            self.relative_translation if self.relative_translation is not None
            else np.zeros(3)
        )
        r_c = np.asarray(r_w) @ np.asarray(r_rel).T
        t_c = np.asarray(t_w) - r_c @ np.asarray(t_rel)
        color_cam = PinholeCamera(
            width=int(cw), height=int(ch), fx=fx_c, fy=fy_c, cx=cx_c, cy=cy_c,
            r_cw=tuple(map(tuple, r_c.tolist())),
            t_cw=tuple(t_c.tolist()),
            near=self.near, far=self.far,
            distortion=tuple(
                (self.distortion_rgb if self.distortion_rgb is not None
                 else np.zeros(5)).tolist()
            ),
        )
        return RGBDSensor(depth=depth_cam, color=color_cam, serial=self.serial)


def parse_kinect_yml(path) -> KinectCalibration:
    """Parse a .yml file + whatever sidecars exist next to it."""
    path = Path(path)
    tokens = path.read_text().split()
    cal = KinectCalibration()

    v = _floats_after(tokens, "rgb_intrinsics:", 9)
    if v:
        cal.intrinsics_rgb = np.asarray(v, np.float64).reshape(3, 3)
    v = _floats_after(tokens, "depth_intrinsics:", 9)
    if v:
        cal.intrinsics_depth = np.asarray(v, np.float64).reshape(3, 3)
    v = _floats_after(tokens, "rgb_distortion:", 5)
    if v:
        cal.distortion_rgb = np.asarray(v, np.float64)
    v = _floats_after(tokens, "depth_distortion:", 5)
    if v:
        cal.distortion_depth = np.asarray(v, np.float64)
    v = _floats_after(tokens, "R:", 9)
    if v:
        cal.relative_rotation = np.asarray(v, np.float64).reshape(3, 3)
    v = _floats_after(tokens, "T:", 3)
    if v:
        cal.relative_translation = np.asarray(v, np.float64)
    v = _floats_after(tokens, "rgb_size:", 2)
    if v:
        cal.rgb_size = (int(v[0]), int(v[1]))
    v = _floats_after(tokens, "depth_size:", 2)
    if v:
        cal.depth_size = (int(v[0]), int(v[1]))
    v = _floats_after(tokens, "near_far:", 2)
    if v:
        cal.near, cal.far = v
    v = _floats_after(tokens, "compress_rgb:", 1)
    if v:
        cal.compressed_rgb = int(v[0])
    v = _floats_after(tokens, "compress_depth:", 1)
    if v:
        cal.compressed_depth = bool(int(v[0]))
    v = _floats_after(tokens, "min_length:", 1)
    if v:
        cal.min_length = v[0]

    # sidecars (replace the 3-char extension, :362-365)
    ext = path.with_suffix(".ext")
    if ext.exists():
        vals = [float(m.group()) for m in _NUM_RE.finditer(ext.read_text())]
        if len(vals) >= 12:
            cal.world_translation = np.asarray(vals[:3], np.float64)
            cal.world_rotation = np.asarray(vals[3:12], np.float64).reshape(3, 3)
    for suffix, t_attr, r_attr in (
        (".ext2", "world_translation2", "world_rotation2"),
        (".ext3", "world_translation3", "world_rotation3"),
    ):
        side = path.with_suffix(suffix)
        if side.exists():
            vals = [float(m.group()) for m in _NUM_RE.finditer(side.read_text())]
            if len(vals) >= 12:
                setattr(cal, t_attr, np.asarray(vals[:3], np.float64))
                setattr(
                    cal, r_attr,
                    np.asarray(vals[3:12], np.float64).reshape(3, 3),
                )
    local = path.with_suffix(".local")
    if local.exists():
        vals = [float(m.group()) for m in _NUM_RE.finditer(local.read_text())]
        if len(vals) >= 6:
            cal.local_translation = np.asarray(vals[0:3], np.float64)
            cal.local_rotation_deg = np.asarray(vals[3:6], np.float64)
    serial = path.with_suffix(".serial")
    if serial.exists():
        cal.serial = serial.read_text().strip()
    bbx = path.with_suffix(".bbx")
    if bbx.exists():
        vals = [float(m.group()) for m in _NUM_RE.finditer(bbx.read_text())]
        if len(vals) >= 6:
            cal.pos_min = np.asarray(vals[0:3], np.float64)
            cal.pos_max = np.asarray(vals[3:6], np.float64)
        if len(vals) >= 12:
            cal.neg_min = np.asarray(vals[6:9], np.float64)
            cal.neg_max = np.asarray(vals[9:12], np.float64)
    return cal
