"""Binary calibration-volume file IO.

A copy of rgbd_recon_tpu/calib/volume_io.py: that package's __init__
imports jax and flax, which the port does not depend on.

File format (reference: framework/calibration/calibration_volume.hpp:30-79):
  header: uint32 res.x, uint32 res.y, uint32 res.z,
          float32 depth_limits.x (near), float32 depth_limits.y (far)
  payload: float32[res.z][res.y][res.x][C] — flat index
           z * res.x*res.y + y * res.x + x (calibration_volume.hpp:57-59),
           i.e. z-major, x fastest — exactly our (D, H, W, C) numpy layout.

Channel counts by extension convention (CalibVolumes.cpp:132-144):
  .cv_xyz     -> C=3 (world position per (u, v, depth_norm) texel)
  .cv_uv      -> C=2 (color texture coordinate)
  .cv_xyz_inv -> C=4 ((u, v, depth_norm, valid) per world voxel)
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_HEADER = struct.Struct("<IIIff")


def read_calibration_volume(
    path: Union[str, Path], channels: int = None
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Read a binary calibration volume.

    Returns (volume (D, H, W, C) float32, (near, far) depth limits).
    If ``channels`` is None it is inferred from the file size.
    """
    raw = Path(path).read_bytes()
    rx, ry, rz, dnear, dfar = _HEADER.unpack_from(raw, 0)
    payload = np.frombuffer(raw, dtype="<f4", offset=_HEADER.size)
    n_vox = rx * ry * rz
    if channels is None:
        if n_vox == 0 or payload.size % n_vox != 0:
            raise ValueError(f"corrupt calibration volume {path}")
        channels = payload.size // n_vox
    vol = payload.reshape(rz, ry, rx, channels).astype(np.float32)
    return vol, (dnear, dfar)


def write_calibration_volume(
    path: Union[str, Path], volume: np.ndarray, depth_limits: Tuple[float, float]
) -> None:
    """Write a binary calibration volume (inverse of read)."""
    vol = np.ascontiguousarray(volume, dtype="<f4")
    rz, ry, rx = vol.shape[:3]
    with open(path, "wb") as f:
        f.write(_HEADER.pack(rx, ry, rz, float(depth_limits[0]), float(depth_limits[1])))
        f.write(vol.tobytes())
