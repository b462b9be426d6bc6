"""Offline visualization: PNG dumps of renders and sensor maps (counterpart
of rgbd_recon_tpu/viz/render.py).

The reference shows every intermediate map in ImGui windows
(kinect_client.cpp:486-518) and the TSDF volume as colored voxel points
(recon_calibs.cpp). Headless equivalents: PNG dumps of sensor maps,
normal/depth colorizations, and TSDF slice images with calib_vis.fs's sign
colors. PNGs are written with the standard library (zlib), no imaging
package needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> 8-bit RGB PNG bytes (no filtering)."""
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(H, W * 3)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(path, array) -> None:
    """Save a float [0, 1] or uint8 image, (H, W, 3) or (H, W), as an RGB
    PNG; floats are clipped to [0, 1], scaled by 255 and truncated."""
    a = _np(array)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    Path(path).write_bytes(_encode_png(a))


def colorize_depth(depth, lo=None, hi=None) -> np.ndarray:
    """Normalized grayscale of a depth map; invalid (<= 0) shown red."""
    d = _np(depth).astype(np.float32)
    valid = d > 0
    if lo is None:
        lo = d[valid].min() if valid.any() else 0.0
    if hi is None:
        hi = d[valid].max() if valid.any() else 1.0
    g = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    img = np.stack([g, g, g], axis=-1)
    img[~valid] = [0.6, 0.1, 0.1]
    return img


def colorize_normals(normals) -> np.ndarray:
    """World normals -> RGB in [0, 1] (n * 0.5 + 0.5)."""
    return _np(normals) * 0.5 + 0.5


def sensor_map_gallery(maps, out_dir, sensor: int = 0) -> list:
    """Dump one sensor's map set (color, lab, processed depth, quality,
    normal, silhouette) as PNGs; returns the paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []

    def w(name, img):
        p = out / f"sensor{sensor}_{name}.png"
        save_image(p, img)
        written.append(p)

    w("color", _np(maps.color[sensor]))
    lab = _np(maps.lab[sensor])
    w("lab", (lab - lab.min()) / max(lab.max() - lab.min(), 1e-9))
    w("depth", colorize_depth(_np(maps.depth[sensor][..., 0])))
    q = _np(maps.quality[sensor])
    w("quality", q / max(q.max(), 1e-9))
    w("normal", colorize_normals(_np(maps.normal[sensor])))
    w("silhouette", _np(maps.silhouette[sensor]))
    return written


def tsdf_slice_image(volume, axis: int = 0, index: int = None,
                     limit: float = 0.01) -> np.ndarray:
    """Color a TSDF slice like calib_vis.fs: red where carved/inside
    (-limit), blue where empty (+limit), green in the surface band."""
    v = _np(volume)
    if index is None:
        index = v.shape[axis] // 2
    sl = np.take(v, index, axis=axis)
    img = np.zeros(sl.shape + (3,), np.float32)
    t = np.clip(sl / limit, -1.0, 1.0)
    img[..., 0] = np.clip(-t, 0, 1)
    img[..., 2] = np.clip(t, 0, 1)
    img[..., 1] = np.clip(1.0 - np.abs(t), 0, 1)
    return img
