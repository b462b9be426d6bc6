""".stream file replay — deterministic offline frame source.

Replicates the reference's recording replay (NetKinectArray::readFromFiles,
framework/NetKinectArray.cpp:724-764 + framework/io/FileBuffer.cpp): one
headerless file per sensor, each frame = [color bytes][depth bytes] with
sizes fixed by the calibration (m_colorsize = Wc*Hc*3 for raw RGB24,
m_depthsize = W*H*4 float32), read in a loop (FileBuffer read wraps at EOF,
FileBuffer.cpp:108-128).

The native C++ reader (io/native.py, native/framering.cpp) provides the same
interface off the GIL; this module is the pure-Python reference
implementation and the format definition.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrameCompression:
    """Per-sensor wire encodings, selected by the calibration's compression
    flags exactly like the reference (NetKinectArray.cpp:120-144 sizes the
    buffers from them; :511-542 decodes accordingly).

    rgb: 0 = raw RGB24, 1 = DXT1, 5 = DXT5 (the reference's flag values,
    KinectCalibrationFile isCompressedRGB).
    depth_u8: uint8 sqrt-compressed depth (glsl/pre_depth.fs:51-61 undoes
    it with scale = far - near); near/far parameterize the mapping.
    """

    rgb: int = 0
    depth_u8: bool = False
    near: float = 0.5
    far: float = 4.5

    @classmethod
    def from_calibration(cls, cal) -> "FrameCompression":
        """Build from a parsed calib.kinect_yml.KinectCalibration."""
        return cls(rgb=int(cal.compressed_rgb),
                   depth_u8=bool(cal.compressed_depth),
                   near=float(cal.near), far=float(cal.far))


RAW = FrameCompression()


def frame_wire_size(
    depth_size: Tuple[int, int],
    color_size: Tuple[int, int],
    compression: FrameCompression = None,
) -> Tuple[int, int]:
    """(color_bytes, depth_bytes) per frame per sensor for the given
    encodings (NetKinectArray.cpp:120-144)."""
    from . import dxt

    c = compression or RAW
    dw, dh = depth_size
    cw, ch = color_size
    if c.rgb == 1:
        color_bytes = dxt.dxt1_storage_size(cw, ch)
    elif c.rgb == 5:
        color_bytes = dxt.dxt5_storage_size(cw, ch)
    else:
        color_bytes = cw * ch * 3
    depth_bytes = dw * dh * (1 if c.depth_u8 else 4)
    return color_bytes, depth_bytes


def decode_color(buf, color_size: Tuple[int, int],
                 compression: FrameCompression = None) -> np.ndarray:
    """Wire bytes -> (H, W, 3) float32 [0,1] (the recv-side decode of
    NetKinectArray.cpp:511-542 / writeCurrentTexture:635)."""
    from . import dxt

    c = compression or RAW
    cw, ch = color_size
    if c.rgb == 1:
        rgb = dxt.decode_dxt1(bytes(buf), cw, ch)
    elif c.rgb == 5:
        rgb = dxt.decode_dxt5(bytes(buf), cw, ch)[..., :3]
    else:
        rgb = np.frombuffer(buf, np.uint8, cw * ch * 3).reshape(ch, cw, 3)
    return rgb.astype(np.float32) / 255.0


def decode_depth(buf, depth_size: Tuple[int, int],
                 compression: FrameCompression = None) -> np.ndarray:
    """Wire bytes -> (H, W) float32 metric depth."""
    from . import dxt

    c = compression or RAW
    dw, dh = depth_size
    if c.depth_u8:
        u8 = np.frombuffer(buf, np.uint8, dw * dh).reshape(dh, dw)
        return dxt.uncompress_depth(u8, c.near, c.far)
    return np.frombuffer(buf, "<f4", dw * dh).reshape(dh, dw).copy()


def encode_color(color01: np.ndarray,
                 compression: FrameCompression = None) -> bytes:
    from . import dxt

    c = compression or RAW
    u8 = np.clip(np.asarray(color01) * 255.0, 0, 255).astype(np.uint8)
    if c.rgb == 1:
        return dxt.encode_dxt1(u8)
    if c.rgb == 5:
        # DXT5: interleave a full-opacity alpha block per DXT1 color block
        return dxt.encode_dxt5_opaque(u8)
    return u8.tobytes()


def encode_depth(depth_m: np.ndarray,
                 compression: FrameCompression = None) -> bytes:
    from . import dxt

    c = compression or RAW
    if c.depth_u8:
        return dxt.compress_depth(
            np.asarray(depth_m), c.near, c.far
        ).tobytes()
    return np.asarray(depth_m, "<f4").tobytes()


class StreamReader:
    """Looping per-sensor stream file reader; decodes per the sensor's
    compression flags like the reference's file replay."""

    def __init__(self, path, depth_size: Tuple[int, int], color_size: Tuple[int, int],
                 loop: bool = True, compression: FrameCompression = None):
        self.path = Path(path)
        self.depth_size = depth_size    # (W, H)
        self.color_size = color_size
        self.compression = compression or RAW
        self.color_bytes, self.depth_bytes = frame_wire_size(
            depth_size, color_size, self.compression
        )
        self.frame_bytes = self.color_bytes + self.depth_bytes
        self._data = self.path.read_bytes()
        if len(self._data) < self.frame_bytes:
            raise ValueError(
                f"{path}: {len(self._data)} bytes < one frame ({self.frame_bytes})"
            )
        self.num_frames = len(self._data) // self.frame_bytes
        self.loop = loop
        self._pos = 0

    def read_frame(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (color (H, W, 3) float32 [0,1], depth (H, W) float32 m)."""
        if self._pos >= self.num_frames:
            if not self.loop:
                raise EOFError(self.path)
            self._pos = 0
        off = self._pos * self.frame_bytes
        self._pos += 1
        cbuf = self._data[off: off + self.color_bytes]
        dbuf = self._data[off + self.color_bytes: off + self.frame_bytes]
        color = decode_color(cbuf, self.color_size, self.compression)
        depth = decode_depth(dbuf, self.depth_size, self.compression)
        return color, depth


class StreamWriter:
    """Writer producing reference-layout stream files (for recording
    synthetic or live sequences), optionally compressed."""

    def __init__(self, path, compression: FrameCompression = None):
        self._f = open(path, "wb")
        self.compression = compression or RAW

    def write_frame(self, color: np.ndarray, depth: np.ndarray) -> None:
        self._f.write(encode_color(color, self.compression))
        self._f.write(encode_depth(depth, self.compression))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
