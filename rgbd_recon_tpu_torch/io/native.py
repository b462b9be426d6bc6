"""ctypes bindings for the native host-IO runtime (native/framering.cpp).

Provides a GIL-free stream replay pump: file -> C++ thread -> latest-frame
ring -> numpy. The port compiles the library itself with g++ into
``build/native/`` at the root of the checkout (never at import, and never
over the tracked ``native/libframering.so``); callers fall back to the
pure-Python StreamReader when it cannot be built."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SOURCE = _ROOT / "native" / "framering.cpp"
_LIB_PATH = _ROOT / "build" / "native" / "libframering.so"
# the flags of native/Makefile
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")
_lib = None


def _stale() -> bool:
    return (not _LIB_PATH.exists()
            or _SOURCE.stat().st_mtime > _LIB_PATH.stat().st_mtime)


def ensure_built(force: bool = False) -> bool:
    """Build build/native/libframering.so if needed. Returns availability."""
    global _lib
    if _lib is not None and not force:
        return True
    if not _SOURCE.exists():
        return False
    if force or _stale():
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: a concurrent process never
        # loads a half-written library
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return False
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return False

    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
    lib.ring_pop_latest.restype = ctypes.c_int
    lib.ring_pop_latest.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    ]
    lib.ring_seq.restype = ctypes.c_uint64
    lib.ring_seq.argtypes = [ctypes.c_void_p]
    lib.ring_dropped.restype = ctypes.c_uint64
    lib.ring_dropped.argtypes = [ctypes.c_void_p]
    lib.stream_open.restype = ctypes.c_void_p
    lib.stream_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.stream_read.restype = ctypes.c_int
    lib.stream_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.stream_num_frames.restype = ctypes.c_long
    lib.stream_num_frames.argtypes = [ctypes.c_void_p]
    lib.stream_close.argtypes = [ctypes.c_void_p]
    lib.pump_start.restype = ctypes.c_void_p
    lib.pump_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double]
    lib.pump_frames.restype = ctypes.c_uint64
    lib.pump_frames.argtypes = [ctypes.c_void_p]
    lib.pump_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return True


def available() -> bool:
    return ensure_built()


class NativeStreamReader:
    """In-order, looping .stream reader through the native library: the
    GIL-free drop-in for io.stream.StreamReader on the replay hot path
    (file read + memcpy run in C, releasing the GIL for the FrameFeed
    producer thread). All wire encodings: raw RGB24 / DXT1 / DXT5 color
    and f32 / u8 depth pump through the ring as wire bytes
    (frame_wire_size per encoding — NetKinectArray.cpp:120-144); the
    consumer side owns the decode (io/stream.decode_color/decode_depth),
    exactly like the reference's recv-side decompress
    (framework/NetKinectArray.cpp:511-542)."""

    def __init__(self, path, depth_size: Tuple[int, int],
                 color_size: Tuple[int, int], loop: bool = True,
                 compression=None):
        if not ensure_built():
            raise RuntimeError(
                "native library unavailable; use io.stream.StreamReader"
            )
        from .stream import RAW, frame_wire_size

        self.depth_size = depth_size
        self.color_size = color_size
        self.compression = compression or RAW
        self.color_bytes, self.depth_bytes = frame_wire_size(
            depth_size, color_size, self.compression
        )
        self.frame_bytes = self.color_bytes + self.depth_bytes
        self._stream = _lib.stream_open(
            str(path).encode(), self.frame_bytes, int(loop)
        )
        if not self._stream:
            raise FileNotFoundError(path)
        self.num_frames = _lib.stream_num_frames(self._stream)
        self._buf = np.empty(self.frame_bytes, np.uint8)

    def _decode(self) -> Tuple[np.ndarray, np.ndarray]:
        from .stream import decode_color, decode_depth

        color = decode_color(
            self._buf[: self.color_bytes].tobytes(), self.color_size,
            self.compression,
        )
        depth = decode_depth(
            self._buf[self.color_bytes:].tobytes(), self.depth_size,
            self.compression,
        )
        return color, depth

    def read_frame(self) -> Tuple[np.ndarray, np.ndarray]:
        """(color (H, W, 3) f32 [0,1], depth (H, W) f32 m), in file order."""
        if not _lib.stream_read(
            self._stream, self._buf.ctypes.data_as(ctypes.c_void_p)
        ):
            raise EOFError("stream exhausted")
        return self._decode()

    def close(self):
        if self._stream:
            _lib.stream_close(self._stream)
            self._stream = None


class NativeStreamPump:
    """File -> native pump thread -> latest-frame slot.

    The native replacement for io.feed.FrameFeed + io.stream.StreamReader
    when replaying recordings at a target rate."""

    def __init__(
        self,
        path,
        depth_size: Tuple[int, int],
        color_size: Tuple[int, int],
        fps: float = 30.0,
        loop: bool = True,
        compression=None,
    ):
        if not ensure_built():
            raise RuntimeError("native library unavailable; use io.stream.StreamReader")
        from .stream import RAW, frame_wire_size

        self.depth_size = depth_size
        self.color_size = color_size
        self.compression = compression or RAW
        self.color_bytes, self.depth_bytes = frame_wire_size(
            depth_size, color_size, self.compression
        )
        self.frame_bytes = self.color_bytes + self.depth_bytes
        self._stream = _lib.stream_open(
            str(path).encode(), self.frame_bytes, int(loop)
        )
        if not self._stream:
            raise FileNotFoundError(path)
        self.num_frames = _lib.stream_num_frames(self._stream)
        self._ring = _lib.ring_create(self.frame_bytes)
        self._buf = np.empty(self.frame_bytes, np.uint8)
        self._pump = _lib.pump_start(self._stream, self._ring, float(fps))

    def latest(self) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        """(timestamp, color (H,W,3) f32, depth (H,W) f32) or None."""
        ts = ctypes.c_double(0.0)
        got = _lib.ring_pop_latest(
            self._ring, self._buf.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ts)
        )
        if not got:
            return None
        from .stream import decode_color, decode_depth

        color = decode_color(
            self._buf[: self.color_bytes].tobytes(), self.color_size,
            self.compression,
        )
        depth = decode_depth(
            self._buf[self.color_bytes:].tobytes(), self.depth_size,
            self.compression,
        )
        return float(ts.value), color, depth

    @property
    def frames_pumped(self) -> int:
        return int(_lib.pump_frames(self._pump))

    @property
    def frames_dropped(self) -> int:
        return int(_lib.ring_dropped(self._ring))

    def close(self):
        if self._pump:
            _lib.pump_stop(self._pump)
            self._pump = None
        if self._ring:
            _lib.ring_destroy(self._ring)
            self._ring = None
        if self._stream:
            _lib.stream_close(self._stream)
            self._stream = None
