"""ZeroMQ data + control plane, wire-format compatible with the reference.

Data plane (NetKinectArray::readLoop, framework/NetKinectArray.cpp:484-544):
  - ZMQ SUB socket, subscribe-all, RCVHWM=1 (drop to latest — the
    reference's implicit backpressure, SURVEY.md §5),
  - one message = [double timestamp][per sensor: color bytes, depth bytes],
  - master + slave endpoints with a live stream-slot switch (:513-518).

Control plane (FeedbackReceiver, framework/io/FeedbackReceiver.{h,cpp}):
  - second SUB channel delivering a packed feedback struct
    {mat4 cyclops, mat4 screen, mat4 model, uint recon_mode,
     uint stream_slot} (FeedbackReceiver.h:16-22), used by the display-wall
    stereo mode; here it updates render parameters per step.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from .stream import frame_wire_size


class ZmqFrameSource:
    """Background SUB receiver with drop-to-latest semantics."""

    def __init__(
        self,
        endpoint_master: str,
        num_sensors: int,
        depth_size: Tuple[int, int],
        color_size: Tuple[int, int],
        endpoint_slave: Optional[str] = None,
        compression=None,
    ):
        """``compression`` is a single FrameCompression applied to every
        sensor, or a per-sensor list — the reference sizes each sensor's
        buffers from its own calibration's isCompressedRGB/Depth flags
        (NetKinectArray.cpp:120-144), so heterogeneous rigs decode with
        per-sensor frame sizes."""
        import zmq

        from .stream import RAW

        self.num_sensors = num_sensors
        self.depth_size = depth_size
        self.color_size = color_size
        comp = compression if compression is not None else RAW
        if not isinstance(comp, (list, tuple)):
            comp = [comp] * num_sensors
        assert len(comp) == num_sensors, (len(comp), num_sensors)
        self.compressions = list(comp)
        self.sizes = [
            frame_wire_size(depth_size, color_size, ci)
            for ci in self.compressions
        ]
        self._ctx = zmq.Context.instance()
        self._endpoints = [endpoint_master, endpoint_slave or endpoint_master]
        self.stream_slot = 0
        self._latest = None
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _connect(self, slot: int):
        import zmq

        sock = self._ctx.socket(zmq.SUB)
        sock.setsockopt(zmq.RCVHWM, 1)  # latest-frame semantics (:491-499)
        sock.setsockopt(zmq.SUBSCRIBE, b"")
        sock.setsockopt(zmq.RCVTIMEO, 200)
        sock.connect(self._endpoints[slot])
        return sock

    def _loop(self):
        import zmq

        socks = [self._connect(0), self._connect(1)]
        per = sum(cb + db for cb, db in self.sizes)
        while self._running:
            try:
                msg = socks[self.stream_slot].recv()
            except zmq.Again:
                continue
            if len(msg) < 8 + per:
                continue  # malformed; reference would read garbage
            with self._lock:
                self._latest = msg
        for s in socks:
            s.close(0)

    def latest(self):
        """Returns (timestamp, colors (N,H,W,3) f32, depths (N,H,W) f32)
        or None if nothing received yet. Decodes outside the lock."""
        with self._lock:
            msg = self._latest
            self._latest = None
        if msg is None:
            return None
        (ts,) = struct.unpack_from("<d", msg, 0)
        from .stream import decode_color, decode_depth

        cw, ch = self.color_size
        dw, dh = self.depth_size
        colors = np.empty((self.num_sensors, ch, cw, 3), np.float32)
        depths = np.empty((self.num_sensors, dh, dw), np.float32)
        off = 8
        for i in range(self.num_sensors):
            cb, db = self.sizes[i]
            colors[i] = decode_color(
                msg[off: off + cb], self.color_size, self.compressions[i]
            )
            off += cb
            depths[i] = decode_depth(
                msg[off: off + db], self.depth_size, self.compressions[i]
            )
            off += db
        return ts, colors, depths

    def close(self):
        self._running = False
        self._thread.join(timeout=2.0)


# feedback struct: 3 mat4 (column-major f32) + 2 uint32
_FEEDBACK_FMT = "<48f2I"
FEEDBACK_BYTES = struct.calcsize(_FEEDBACK_FMT)


@dataclasses.dataclass
class FeedbackState:
    cyclops_mat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    screen_mat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    model_mat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    recon_mode: int = 1
    stream_slot: int = 0

    def pack(self) -> bytes:
        vals = []
        for m in (self.cyclops_mat, self.screen_mat, self.model_mat):
            vals.extend(np.asarray(m, np.float32).reshape(16, order="F").tolist())
        return struct.pack(_FEEDBACK_FMT, *vals, self.recon_mode, self.stream_slot)

    @classmethod
    def unpack(cls, data: bytes) -> "FeedbackState":
        vals = struct.unpack(_FEEDBACK_FMT, data[:FEEDBACK_BYTES])
        mats = [
            np.asarray(vals[i * 16 : (i + 1) * 16], np.float32).reshape(4, 4, order="F")
            for i in range(3)
        ]
        return cls(
            cyclops_mat=mats[0], screen_mat=mats[1], model_mat=mats[2],
            recon_mode=int(vals[48]), stream_slot=int(vals[49]),
        )


class FeedbackReceiver:
    """SUB receiver for FeedbackState (FeedbackReceiver.cpp:40-67)."""

    def __init__(self, endpoint: str, initial: FeedbackState = None):
        import zmq

        self._state = initial or FeedbackState()
        self._lock = threading.Lock()
        self._seq = 0
        self._running = True
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.setsockopt(zmq.RCVHWM, 1)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self._sock.setsockopt(zmq.RCVTIMEO, 200)
        self._sock.connect(endpoint)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        import zmq

        while self._running:
            try:
                msg = self._sock.recv()
            except zmq.Again:
                continue
            if len(msg) >= FEEDBACK_BYTES:
                fb = FeedbackState.unpack(msg)
                with self._lock:
                    self._state = fb
                    self._seq += 1

    @property
    def seq(self) -> int:
        """Number of feedback messages received (0 = defaults only)."""
        with self._lock:
            return self._seq

    def get(self) -> FeedbackState:
        with self._lock:
            return self._state

    def close(self):
        self._running = False
        self._thread.join(timeout=2.0)
        self._sock.close(0)
