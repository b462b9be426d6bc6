"""Host -> device frame feed: the double-PBO equivalent (counterpart of
rgbd_recon_tpu/io/feed.py).

The reference overlaps network receive with GPU upload via a mutex-guarded
double pixel buffer (framework/double_pixel_buffer.cpp + NetKinectArray
update, SURVEY.md §2.10). Here a background thread pulls frames from any
source into a hand-off slot; the reconstruction loop calls `get()`, which
copies the frame to the device while the previous step's device work is
still in flight (CUDA's asynchronous launches give the overlap).

Two modes, matching the reference's two source behaviors:

  mode="latest"  drop-to-latest slot — the live-network policy (ZMQ SUB
                 with HWM=1, NetKinectArray.cpp:491-499): the loop always
                 sees the newest frame, intermediate frames are dropped.
  mode="ordered" bounded single-slot queue — deterministic in-order
                 delivery for .stream replay and synthetic sources (the
                 reference only drops frames on the live network path;
                 readFromFiles replays every frame, NetKinectArray.cpp:
                 724-764). The producer thread is paced by the consumer
                 (it blocks when the slot is full), so decode still
                 overlaps device compute without a free-running pump.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..sensors.frames import FrameSet


class FrameFeed:
    """Background frame pump delivering FrameSets on ``device`` (the card
    unless the caller names another)."""

    def __init__(
        self,
        source: Callable[[], Optional[tuple]],
        device=DEFAULT,
        poll_s: float = 0.001,
        mode: str = "latest",
    ):
        """source() returns (timestamp, colors, depths) numpy or None."""
        assert mode in ("latest", "ordered"), mode
        self.device = resolve(device)
        self._source = source
        self._mode = mode
        self._lock = threading.Lock()
        self._latest = None
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._seq = 0
        self._consumed = 0
        self._running = True
        self._poll_s = poll_s
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while self._running:
            try:
                item = self._source()
            except Exception:
                import traceback

                traceback.print_exc()
                break
            if item is None:
                time.sleep(self._poll_s)
                continue
            if self._mode == "ordered":
                # consumer-paced hand-off: block (with a running check)
                # until the loop takes the previous frame
                while self._running:
                    try:
                        self._queue.put(item, timeout=0.25)
                        with self._lock:
                            self._seq += 1
                        break
                    except queue.Full:
                        continue
            else:
                with self._lock:
                    self._latest = item
                    self._seq += 1

    def get(self, block: bool = True, timeout: float = 5.0):
        """Next frame as a FrameSet on the device, or None when none came
        within ``timeout``. mode="latest": the newest unseen frame,
        intermediates dropped (HWM=1); mode="ordered": the next frame in
        sequence, none dropped."""
        if self._mode == "ordered":
            try:
                ts, colors, depths = self._queue.get(block=block,
                                                     timeout=timeout)
            except queue.Empty:
                return None
            self._consumed += 1
        else:
            deadline = time.monotonic() + timeout
            while True:
                with self._lock:
                    if self._seq > self._consumed:
                        self._consumed = self._seq
                        ts, colors, depths = self._latest
                        break
                if not block or time.monotonic() > deadline:
                    return None
                time.sleep(self._poll_s)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.device)

        return FrameSet(colors=put(colors), depths=put(depths),
                        timestamp=torch.tensor(np.float32(ts),
                                               device=self.device))

    @property
    def frames_produced(self) -> int:
        return self._seq

    def close(self):
        self._running = False
        # unblock an ordered producer waiting on a full slot
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        # a producer mid-source() (e.g. tracing a synthetic render) must
        # finish its call before exiting — joining too short leaves a
        # daemon thread to be killed mid-C++ at interpreter teardown
        self._thread.join(timeout=30.0)
