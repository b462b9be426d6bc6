"""Host -> device frame feed (counterpart of rgbd_recon_tpu/io/feed.py).

The background pump and both hand-off policies ("latest": drop to the
newest frame, the live-network policy; "ordered": consumer-paced in-order
delivery for replay and synthetic sources) are the JAX package's
``FrameFeed``, which needs no jax; only ``get`` differs: it returns the
port's ``FrameSet`` with tensors on the pipeline's device.
"""

from __future__ import annotations

import queue
import time
from typing import Callable, Optional

import numpy as np
import torch

from rgbd_recon_tpu.io.feed import FrameFeed as _HostFeed

from ..sensors.frames import FrameSet


class FrameFeed(_HostFeed):
    """Background frame pump delivering FrameSets on ``device``."""

    def __init__(self, source: Callable[[], Optional[tuple]],
                 device="cpu", poll_s: float = 0.001, mode: str = "latest"):
        """source() returns (timestamp, colors, depths) numpy or None."""
        self.device = torch.device(device)
        super().__init__(source, poll_s=poll_s, mode=mode)

    def get(self, block: bool = True, timeout: float = 5.0):
        """Next frame as a FrameSet on the device, or None when none came
        within ``timeout``. mode="latest": the newest unseen frame,
        intermediates dropped; mode="ordered": the next frame in sequence."""
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
