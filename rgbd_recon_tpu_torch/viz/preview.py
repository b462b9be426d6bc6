"""Minimal live preview: MJPEG-over-HTTP stream of the latest render (the
port's copy of rgbd_recon_tpu/viz/preview.py, with its own JPEG encoder,
``viz/jpeg.py``, in place of PIL).

The reference is an interactive GLFW/ImGui viewer
(source/kinect_client.cpp:583-716); the TPU framework runs headless, with
the feedback channel as its control surface. This module closes the last
gap — WATCHING a running reconstruction — with the lightest-weight remote
display there is: an HTTP endpoint any browser (or ffplay) can open.

    preview = PreviewServer(port=8089)
    ...
    preview.update(out.color)     # (H, W, 3) float [0,1], any device

Endpoints:  /        tiny HTML page wrapping the stream
            /stream  multipart/x-mixed-replace MJPEG
            /frame   single JPEG snapshot

Stdlib http.server + numpy only. update() only copies the frame to the
host; the numpy encoder (~144 ms for a 1280x720 frame on an H100 machine's
host, PERF.md) runs on a server thread, once per frame, when a viewer asks
for it, so the caller's frame loop pays nothing for it and nothing at all
while nobody watches. Frames are dropped, never queued — a slow viewer
sees the latest frame, like every other drop-to-latest surface in this
framework.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .jpeg import encode_jpeg

_PAGE = b"""<!doctype html><html><head><title>rgbd_recon_tpu</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{max-width:100%;max-height:100%}
</style></head><body><img src="/stream"></body></html>"""


class PreviewServer:
    """Background MJPEG preview server. Thread-safe update()."""

    def __init__(self, port: int = 8089, host: str = "0.0.0.0",
                 quality: int = 80):
        self._lock = threading.Condition()
        self._frame = None          # the latest frame, on the host
        self._seq = 0
        self._encode_lock = threading.Lock()
        self._encoded = (-1, b"")   # (seq, JPEG) of the last encode
        self._quality = int(quality)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/frame":
                    buf = outer._latest()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(buf)))
                    self.end_headers()
                    self.wfile.write(buf)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            buf, last = outer._next(last)
                            self.wfile.write(
                                b"--f\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(buf)}\r\n\r\n"
                                .encode()
                            )
                            self.wfile.write(buf)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _jpeg(self, seq: int, frame) -> bytes:
        """The JPEG of frame ``seq``, encoded once whichever viewer asks
        first (a blank frame before any)."""
        if frame is None:
            return _blank_jpeg()
        with self._encode_lock:
            if self._encoded[0] != seq:
                self._encoded = (seq, encode_jpeg(frame, self._quality))
            return self._encoded[1]

    def _latest(self) -> bytes:
        with self._lock:
            seq, frame = self._seq, self._frame
        return self._jpeg(seq, frame)

    def _next(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists (or timeout —
        then re-send the latest so the stream stays alive)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._seq == last_seq or self._frame is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._lock.wait(remaining):
                    break
            seq, frame = self._seq, self._frame
        return self._jpeg(seq, frame), seq

    def update(self, image) -> None:
        """Publish a frame: (H, W, 3) float [0,1] or uint8, a numpy array
        (copied) or a tensor on any device (copied to the host). Encoding
        waits for a viewer."""
        if hasattr(image, "detach"):
            frame = image.detach().cpu().numpy()
        else:
            frame = np.array(image)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {frame.shape}")
        with self._lock:
            self._frame = frame
            self._seq += 1
            self._lock.notify_all()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def _blank_jpeg() -> bytes:
    return encode_jpeg(np.zeros((16, 16, 3), np.uint8))
