"""The port's live preview (rgbd_recon_tpu_torch/viz/preview.py) and its
own baseline JPEG encoder (viz/jpeg.py), decoded by PIL:

- the preview server: tests/test_app.py's test_preview_server_streams_frames
  on the port;
- the encoder: a sphere rendered by the port's pipeline, encoded at quality
  80, decodes to PSNR >= 30 dB; on gradient images of odd sizes and three
  qualities its PSNR is within 0.5 dB of PIL's own encoder at the same
  quality (both quantise with the same tables); its quantisation and
  Huffman tables are those libjpeg writes (T.81 Annex K), its chroma 4:2:0;
- update() leaves the encoding to the viewer's thread, once a frame;
- the app: ``run --preview-port PORT`` on the CPU serves each frame it
  renders at /frame, a JPEG within 30 dB of the PNG it saved; 0 (the
  default) opens no server.
"""

import io
import socket
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from rgbd_recon_tpu_torch.dist.worker import scene as small_scene
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.viz import jpeg
from rgbd_recon_tpu_torch.viz.preview import PreviewServer

torch.set_num_threads(2)


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _decode(data: bytes) -> np.ndarray:
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _segments(data: bytes) -> dict:
    """{marker: [payload, ...]} of the header segments before the scan."""
    out, i = {}, 2
    while True:
        marker, size = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        out.setdefault(marker, []).append(data[i + 4:i + 2 + size])
        if marker == 0xDA:
            return out
        i += 2 + size


def test_preview_server_streams_frames():
    """Live MJPEG preview: update() publishes frames that /frame and
    /stream serve (tests/test_app.py's test on the port)."""
    srv = PreviewServer(port=0)  # ephemeral port
    try:
        img = np.zeros((24, 32, 3), np.float32)
        img[:, :16] = (1.0, 0.2, 0.1)
        srv.update(img)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/frame", timeout=5
        ) as r:
            data = r.read()
        assert data[:2] == b"\xff\xd8"  # JPEG SOI
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/", timeout=5
        ) as r:
            assert b"/stream" in r.read()
        # the stream endpoint delivers at least one multipart frame
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/stream", timeout=5
        )
        chunk = req.read(64)
        assert b"--f" in chunk and b"image/jpeg" in chunk
        req.close()
    finally:
        srv.close()
    from rgbd_recon_tpu_torch.io import dxt

    u8 = dxt.compress_depth(np.array([0.0, 0.2, 10.0], np.float32), 0.5, 4.5)
    assert (dxt.uncompress_depth(u8, 0.5, 4.5) == 0.0).all()


def test_preview_takes_tensors_and_serves_the_latest():
    """update() takes a float tensor or uint8 numpy; /frame serves the last
    one (drop to latest), a blank frame before any."""
    srv = PreviewServer(port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}/frame"
        with urllib.request.urlopen(url, timeout=5) as r:
            assert _decode(r.read()).shape == (16, 16, 3)
        srv.update(torch.full((20, 36, 3), 0.5))
        red = np.zeros((30, 40, 3), np.uint8)
        red[..., 0] = 255
        srv.update(red)
        with urllib.request.urlopen(url, timeout=5) as r:
            got = _decode(r.read())
        assert got.shape == (30, 40, 3) and _psnr(got, red) >= 30.0
    finally:
        srv.close()


def test_update_leaves_the_encoding_to_a_viewer(monkeypatch):
    """update() encodes nothing: frames nobody fetches are never encoded,
    and a frame is encoded once however often it is fetched."""
    from rgbd_recon_tpu_torch.viz import preview

    calls = []

    def counted(image, quality=80):
        calls.append(np.asarray(image).shape)
        return jpeg.encode_jpeg(image, quality)

    monkeypatch.setattr(preview, "encode_jpeg", counted)
    srv = PreviewServer(port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}/frame"
        for h in (8, 16, 24):
            srv.update(np.full((h, 40, 3), 0.25, np.float32))
        assert calls == []
        for _ in range(2):
            with urllib.request.urlopen(url, timeout=5) as r:
                assert _decode(r.read()).shape == (24, 40, 3)
        assert calls == [(24, 40, 3)]
        with pytest.raises(ValueError, match="H, W, 3"):
            srv.update(np.zeros((4, 4), np.uint8))
    finally:
        srv.close()


def test_sphere_render_decodes_at_30_db():
    """A 160x120 render of the sphere (the multi-process worker's scene,
    seen from 1.5 m), encoded at quality 80 and decoded by PIL: PSNR >= 30
    dB."""
    pipe, frames, _ = small_scene("cpu")
    cam = ViewCamera(width=160, height=120, eye=(0.0, 1.15, 1.5),
                     target=(0.0, 1.1, 0.0))
    out = pipe.make_renderer(cam)(*pipe.fuse(frames))
    assert int(out.hit.sum()) > 1000
    img = (np.clip(out.color.numpy(), 0.0, 1.0) * 255).astype(np.uint8)
    data = jpeg.encode_jpeg(out.color.numpy(), quality=80)
    assert _psnr(_decode(data), img) >= 30.0


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + 2 * yy) % 256], -1).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("shape", [(1, 1), (17, 3), (40, 48), (37, 101),
                                   (120, 160)])
def test_encoder_matches_pil_quality(shape, quality):
    img = _gradient(*shape)
    ours = _decode(jpeg.encode_jpeg(img, quality))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    pil = _decode(buf.getvalue())
    assert ours.shape == img.shape
    assert _psnr(ours, img) >= min(_psnr(pil, img) - 0.5, 60.0)


@pytest.mark.parametrize("quality", [10, 80, 100])
def test_encoder_tables_are_libjpegs(quality):
    """The quantisation tables (Annex K.1 scaled by the IJG rule), the
    Huffman tables (Annex K.3) and the frame header (4:2:0) of our file
    equal those of PIL's at the same quality."""
    img = _gradient(24, 40)
    ours = _segments(jpeg.encode_jpeg(img, quality))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    pil = _segments(buf.getvalue())
    assert b"".join(ours[0xDB]) == b"".join(pil[0xDB])
    assert b"".join(ours[0xC4]) == b"".join(pil[0xC4])
    assert ours[0xC0] == pil[0xC0]
    assert Image.open(io.BytesIO(jpeg.encode_jpeg(img))).layer == [
        (1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]


def test_encoder_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="H, W, 3"):
        jpeg.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="side"):
        jpeg.encode_jpeg(np.zeros((0, 4, 3), np.uint8))


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """Two frames of two sensors recorded by the port's app, and the .ks
    of their rig; the run arguments that go with them."""
    from rgbd_recon_tpu_torch import app

    root = tmp_path_factory.mktemp("preview_app")
    sizes = ["--depth-size", "40", "32", "--color-size", "48", "40"]
    app.main(["record", "--out", str(root / "rec"), "--frames", "2",
              "--sensors", "2", *sizes])
    (root / "s.ks").write_text(
        "kinect a.yml\nkinect b.yml\nbbx -1 0 -1 1 2.2 1\n")

    def run_args(out):
        return ["run", str(root / "s.ks"), "--streams", str(root / "rec"),
                "--no-native-ingest", "--frames", "2", "--out", str(out),
                "--width", "64", "--height", "48", *sizes, "--inv-res",
                "24", "26", "24", "--mode", "1", "--device", "cpu"]

    return run_args


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_app_serves_its_frames(recording, tmp_path, monkeypatch, capsys):
    """``app run --preview-port PORT --device cpu``: after each frame the
    preview's /frame holds that frame's render (fetched over HTTP right
    after the app publishes it), within 30 dB of the PNG it saved."""
    from rgbd_recon_tpu_torch import app

    served = []
    publish = PreviewServer.update

    def update_then_fetch(self, image):
        publish(self, image)
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/frame",
                                    timeout=5) as r:
            served.append(r.read())

    monkeypatch.setattr(PreviewServer, "update", update_then_fetch)
    port, out = _free_port(), tmp_path / "out"
    app.main([*recording(out), "--preview-port", str(port)])
    assert (f"live preview: http://localhost:{port}/"
            in capsys.readouterr().err)
    pngs = sorted(out.glob("frame_*.png"))
    assert len(served) == len(pngs) == 2
    for data, png in zip(served, pngs):
        want = np.asarray(Image.open(png).convert("RGB"))
        assert (want.sum(-1) > 0).sum() > 10
        assert _psnr(_decode(data), want) >= 30.0


def test_app_preview_port_zero_is_off(recording, tmp_path, monkeypatch,
                                      capsys):
    """``--preview-port 0`` (the default) opens no server, as in the JAX
    package's app."""
    from rgbd_recon_tpu_torch import app

    def refuse(self, *a, **k):
        raise AssertionError("a preview server was opened")

    monkeypatch.setattr(PreviewServer, "__init__", refuse)
    out = tmp_path / "out"
    app.main([*recording(out), "--preview-port", "0"])
    assert "live preview" not in capsys.readouterr().err
    assert len(sorted(out.glob("frame_*.png"))) == 2
