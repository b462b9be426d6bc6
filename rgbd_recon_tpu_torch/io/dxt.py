"""DXT (S3TC) texture codec + 8-bit depth compression — wire-format parity.

The reference's frame wire format supports three color encodings selected by
the calibration's compression flag (NetKinectArray.cpp:120-133, 150-156):
raw RGB24, DXT1 (8 bytes / 4x4 block) and DXT5 (16 bytes / 4x4 block,
0.5 byte/px alpha + DXT1 color). Decompression on the CPU path uses squish
(NetKinectArray.cpp:635); compression uses fastdxt (io/DXTCompressor).
Depth may arrive as uint8 with a sqrt mapping, undone per pixel in
glsl/pre_depth.fs:51-61 with scale = far - near and scaled_near = scale/255
(NetKinectArray.cpp:346-351).

This module implements all of these as vectorized numpy transforms (host
side — decode happens before device upload, like the reference's PBO path).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# RGB565 endpoints
# ---------------------------------------------------------------------------

def _rgb565_to_rgb(c: np.ndarray) -> np.ndarray:
    """(...,) uint16 -> (..., 3) float32 in [0, 255]."""
    r = ((c >> 11) & 0x1F).astype(np.float32) * (255.0 / 31.0)
    g = ((c >> 5) & 0x3F).astype(np.float32) * (255.0 / 63.0)
    b = (c & 0x1F).astype(np.float32) * (255.0 / 31.0)
    return np.stack([r, g, b], axis=-1)


def _rgb_to_rgb565(rgb: np.ndarray) -> np.ndarray:
    r = np.round(rgb[..., 0] * (31.0 / 255.0)).astype(np.uint16)
    g = np.round(rgb[..., 1] * (63.0 / 255.0)).astype(np.uint16)
    b = np.round(rgb[..., 2] * (31.0 / 255.0)).astype(np.uint16)
    return (r << 11) | (g << 5) | b


# ---------------------------------------------------------------------------
# DXT1
# ---------------------------------------------------------------------------

def dxt1_storage_size(width: int, height: int) -> int:
    """Bytes for a DXT1 image (8 bytes per 4x4 block, dims rounded up)."""
    return max(1, (width + 3) // 4) * max(1, (height + 3) // 4) * 8


def dxt5_storage_size(width: int, height: int) -> int:
    return max(1, (width + 3) // 4) * max(1, (height + 3) // 4) * 16


def decode_dxt1(data: bytes, width: int, height: int) -> np.ndarray:
    """DXT1 -> (H, W, 3) uint8. Vectorized over all blocks."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    raw = np.frombuffer(data, np.uint8, count=bw * bh * 8).reshape(bh * bw, 8)
    c0 = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
    c1 = raw[:, 2].astype(np.uint16) | (raw[:, 3].astype(np.uint16) << 8)
    bits = (
        raw[:, 4].astype(np.uint32)
        | (raw[:, 5].astype(np.uint32) << 8)
        | (raw[:, 6].astype(np.uint32) << 16)
        | (raw[:, 7].astype(np.uint32) << 24)
    )
    p0 = _rgb565_to_rgb(c0)
    p1 = _rgb565_to_rgb(c1)
    four = c0 > c1  # 4-color mode; else 3-color + transparent black
    p2 = np.where(four[:, None], (2 * p0 + p1) / 3.0, (p0 + p1) * 0.5)
    p3 = np.where(four[:, None], (p0 + 2 * p1) / 3.0, 0.0)
    palette = np.stack([p0, p1, p2, p3], axis=1)  # (B, 4, 3)

    idx = np.arange(16, dtype=np.uint32)
    sel = (bits[:, None] >> (idx[None, :] * 2)) & 0x3  # (B, 16)
    texels = np.take_along_axis(palette, sel[..., None].astype(np.int64), axis=1)

    out = texels.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    out = out.reshape(bh * 4, bw * 4, 3)[:height, :width]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def encode_dxt1(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> DXT1 bytes. Range-fit: endpoints are the texel
    min/max along the principal luminance order (fast; the reference's
    fastdxt is a similar quality/speed point)."""
    h, w = rgb.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    padded = np.zeros((bh * 4, bw * 4, 3), np.float32)
    padded[:h, :w] = rgb[..., :3]
    # pad by edge-replication so padding never affects endpoints
    if h % 4:
        padded[h:] = padded[h - 1 : h]
    if w % 4:
        padded[:, w:] = padded[:, w - 1 : w]
    blocks = (
        padded.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    )

    lum = blocks @ np.array([0.299, 0.587, 0.114], np.float32)
    lo = blocks[np.arange(len(blocks)), lum.argmin(axis=1)]
    hi = blocks[np.arange(len(blocks)), lum.argmax(axis=1)]
    c_hi = _rgb_to_rgb565(hi)
    c_lo = _rgb_to_rgb565(lo)
    # ensure 4-color mode (c0 > c1); equal endpoints -> flat block, indices 0
    swap = c_hi < c_lo
    c0 = np.where(swap, c_lo, c_hi)
    c1 = np.where(swap, c_hi, c_lo)
    p0 = _rgb565_to_rgb(c0)
    p1 = _rgb565_to_rgb(c1)
    palette = np.stack(
        [p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0], axis=1
    )  # (B, 4, 3)
    d = blocks[:, :, None, :] - palette[:, None, :, :]
    sel = np.square(d).sum(-1).argmin(-1).astype(np.uint32)  # (B, 16)
    bits = np.zeros(len(blocks), np.uint32)
    for i in range(16):
        bits |= sel[:, i] << np.uint32(2 * i)

    out = np.empty((len(blocks), 8), np.uint8)
    out[:, 0] = c0 & 0xFF
    out[:, 1] = c0 >> 8
    out[:, 2] = c1 & 0xFF
    out[:, 3] = c1 >> 8
    out[:, 4] = bits & 0xFF
    out[:, 5] = (bits >> 8) & 0xFF
    out[:, 6] = (bits >> 16) & 0xFF
    out[:, 7] = (bits >> 24) & 0xFF
    return out.tobytes()


# ---------------------------------------------------------------------------
# DXT5 (interpolated alpha + DXT1 color)
# ---------------------------------------------------------------------------

def decode_dxt5(data: bytes, width: int, height: int) -> np.ndarray:
    """DXT5 -> (H, W, 4) uint8 RGBA."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    raw = np.frombuffer(data, np.uint8, count=bw * bh * 16).reshape(bh * bw, 16)

    a0 = raw[:, 0].astype(np.float32)
    a1 = raw[:, 1].astype(np.float32)
    abits = np.zeros(len(raw), np.uint64)
    for i in range(6):
        abits |= raw[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    idx = np.arange(16, dtype=np.uint64)
    asel = ((abits[:, None] >> (idx[None, :] * np.uint64(3))) & np.uint64(7)).astype(np.int64)

    # 8-alpha palette (a0 > a1) vs 6-alpha + 0/255
    pal8 = np.stack(
        [a0, a1] + [((7 - i) * a0 + i * a1) / 7.0 for i in range(1, 7)], axis=1
    )
    pal6 = np.stack(
        [a0, a1]
        + [((5 - i) * a0 + i * a1) / 5.0 for i in range(1, 5)]
        + [np.zeros_like(a0), np.full_like(a0, 255.0)],
        axis=1,
    )
    pal = np.where((a0 > a1)[:, None], pal8, pal6)
    alpha = np.take_along_axis(pal, asel, axis=1)  # (B, 16)

    rgb = decode_dxt1(
        np.ascontiguousarray(raw[:, 8:]).tobytes(), width, height
    ).astype(np.float32)
    am = alpha.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)
    am = am[:height, :width]
    return np.concatenate(
        [rgb, np.clip(np.round(am), 0, 255).astype(np.float32)[..., None]], axis=-1
    ).astype(np.uint8)


def encode_dxt5_opaque(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> DXT5 bytes with a constant-255 alpha channel
    (sufficient for the color wire format — the reference's DXT5 frames
    carry opaque video). Alpha block: a0=255, a1=0, all indices 0."""
    h, w = rgb.shape[:2]
    color = np.frombuffer(encode_dxt1(rgb), np.uint8).reshape(-1, 8)
    alpha = np.zeros((color.shape[0], 8), np.uint8)
    alpha[:, 0] = 255
    return np.concatenate([alpha, color], axis=1).tobytes()


# ---------------------------------------------------------------------------
# 8-bit depth compression (sqrt mapping)
# ---------------------------------------------------------------------------

def uncompress_depth(
    d_u8: np.ndarray, near: float, far: float
) -> np.ndarray:
    """uint8 depth -> metric float32 (pre_depth.fs:51-61): with
    d_c = byte/255, scale = far - near, scaled_near = scale/255:
      d_c < scaled_near -> 0 (invalid)
      else (d_c^2 + 0.15 * scaled_near) * scale + near
    """
    scale = far - near
    scaled_near = scale / 255.0
    d_c = np.asarray(d_u8, np.float32) / 255.0
    out = (d_c * d_c + 0.15 * scaled_near) * scale + near
    return np.where(d_c < scaled_near, 0.0, out).astype(np.float32)


def compress_depth(depth_m: np.ndarray, near: float, far: float) -> np.ndarray:
    """Inverse of `uncompress_depth`: metric float32 -> uint8 (the sender's
    side of the sqrt mapping; invalid/out-of-range -> 0)."""
    scale = far - near
    scaled_near = scale / 255.0
    d = np.asarray(depth_m, np.float32)
    t = (d - near) / max(scale, 1e-9) - 0.15 * scaled_near
    d_c = np.sqrt(np.clip(t, 0.0, None))
    ok = (d > near) & (d_c >= scaled_near) & (d_c <= 1.0)
    return np.where(ok, np.round(d_c * 255.0), 0.0).astype(np.uint8)
