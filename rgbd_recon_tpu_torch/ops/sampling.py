"""GL-semantics texture sampling as tensor gathers (counterpart of
rgbd_recon_tpu/ops/sampling.py).

Normalized coordinate c over an axis of N texels maps to texel space
x = c*N - 0.5; the taps are floor(x) and floor(x)+1, each clamped to
[0, N-1] (CLAMP_TO_EDGE), blended by x - floor(x).
"""

from __future__ import annotations

import torch


def _idx(xf: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate to int and clamp to [0, n-1] (astype(int32) + clip)."""
    return torch.clamp(xf.to(torch.int32), 0, n - 1).to(torch.int64)


def trilinear_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) volume sampled at (..., 3) normalized (x, y, z) ->
    (..., C); GLSL texture(sampler3D) with LINEAR filtering and edge clamp."""
    D, H, W, C = volume.shape
    flat = volume.reshape(D * H * W, C)
    cx = coords[..., 0] * W - 0.5
    cy = coords[..., 1] * H - 0.5
    cz = coords[..., 2] * D - 0.5
    x0f, y0f, z0f = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    fx = (cx - x0f)[..., None]
    fy = (cy - y0f)[..., None]
    fz = (cz - z0f)[..., None]
    x0, x1 = _idx(x0f, W), _idx(x0f + 1.0, W)
    y0, y1 = _idx(y0f, H), _idx(y0f + 1.0, H)
    z0, z1 = _idx(z0f, D), _idx(z0f + 1.0, D)

    def g(z, y, x):
        return flat[(z * H + y) * W + x]

    c00 = g(z0, y0, x0) * (1 - fx) + g(z0, y0, x1) * fx
    c01 = g(z0, y1, x0) * (1 - fx) + g(z0, y1, x1) * fx
    c10 = g(z1, y0, x0) * (1 - fx) + g(z1, y0, x1) * fx
    c11 = g(z1, y1, x0) * (1 - fx) + g(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def bilinear_2d(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(H, W, C) image sampled at (..., 2) normalized (u, v) -> (..., C)."""
    H, W, C = image.shape
    flat = image.reshape(H * W, C)
    cx = coords[..., 0] * W - 0.5
    cy = coords[..., 1] * H - 0.5
    x0f, y0f = torch.floor(cx), torch.floor(cy)
    fx = (cx - x0f)[..., None]
    fy = (cy - y0f)[..., None]
    x0, x1 = _idx(x0f, W), _idx(x0f + 1.0, W)
    y0, y1 = _idx(y0f, H), _idx(y0f + 1.0, H)
    c0 = flat[y0 * W + x0] * (1 - fx) + flat[y0 * W + x1] * fx
    c1 = flat[y1 * W + x0] * (1 - fx) + flat[y1 * W + x1] * fx
    return c0 * (1 - fy) + c1 * fy


def nearest_2d(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-texel 2D sampling (NEAREST filtering on normalized coords)."""
    H, W, C = image.shape
    flat = image.reshape(H * W, C)
    x = _idx(torch.floor(coords[..., 0] * W), W)
    y = _idx(torch.floor(coords[..., 1] * H), H)
    return flat[y * W + x]


def nearest_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """NEAREST sample of a (D, H, W, C) volume at (..., 3) normalized
    (x, y, z): the truncated texel index, clamped. -> (..., C)."""
    D, H, W, C = volume.shape
    x = _idx(coords[..., 0] * W, W)
    y = _idx(coords[..., 1] * H, H)
    z = _idx(coords[..., 2] * D, D)
    return volume.reshape(D * H * W, C)[(z * H + y) * W + x]


def pair_trilinear(table: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   pz: torch.Tensor, clamp_floor=None) -> torch.Tensor:
    """Trilinear sample of a (Z, Y, X) table at planar normalized positions
    with the tap rule of raymarch.PackedVolume.sample_trilinear_p: the x
    taps are (x0, min(x0+1, X-1)) with zero x weight left of the first
    texel, the y and z taps clamp as in trilinear_3d. ``clamp_floor``
    clamps each tap from below before interpolation. Reads f32 from an f32
    or bf16 table; returns f32."""
    D, H, W = table.shape
    flat = table.reshape(-1)
    cx = px * W - 0.5
    cy = py * H - 0.5
    cz = pz * D - 0.5
    x0f, y0f, z0f = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    fx = torch.where(x0f < 0.0, 0.0, cx - x0f)
    fy = cy - y0f
    fz = cz - z0f
    x0 = _idx(x0f, W)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y0, y1 = _idx(y0f, H), _idx(y0f + 1.0, H)
    z0, z1 = _idx(z0f, D), _idx(z0f + 1.0, D)

    def pair(z, y):
        base = (z * H + y) * W
        a = flat[base + x0].to(torch.float32)
        b = flat[base + x1].to(torch.float32)
        if clamp_floor is not None:
            a = torch.clamp_min(a, clamp_floor)
            b = torch.clamp_min(b, clamp_floor)
        return a * (1.0 - fx) + b * fx

    c0 = pair(z0, y0) * (1.0 - fy) + pair(z0, y1) * fy
    c1 = pair(z1, y0) * (1.0 - fy) + pair(z1, y1) * fy
    return c0 * (1.0 - fz) + c1 * fz


def pair_bilinear(image: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with the x-pair tap rule of raymarch._pair_bilinear:
    the x taps are (x0, min(x0+1, W-1)) and the x weight is 0 left of the
    first texel; the y taps clamp like bilinear_2d. (H, W, C) -> (..., C)."""
    H, W, C = image.shape
    flat = image.reshape(H * W, C)
    cx = u * W - 0.5
    cy = v * H - 0.5
    x0f, y0f = torch.floor(cx), torch.floor(cy)
    fx = torch.where(x0f < 0.0, 0.0, cx - x0f)[..., None]
    fy = (cy - y0f)[..., None]
    x0 = _idx(x0f, W)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y0, y1 = _idx(y0f, H), _idx(y0f + 1.0, H)
    r0 = flat[y0 * W + x0].to(torch.float32)
    r0n = flat[y0 * W + x1].to(torch.float32)
    r1 = flat[y1 * W + x0].to(torch.float32)
    r1n = flat[y1 * W + x1].to(torch.float32)
    c0 = r0 * (1 - fx) + r0n * fx
    c1 = r1 * (1 - fx) + r1n * fx
    return c0 * (1 - fy) + c1 * fy


def quad_bilinear(image: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with the four-corner tap rule of
    raymarch._quad_bilinear_p: corners (x0|x0+1) x (y0|y0+1), each +1 tap
    clamped to the edge, and zero weight toward a tap left of/above the
    first texel. (H, W, C) -> (..., C) f32."""
    H, W, C = image.shape
    flat = image.reshape(H * W, C)
    cx = u * W - 0.5
    cy = v * H - 0.5
    x0f, y0f = torch.floor(cx), torch.floor(cy)
    fx = torch.where(x0f < 0.0, 0.0, cx - x0f)[..., None]
    fy = torch.where(y0f < 0.0, 0.0, cy - y0f)[..., None]
    x0, y0 = _idx(x0f, W), _idx(y0f, H)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    r00 = flat[y0 * W + x0].to(torch.float32)
    r01 = flat[y0 * W + x1].to(torch.float32)
    r10 = flat[y1 * W + x0].to(torch.float32)
    r11 = flat[y1 * W + x1].to(torch.float32)
    c0 = r00 * (1 - fx) + r01 * fx
    c1 = r10 * (1 - fx) + r11 * fx
    return c0 * (1 - fy) + c1 * fy
