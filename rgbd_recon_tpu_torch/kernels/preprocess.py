"""Launch wrappers of csrc/preprocess.cu (the preprocess chain's per-pixel
passes: one launch a pass)."""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from ._build import check, library

# flat indices of a map are below 2^31 elements in the kernels
_MAX_ENTRIES = 2 ** 31


def _check(x: torch.Tensor, name: str, shape, dev=None) -> None:
    """``x``: a contiguous float32 CUDA tensor of ``shape`` (on ``dev``)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"{name} must be a CUDA tensor, got {where}")
    if dev is not None and x.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.numel() >= _MAX_ENTRIES:
        raise ValueError(f"{name}: {x.numel()} entries, at most 2^31 - 1")


def _map_shape(x: torch.Tensor, name: str, channels=None):
    """(N, H, W) of an (N, H, W) map, or of an (N, H, W, channels) one."""
    dims = 3 if channels is None else 4
    if not isinstance(x, torch.Tensor) or x.dim() != dims or (
            channels is not None and x.shape[-1] != channels):
        form = "(N, H, W)" if channels is None else f"(N, H, W, {channels})"
        raise ValueError(f"{name} must be an {form} tensor")
    return tuple(x.shape[:3])


def _check_rays(pixel_models, shape, dev) -> list:
    """The pixel models' ray_a and ray_b: (N, H, W, 3) on ``dev``."""
    rays = [pixel_models.ray_a, pixel_models.ray_b]
    for t, name in zip(rays, ("ray_a", "ray_b")):
        _check(t, name, (*shape, 3), dev)
    return rays


def _launch(name: str, dev: torch.device, entry: str, *args) -> None:
    """Call ``entry`` on ``dev``'s current stream; raise on its error code,
    count the launch."""
    lib = library()
    # launch on the tensors' device (the current one may be another)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    LAUNCHES[name] += 1


def morph_plan(depth: torch.Tensor) -> dict:
    """The morph's launch on ``depth`` (csrc/preprocess.cu
    rgbd_pre_morph_plan; the output, a fresh allocation, is 16-byte
    aligned): grid, threads a block, and whether the vector path (16-byte
    loads and stores, 4 pixels a thread) runs."""
    N, H, W = _map_shape(depth, "depth")
    plan = (ctypes.c_int * 6)()
    library().rgbd_pre_morph_plan(depth.data_ptr(), depth.data_ptr(), N, H,
                                  W, plan)
    return dict(grid=tuple(plan[:3]), threads=tuple(plan[3:5]),
                vector=bool(plan[5]))


def morph_cuda(depth: torch.Tensor) -> torch.Tensor:
    """ops/preprocess.py morph_dilate_plain in one launch: (N, H, W) metric
    depth -> (N, H, W) morphed depth."""
    N, H, W = _map_shape(depth, "depth")
    _check(depth, "depth", (N, H, W))
    out = torch.empty_like(depth)
    _launch("morph", depth.device, "rgbd_pre_morph", depth.data_ptr(),
            out.data_ptr(), N, H, W)
    return out


def lab_cuda(colors: torch.Tensor, depth_norm: torch.Tensor, pixel_models,
             z_far: float) -> torch.Tensor:
    """ops/preprocess.py lab_colors_plain on the pixel models in one launch:
    (N, Hc, Wc, 3) colour in [0, 1] + (N, H, W) normalized depth -> (N, H,
    W, 3) LAB; degenerate depths sample at ``z_far``. The colour is rounded
    to bf16 tap by tap, as the twin's bf16 copy of the frame."""
    N, H, W = _map_shape(depth_norm, "depth_norm")
    dev = depth_norm.device
    _check(depth_norm, "depth_norm", (N, H, W))
    Hc, Wc = _map_shape(colors, "colors", 3)[1:]
    _check(colors, "colors", (N, Hc, Wc, 3), dev)
    uv = [pixel_models.uv_p, pixel_models.uv_q, pixel_models.uv_r]
    for t, name in zip(uv, ("uv_p", "uv_q", "uv_r")):
        _check(t, name, (N, H, W, 2), dev)
    out = torch.empty((N, H, W, 3), dtype=torch.float32, device=dev)
    _launch("lab", dev, "rgbd_pre_lab", colors.data_ptr(),
            depth_norm.data_ptr(), *(t.data_ptr() for t in uv),
            out.data_ptr(), float(z_far), N, H, W, Hc, Wc)
    return out


def depth2_cuda(depth_m: torch.Tensor, bbox_min: torch.Tensor,
                bbox_max: torch.Tensor, depth_limits: torch.Tensor, bf_sums,
                pixel_models) -> torch.Tensor:
    """ops/preprocess.py bilateral_lab_plain on the pixel models in one
    launch: (N, H, W) metric depth, the (3,) box, (N, 2) [near, far] and
    bilateral13's (sum w*s, sum w, sum gauss_range) or None (filter off)
    -> (N, H, W, 2) [normalized depth, range confidence], 0 outside the
    box."""
    N, H, W = _map_shape(depth_m, "depth_m")
    dev = depth_m.device
    _check(depth_m, "depth_m", (N, H, W))
    _check(depth_limits, "depth_limits", (N, 2), dev)
    _check(bbox_min, "bbox_min", (3,), dev)
    _check(bbox_max, "bbox_max", (3,), dev)
    rays = _check_rays(pixel_models, (N, H, W), dev)
    sums = [None] * 3
    if bf_sums is not None:
        sums = list(bf_sums)
        if len(sums) != 3:
            raise ValueError("bf_sums must be bilateral13's three sums")
        for t, name in zip(sums, ("depth_bf", "w", "w_range")):
            _check(t, name, (N, H, W), dev)
    out = torch.empty((N, H, W, 2), dtype=torch.float32, device=dev)
    _launch("depth2", dev, "rgbd_pre_depth2", depth_m.data_ptr(),
            depth_limits.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
            *(t.data_ptr() for t in rays),
            *(None if t is None else t.data_ptr() for t in sums),
            out.data_ptr(), N, H, W)
    return out


def boundary_cuda(depth2: torch.Tensor, lab: torch.Tensor,
                  refine: bool = True):
    """ops/preprocess.py boundary_plain in one launch: (N, H, W, 2) depth2 +
    (N, H, W, 3) LAB -> ((N, H, W, 2) depth2 with the boundary flags, (N,
    H, W) silhouette)."""
    N, H, W = _map_shape(depth2, "depth2", 2)
    dev = depth2.device
    _check(depth2, "depth2", (N, H, W, 2))
    _check(lab, "lab", (N, H, W, 3), dev)
    out = torch.empty_like(depth2)
    sil = torch.empty((N, H, W), dtype=torch.float32, device=dev)
    _launch("boundary", dev, "rgbd_pre_boundary", depth2.data_ptr(),
            lab.data_ptr(), out.data_ptr(), sil.data_ptr(), int(bool(refine)),
            N, H, W)
    return out, sil


def normals_cuda(depth2: torch.Tensor, pixel_models) -> torch.Tensor:
    """ops/preprocess.py normals_plain on the pixel models in one launch:
    (N, H, W, 2) depth2 -> (N, H, W, 3) world-space unit normals (0 where
    the depth is not in (0, 1))."""
    N, H, W = _map_shape(depth2, "depth2", 2)
    dev = depth2.device
    _check(depth2, "depth2", (N, H, W, 2))
    rays = _check_rays(pixel_models, (N, H, W), dev)
    out = torch.empty((N, H, W, 3), dtype=torch.float32, device=dev)
    _launch("normals", dev, "rgbd_pre_normals", depth2.data_ptr(),
            *(t.data_ptr() for t in rays), out.data_ptr(), N, H, W)
    return out


def quality_cuda(depth2: torch.Tensor, normal: torch.Tensor,
                 camera_positions: torch.Tensor, q_sums,
                 pixel_models) -> torch.Tensor:
    """ops/preprocess.py quality_plain on the pixel models in one launch:
    (N, H, W, 2) depth2, (N, H, W, 3) normals, (N, 3) camera positions and
    quality13's (border count, range-weight sum) -> (N, H, W) fusion
    weights."""
    N, H, W = _map_shape(depth2, "depth2", 2)
    dev = depth2.device
    _check(depth2, "depth2", (N, H, W, 2))
    _check(normal, "normal", (N, H, W, 3), dev)
    _check(camera_positions, "camera_positions", (N, 3), dev)
    sums = list(q_sums)
    if len(sums) != 2:
        raise ValueError("q_sums must be quality13's two sums")
    for t, name in zip(sums, ("border", "w_range")):
        _check(t, name, (N, H, W), dev)
    rays = _check_rays(pixel_models, (N, H, W), dev)
    out = torch.empty((N, H, W), dtype=torch.float32, device=dev)
    _launch("quality", dev, "rgbd_pre_quality", depth2.data_ptr(),
            normal.data_ptr(), camera_positions.data_ptr(),
            *(t.data_ptr() for t in sums), *(t.data_ptr() for t in rays),
            out.data_ptr(), N, H, W)
    return out
