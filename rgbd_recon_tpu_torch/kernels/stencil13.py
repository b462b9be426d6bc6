"""Launch wrappers of csrc/stencil13.cu (13x13 bilateral + quality census)."""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, library


def _check_map(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name} must be (N, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bilateral13_cuda(depth_m: torch.Tensor, depth_limits: torch.Tensor):
    """(N, H, W) metric depth + (N, 2) [near, far] -> (sum w*s, sum w,
    sum gauss_range), each (N, H, W) f32."""
    _check_map(depth_m, "depth_m")
    N, H, W = depth_m.shape
    if (depth_limits.device != depth_m.device
            or depth_limits.dtype != torch.float32
            or tuple(depth_limits.shape) != (N, 2)
            or not depth_limits.is_contiguous()):
        raise ValueError("depth_limits must be a contiguous (N, 2) float32 "
                         "tensor on the depth map's device")
    outs = [torch.empty_like(depth_m) for _ in range(3)]
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(depth_m.device):
        err = lib.rgbd_bilateral13(
            depth_m.data_ptr(), depth_limits.data_ptr(),
            *(o.data_ptr() for o in outs), N, H, W,
            torch.cuda.current_stream(depth_m.device).cuda_stream,
        )
    check(err, "bilateral13")
    LAUNCHES["bilateral13"] += 1
    return tuple(outs)


def quality13_cuda(depth_norm: torch.Tensor):
    """(N, H, W) normalized depth -> (border count, range-weight sum)."""
    _check_map(depth_norm, "depth_norm")
    N, H, W = depth_norm.shape
    outs = [torch.empty_like(depth_norm) for _ in range(2)]
    lib = library()
    # launch on the tensor's device (the current one may be another)
    with torch.cuda.device(depth_norm.device):
        err = lib.rgbd_quality13(
            depth_norm.data_ptr(), *(o.data_ptr() for o in outs), N, H, W,
            torch.cuda.current_stream(depth_norm.device).cuda_stream,
        )
    check(err, "quality13")
    LAUNCHES["quality13"] += 1
    return tuple(outs)
