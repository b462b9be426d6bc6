"""Launch wrappers of csrc/hits.cu (the render's per-hit stage: one refine
launch, one shade launch, one thread a hit)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from ._build import check, library

_TABLE_TYPES = (torch.bfloat16, torch.float32)
# flat indices of a table or map stay below 2^31 elements a sensor; the hit
# count is an int in the kernel
_MAX_ENTRIES = 2 ** 31

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
_REFINE_IN = 11


class RefineParams(ctypes.Structure):
    """csrc/hits.cu RefineParams, field for field."""

    _fields_ = [
        ("table", _P), ("slots", _P), ("table_f32", _I), ("oct", _I),
        ("D", _I), ("H", _I), ("W", _I), ("brick_vox", _I),
        ("widen_k", _I), ("floor_on", _I), ("neg_limit", _F),
        ("floor", _F), ("widen_lo", _F), ("widen_span", _F),
        ("inv_km1", _F), ("ins", _P * _REFINE_IN),
        ("stride", _LL * _REFINE_IN), ("hit", _P), ("hit_stride", _LL),
        ("out", _P), ("n", _I), ("rows8", _P),
    ]


class ShadeParams(ctypes.Structure):
    """csrc/hits.cu ShadeParams, field for field."""

    _fields_ = [
        ("hit", _P), ("hit_stride", _LL), ("pos", _P * 3),
        ("pos_stride", _LL * 3), ("n", _I),
        ("normal", _I), ("table", _P), ("slots", _P), ("table_f32", _I),
        ("D", _I), ("H", _I), ("W", _I), ("brick_vox", _I),
        ("floor_on", _I), ("floor", _F), ("sd", _F),
        ("blend", _I), ("dq_bilinear", _I), ("N", _I),
        ("color", _P), ("color_stride", _LL * 4), ("Hc", _I), ("Wc", _I),
        ("depth", _P), ("depth_stride", _LL * 3),
        ("quality", _P), ("quality_stride", _LL * 3), ("Hd", _I),
        ("Wd", _I),
        ("uv_num", _P), ("uv_off", _P), ("uv_den", _P), ("d_lin", _P),
        ("d_off", _P), ("cuv_num", _P), ("cuv_off", _P), ("cuv_den", _P),
        ("cv_inv", _P), ("iD", _I), ("iH", _I), ("iW", _I),
        ("cv_uv", _P), ("uD", _I), ("uH", _I), ("uW", _I),
        ("limit", _F), ("shade_mode", _I),
        ("eye", _P), ("rot", _P), ("bbox_min", _P), ("bbox_size", _F * 3),
        ("near_clamp", _F), ("inv_near", _F), ("depth_scale", _F),
        ("rgba", _P), ("depth_win", _P),
    ]


# csrc/hits.cu's normal and blend codes
_NORMAL = {"oct": 0, "nearest": 1, "trilinear": 2}
_BLEND = {"analytic": 0, "volume": 1, "volume_fast": 2}

_sizes_checked = []


def _lib():
    """The library, once its parameter blocks are checked against these
    mirrors."""
    lib = library()
    if not _sizes_checked:
        sizes = (ctypes.c_int * 2)()
        lib.rgbd_hit_params_sizes(sizes)
        want = (ctypes.sizeof(RefineParams), ctypes.sizeof(ShadeParams))
        if tuple(sizes) != want:
            raise RuntimeError(f"csrc/hits.cu parameter blocks of "
                               f"{tuple(sizes)} bytes, the wrapper's {want}")
        _sizes_checked.append(True)
    return lib


def _f32(x: float) -> float:
    return float(np.float32(x))


def _per_hit(xs, shape, dev, what):
    """1-D views of the f32 per-hit tensors ``xs``, broadcast to ``shape``
    (no copy for 1-D inputs, column views and contiguous tensors)."""
    out = []
    for x in xs:
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
                or x.device != dev):
            raise ValueError(f"{what}: the per-hit inputs must be float32 "
                             f"tensors on {dev}")
        out.append(torch.broadcast_to(x, shape).reshape(-1))
    return out


def _hit_mask(hit, shape, dev, what):
    if (not isinstance(hit, torch.Tensor) or hit.dtype != torch.bool
            or hit.device != dev):
        raise ValueError(f"{what}: hit must be a bool tensor on {dev}")
    return torch.broadcast_to(hit, shape).reshape(-1)


def _hit_positions(hit_pos, what):
    """(shape, device, the three columns as 1-D views) of the f32 (..., 3)
    hit positions on a CUDA device."""
    if (not isinstance(hit_pos, torch.Tensor)
            or hit_pos.dtype != torch.float32 or hit_pos.dim() < 1
            or hit_pos.shape[-1] != 3):
        raise ValueError(f"{what}: hit_pos must be a float32 (..., 3) "
                         "tensor")
    shape = hit_pos.shape[:-1]
    n = int(np.prod(shape, dtype=np.int64))
    if n >= _MAX_ENTRIES:
        raise ValueError(f"{what}: at most 2^31 - 1 hits, got {n}")
    if hit_pos.device.type != "cuda":
        raise ValueError(f"{what}: hit_pos must be a CUDA tensor, got "
                         f"{hit_pos.device}")
    cols = [hit_pos[..., k].reshape(-1) for k in range(3)]
    return shape, hit_pos.device, cols


def _check_table(table, dev, what, ndim):
    if (not isinstance(table, torch.Tensor) or table.dtype not in _TABLE_TYPES
            or table.dim() != ndim or not table.is_contiguous()
            or table.device != dev):
        raise ValueError(f"{what}: the table must be a contiguous bf16 or "
                         f"f32 tensor of {ndim} dims on {dev}")
    if table.numel() >= _MAX_ENTRIES:
        raise ValueError(f"{what}: the table must hold fewer than 2^31 "
                         f"entries, got {table.numel()}")


def _check_oct(oct, dev, what):
    _check_table(oct.rows, dev, what, 2)
    D, H, W = oct.shape
    v = oct.brick_vox
    s = oct.slots
    if (oct.rows.shape[1] != 8 or v < 1 or D % v or H % v or W % v
            or s.dtype != torch.int32 or s.device != dev
            or not s.is_contiguous()
            or s.numel() != (D // v) * (H // v) * (W // v)):
        raise ValueError(f"{what}: an oct table of (M, 8) rows and one int32 "
                         "slot a brick of a brick-aligned volume")
    # a row is one 16-byte load (two in f32)
    if oct.rows.data_ptr() % 16:
        raise ValueError(f"{what}: the oct rows must start on 16 bytes")


def input_rows(ins) -> int:
    """The address of the (n, 8) f32 rows whose columns 0-7 are the 8
    per-hit inputs ``ins`` (1-D views: pos0 x y z, dir x y z, lo_t, hi_t),
    where the rows are row-major and start on 16 bytes (the render's hit
    rows: csrc/hits.cu reads a row as two float4); else 0, the kernel's
    strided scalar path."""
    base = ins[0].data_ptr()
    if base % 16 or ins[0].dim() != 1:
        return 0
    for k, x in enumerate(ins[:8]):
        if x.data_ptr() != base + 4 * k or (x.numel() > 1
                                            and x.stride(0) != 8):
            return 0
    return base


def refine_cuda(pos0, dn, lo_t, hi_t, hit, hit_pos, limit: float, oct=None,
                table=None, clamp_floor=None, widen_steps: float = 0.0,
                widen_samples: int = 6) -> torch.Tensor:
    """:func:`ops.hits.refine_hits_plain` in one launch: same arguments,
    the same contiguous (..., 3) float32 result, bit for bit. The per-hit
    inputs are f32 CUDA tensors (``hit`` bool) of one broadcast shape, any
    strides; the scalars are rounded to f32 here as the twin's torch ops
    round them on the card."""
    what = "hit_refine"
    shape, dev, cols = _hit_positions(hit_pos, what)
    ins = _per_hit([*pos0, *dn, lo_t, hi_t], shape, dev, what) + cols
    mask = _hit_mask(hit, shape, dev, what)
    p = RefineParams()
    sd = np.float32(limit) * np.float32(0.5)
    if oct is not None:
        _check_oct(oct, dev, what)
        tab = oct.rows
        p.oct = 1
        p.slots = oct.slots.data_ptr()
        p.brick_vox = oct.brick_vox
        p.D, p.H, p.W = oct.shape
        if widen_steps > 0.0 and widen_samples >= 3:
            K = int(widen_samples)
            p.widen_k = K
            # the twin's lo_t - widen_steps * sd and the span's 2.0 *
            # widen_steps * sd: Python products, rounded to f32
            p.widen_lo = _f32(widen_steps * float(sd))
            p.widen_span = _f32(2.0 * widen_steps * float(sd))
            # x / (K - 1) on the card: x times the f32 reciprocal
            p.inv_km1 = float(np.float32(1.0) / np.float32(K - 1))
    elif table is not None:
        _check_table(table, dev, what, 3)
        tab = table
        p.D, p.H, p.W = table.shape
        if clamp_floor is not None:
            p.floor_on = 1
            p.floor = _f32(clamp_floor)
    else:
        raise ValueError(f"{what}: needs an oct table or a march table")
    p.table = tab.data_ptr()
    p.table_f32 = int(tab.dtype == torch.float32)
    p.neg_limit = _f32(-limit)
    for k, x in enumerate(ins):
        p.ins[k] = x.data_ptr()
        p.stride[k] = x.stride(0)
    p.rows8 = input_rows(ins)
    p.hit = mask.data_ptr()
    p.hit_stride = mask.stride(0)
    out = torch.empty(tuple(shape) + (3,), dtype=torch.float32, device=dev)
    p.out = out.data_ptr()
    p.n = mask.numel()
    if p.n == 0:
        return out
    lib = _lib()
    # launch on the tensors' device (the current one may be another)
    with torch.cuda.device(dev):
        err = lib.rgbd_hit_refine(ctypes.byref(p),
                                  torch.cuda.current_stream(dev).cuda_stream)
    check(err, what)
    LAUNCHES["hit_refine"] += 1
    return out


def refine_plan(n: int) -> dict:
    """The refine's launch for ``n`` hits (csrc/hits.cu
    rgbd_hit_refine_plan): blocks, threads, lanes a hit (one), and the
    widened bracket's samples a chunk (a round of loads)."""
    out = (ctypes.c_int * 4)()
    _lib().rgbd_hit_refine_plan(int(n), out)
    return dict(blocks=out[0], threads=out[1], lanes=out[2], chunk=out[3])


def shade_plan(n: int) -> dict:
    """The shade's launch for ``n`` hits (csrc/hits.cu
    rgbd_hit_shade_plan): blocks, threads, lanes a hit (one)."""
    out = (ctypes.c_int * 3)()
    _lib().rgbd_hit_shade_plan(int(n), out)
    return dict(blocks=out[0], threads=out[1], lanes=out[2])


def _small(t, dev, what, name):
    """The pointer of a contiguous f32 tensor on ``dev``."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous float32 "
                         f"tensor on {dev}")
    return t.data_ptr()


def _map(t, dev, what, name, ndim):
    """(pointer, element strides) of an f32 map of ``ndim`` dims on
    ``dev``, any strides (the kernel's offsets are 64-bit)."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.dim() != ndim or t.device != dev):
        raise ValueError(f"{what}: {name} must be a float32 tensor of "
                         f"{ndim} dims on {dev}")
    return t.data_ptr(), t.stride()


def shade_cuda(hit, hit_pos, color, depth, quality, *, normal: str,
               blend: str, shade_mode: int, limit: float, eye, rot,
               bbox_min, bbox_size, near: float, far: float, table=None,
               oct=None, clamp_floor=None, dq_bilinear: bool = False,
               proj_models=None, cv_xyz_inv=None, cv_uv=None):
    """The shade of csrc/hits.cu in one launch, as
    :func:`ops.hits.shade_hits_plain` draws it (``ops.hits
    .shade_kernel_args`` resolves a config into these arguments): the
    contiguous (rgba (..., 4), window depth (...)) float32 results.

    ``normal``: "oct" (the cell's analytic gradient of ``oct``), "nearest"
    or "trilinear" (the central difference of ``table``, clamped from
    below by ``clamp_floor`` when one is given). ``blend``: "analytic"
    (``proj_models``, depth and quality taps bilinear if ``dq_bilinear``),
    "volume" (trilinear lookups of ``cv_xyz_inv`` and ``cv_uv``) or
    "volume_fast" (their nearest lookups). ``shade_mode`` 0 (textured), 1
    (Blinn-Phong) or 2 (normals). The (N, H, W, 3) colour map is read as
    f32 and rounded to bf16 in the kernel, the (N, H, W) depth and quality
    planes through their strides; ``eye``, ``rot`` and ``bbox_min`` are
    the camera's and the box's device tensors, ``bbox_size`` three
    floats."""
    what = "hit_shade"
    if normal not in _NORMAL or blend not in _BLEND:
        raise ValueError(f"{what}: normal {normal!r} of {tuple(_NORMAL)}, "
                         f"blend {blend!r} of {tuple(_BLEND)}")
    if shade_mode not in (0, 1, 2):
        raise ValueError(f"{what}: shade modes 0-2, got {shade_mode}")
    shape, dev, cols = _hit_positions(hit_pos, what)
    mask = _hit_mask(hit, shape, dev, what)
    p = ShadeParams()
    p.hit = mask.data_ptr()
    p.hit_stride = mask.stride(0)
    for k, x in enumerate(cols):
        p.pos[k] = x.data_ptr()
        p.pos_stride[k] = x.stride(0)
    p.n = mask.numel()
    # the normal
    p.normal = _NORMAL[normal]
    if normal == "oct":
        if oct is None:
            raise ValueError(f"{what}: the oct normal needs an oct table")
        _check_oct(oct, dev, what)
        tab = oct.rows
        p.slots = oct.slots.data_ptr()
        p.brick_vox = oct.brick_vox
        p.D, p.H, p.W = oct.shape
    else:
        _check_table(table, dev, what, 3)
        tab = table
        p.D, p.H, p.W = table.shape
        if clamp_floor is not None:
            p.floor_on = 1
            p.floor = _f32(clamp_floor)
        p.sd = float(np.float32(limit) * np.float32(0.5))
    p.table = tab.data_ptr()
    p.table_f32 = int(tab.dtype == torch.float32)
    # the blend
    p.color, cs = _map(color, dev, what, "the colour map", 4)
    p.color_stride[:] = cs
    p.N, p.Hc, p.Wc = color.shape[:3]
    p.depth, ds = _map(depth, dev, what, "the depth map", 3)
    p.depth_stride[:] = ds
    p.quality, qs = _map(quality, dev, what, "the quality map", 3)
    p.quality_stride[:] = qs
    p.Hd, p.Wd = depth.shape[1:]
    if depth.shape[0] != p.N or quality.shape != depth.shape:
        raise ValueError(f"{what}: colour, depth and quality maps of "
                         "different sensors or sizes")
    p.blend = _BLEND[blend]
    if blend == "analytic":
        if proj_models is None:
            raise ValueError(f"{what}: the analytic blend needs the "
                             "projection models")
        p.dq_bilinear = int(dq_bilinear)
        for name in ("uv_num", "uv_off", "uv_den", "d_lin", "d_off",
                     "cuv_num", "cuv_off", "cuv_den"):
            t = getattr(proj_models, name)
            setattr(p, name, _small(t, dev, what, f"proj_models.{name}"))
            if t.shape[0] != p.N:
                raise ValueError(f"{what}: proj_models.{name} has "
                                 f"{t.shape[0]} sensors, the maps {p.N}")
    else:
        p.cv_inv = _small(cv_xyz_inv, dev, what, "cv_xyz_inv")
        p.cv_uv = _small(cv_uv, dev, what, "cv_uv")
        # a tap's channels are one float4 (cv_inv) or float2 (cv_uv) load
        if p.cv_inv % 16 or p.cv_uv % 8:
            raise ValueError(f"{what}: cv_xyz_inv must start on 16 bytes and "
                             "cv_uv on 8 (a tap is one vector load)")
        if (cv_xyz_inv.dim() != 5 or cv_xyz_inv.shape[0] != p.N
                or cv_xyz_inv.shape[4] != 4 or cv_uv.dim() != 5
                or cv_uv.shape[0] != p.N or cv_uv.shape[4] != 2):
            raise ValueError(f"{what}: calibration volumes (N, D, H, W, 4) "
                             "and (N, D, H, W, 2) of the maps' sensors")
        p.iD, p.iH, p.iW = cv_xyz_inv.shape[1:4]
        p.uD, p.uH, p.uW = cv_uv.shape[1:4]
    p.limit = _f32(limit)
    # shading and the window depth
    p.shade_mode = int(shade_mode)
    p.eye = _small(eye, dev, what, "eye")
    p.rot = _small(rot, dev, what, "rot")
    p.bbox_min = _small(bbox_min, dev, what, "bbox_min")
    p.bbox_size[:] = [_f32(x) for x in bbox_size]
    p.near_clamp = _f32(near * 1.001)
    p.inv_near = _f32(1.0 / near)
    # x / s for a Python s on the card: x times the f32 reciprocal
    p.depth_scale = float(np.float32(1.0)
                          / np.float32(1.0 / near - 1.0 / far))
    rgba = torch.empty(tuple(shape) + (4,), dtype=torch.float32, device=dev)
    depth_win = torch.empty(shape, dtype=torch.float32, device=dev)
    p.rgba = rgba.data_ptr()
    p.depth_win = depth_win.data_ptr()
    if p.n == 0:
        return rgba, depth_win
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rgbd_hit_shade(ctypes.byref(p),
                                 torch.cuda.current_stream(dev).cuda_stream)
    check(err, what)
    LAUNCHES["hit_shade"] += 1
    return rgba, depth_win
