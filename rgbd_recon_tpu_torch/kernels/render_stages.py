"""Launch wrappers of csrc/render_stages.cu (the render's block stages: the
interval scan, the block set-up, the bracket, the hit gather and the
image assembly, one launch each)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.render_stages import NUM_COUNTS
from . import LAUNCHES
from ._build import check, library

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MAX_ENTRIES = 2 ** 31


class RenderParams(ctypes.Structure):
    """csrc/render_stages.cu RenderParams, field for field."""

    _fields_ = [
        *[(k, _I) for k in ("H", "W", "ds", "Hb", "Wb", "NB", "B2", "sc",
                            "Hs", "Ws", "n_scan", "Z", "Y", "X", "brick_vox",
                            "Bz", "By", "Bx", "per_block")],
        ("inv_W", _F), ("inv_H", _F), ("tan_half", _F), ("aspect", _F),
        ("inv_bbox", _F * 3),
        *[(k, _F) for k in ("inv_Z", "inv_Y", "inv_X", "inv_nscan1",
                            "step_len", "brick_norm", "pad", "bracket_max",
                            "lo_gap", "margin")],
        ("eye", _P), ("rot", _P),
        ("occ", _P), ("bsafe", _P), ("scan5", _P), ("counts", _P),
        ("count_slot", _I),
        ("blk", _P), ("s_end", _P), ("bflags", _P), ("grid", _P),
        ("blk_idx", _P), ("capB", _I), ("ray8", _P),
        ("st8", _P), ("hit_idx", _P), ("capH", _I), ("R", _I),
        ("hrows", _P), ("hpos", _P), ("live", _P),
        ("blk_slot", _P), ("hit_slot", _P), ("rgba_h", _P), ("depth_h", _P),
        ("planes", _P), ("depth", _P), ("hit", _P), ("num", _P),
        ("overflow", _P), ("caps", _I * NUM_COUNTS), ("sms", _I),
    ]


_size_checked = []


def _lib():
    """The library, once its parameter block is checked against this
    mirror."""
    lib = library()
    if not _size_checked:
        size = ctypes.c_int()
        lib.rgbd_render_params_size(ctypes.byref(size))
        if size.value != ctypes.sizeof(RenderParams):
            raise RuntimeError(f"csrc/render_stages.cu RenderParams of "
                               f"{size.value} bytes, the wrapper's "
                               f"{ctypes.sizeof(RenderParams)}")
        _size_checked.append(True)
    return lib


def _f32(x: float) -> float:
    return float(np.float32(x))


def _inv(x: float) -> float:
    """f32(1 / x) with the reciprocal in double: PyTorch's x / s for a
    Python number s on the card."""
    return _f32(1.0 / x)


@functools.lru_cache(maxsize=16)
def _geometry(g) -> bytes:
    """The geometry fields of the parameter block of ``g`` (a
    ops.render_stages.BlockGeometry)."""
    p = RenderParams()
    Z, Y, X = g.vol_shape
    for k, v in dict(H=g.H, W=g.W, ds=g.ds, Hb=g.Hb, Wb=g.Wb, NB=g.NB,
                     B2=g.B2, sc=g.sc, Hs=g.Hs, Ws=g.Ws, n_scan=g.n_scan,
                     Z=Z, Y=Y, X=X, brick_vox=g.brick_vox,
                     per_block=int(g.per_block)).items():
        setattr(p, k, int(v))
    p.inv_W, p.inv_H = _inv(g.W), _inv(g.H)
    p.tan_half, p.aspect = _f32(g.tan_half), _f32(g.aspect)
    p.inv_bbox = (_F * 3)(*[_inv(float(s)) for s in g.bbox_size])
    p.inv_Z, p.inv_Y, p.inv_X = _inv(Z), _inv(Y), _inv(X)
    p.inv_nscan1 = _inv(g.n_scan - 1)
    p.step_len = _f32(g.step_len)
    p.brick_norm = _f32(g.brick_norm)
    p.pad = _f32(g.pad)
    p.bracket_max = _f32(g.bracket_max_steps * g.sd)
    p.lo_gap = _f32(2.0 * g.brick_norm + g.pad)
    p.margin = _f32(g.bracket_margin_steps * g.sd)
    return bytes(p)


def _params(g) -> RenderParams:
    return RenderParams.from_buffer_copy(_geometry(g))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once a device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scan_params(g, occ_shape, dev) -> RenderParams:
    p = _params(g)
    p.Bz, p.By, p.Bx = occ_shape
    p.sms = _sm_count(dev.index if dev.index is not None
                      else torch.cuda.current_device())
    return p


def scan_plan(g, occ_shape, dev) -> dict:
    """The scan's launch on ``dev`` for the brick grid ``occ_shape``
    (csrc/render_stages.cu rgbd_render_scan_plan): blocks, threads, lanes
    a ray, dynamic shared bytes, and whether the brick grid is staged in
    shared memory."""
    out = (_I * 5)()
    _lib().rgbd_render_scan_plan(ctypes.byref(_scan_params(g, occ_shape,
                                                           dev)), out)
    return dict(blocks=out[0], threads=out[1], lanes=out[2],
                shared_bytes=out[3], staged=bool(out[4]))


def _check(x, name, dtype, shape, dev):
    """``x``: a contiguous ``dtype`` tensor of ``shape`` on the CUDA device
    ``dev`` (``dev`` None: any CUDA device). Returns its device."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"{name} must be a CUDA tensor, got {where}")
    if dev is not None and x.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.numel() >= _MAX_ENTRIES:
        raise ValueError(f"{name}: {x.numel()} entries, at most 2^31 - 1")
    return x.device


def _camera(p, cam, dev):
    _check(cam.eye_vol, "cam.eye_vol", torch.float32, (3,), dev)
    _check(cam.rot, "cam.rot", torch.float32, (3, 3), dev)
    p.eye, p.rot = cam.eye_vol.data_ptr(), cam.rot.data_ptr()


def _counts(counts, dev):
    if (not isinstance(counts, torch.Tensor) or counts.dtype != torch.int32
            or tuple(counts.shape) != (NUM_COUNTS,) or counts.device != dev
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({NUM_COUNTS},) "
                         f"int32 tensor on {dev}")
    return counts.data_ptr()


def _launch(name: str, entry: str, p: RenderParams, dev) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(ctypes.byref(p),
                                  torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    LAUNCHES[name] += 1


def scan_cuda(g, occ, bsafe, cam, counts, count_slot):
    """:func:`ops.render_stages.scan_plain` in one launch."""
    if occ.dim() != 3:
        raise ValueError("occ must be a (Bz, By, Bx) tensor")
    dev = _check(occ, "occ", torch.bool, occ.shape, None)
    _check(bsafe, "bsafe", torch.float32, occ.shape, dev)
    if not 0 <= count_slot < NUM_COUNTS:
        raise ValueError(f"count_slot must be in [0, {NUM_COUNTS}), got "
                         f"{count_slot}")
    p = _scan_params(g, occ.shape, dev)
    _camera(p, cam, dev)
    scan5 = torch.empty((5, g.Hs, g.Ws), dtype=torch.float32, device=dev)
    p.occ, p.bsafe, p.scan5 = occ.data_ptr(), bsafe.data_ptr(), \
        scan5.data_ptr()
    p.counts, p.count_slot = _counts(counts, dev), count_slot
    _launch("scan", "rgbd_render_scan", p, dev)
    return scan5


def block_setup_plan(g) -> dict:
    """The set-up's launch for geometry ``g`` (csrc/render_stages.cu
    rgbd_render_block_setup_plan): tiles across and down, the thread
    block (the block's column and row in its tile) and its static shared
    bytes."""
    out = (_I * 5)()
    _lib().rgbd_render_block_setup_plan(ctypes.byref(_params(g)), out)
    return dict(blocks=(out[0], out[1]), threads=(out[2], out[3]),
                shared_bytes=out[4])


def block_setup_cuda(g, scan5, cam):
    """:func:`ops.render_stages.block_setup_plain` in one launch. Any scan
    stride sc >= 1 (a tile's cells fit its staging at every one); another
    raises ValueError."""
    if g.sc < 1:
        raise ValueError(f"block_setup: scan stride {g.sc}, at least 1")
    dev = _check(scan5, "scan5", torch.float32, (5, g.Hs, g.Ws), None)
    p = _params(g)
    _camera(p, cam, dev)
    NB = g.NB
    blk = torch.empty((NB, 8), dtype=torch.float32, device=dev)
    s_end = torch.empty(NB, dtype=torch.float32, device=dev)
    flags = torch.empty(NB, dtype=torch.uint8, device=dev)
    grid = torch.empty((3, NB), dtype=torch.float32, device=dev)
    if blk.data_ptr() % 16:
        raise RuntimeError("block_setup: the block rows are not 16-byte "
                           "aligned")
    p.scan5, p.blk, p.s_end = scan5.data_ptr(), blk.data_ptr(), \
        s_end.data_ptr()
    p.bflags, p.grid = flags.data_ptr(), grid.data_ptr()
    _launch("block_setup", "rgbd_render_block_setup", p, dev)
    return blk, s_end, flags, grid


# the bracket's thread block holds a block slot's B2 = ds^2 rays
# (csrc/render_stages.cu BRACKET_MAX_B2)
BRACKET_MAX_B2 = 1024


def bracket_plan(g, capB: int) -> dict:
    """The bracket's launch for ``capB`` block slots of geometry ``g``
    (csrc/render_stages.cu rgbd_render_bracket_plan): blocks, the thread
    block (the ray's column, its row, the slot) and its dynamic shared
    bytes."""
    p = _params(g)
    p.capB = capB
    out = (_I * 5)()
    _lib().rgbd_render_bracket_plan(ctypes.byref(p), out)
    return dict(blocks=out[0], threads=(out[1], out[2], out[3]),
                shared_bytes=out[4])


def bracket_cuda(g, grid, blk, s_end, flags, blk_idx, cam):
    """:func:`ops.render_stages.bracket_plain` in one launch."""
    if g.B2 > BRACKET_MAX_B2:
        raise ValueError(f"bracket: {g.B2} rays a block (ds {g.ds}), at most "
                         f"{BRACKET_MAX_B2}")
    NB = g.NB
    dev = _check(grid, "grid", torch.float32, (3, NB), None)
    _check(blk, "blk", torch.float32, (NB, 8), dev)
    _check(s_end, "s_end", torch.float32, (NB,), dev)
    _check(flags, "flags", torch.uint8, (NB,), dev)
    if blk_idx.dim() != 1:
        raise ValueError("blk_idx must be a (capB,) tensor")
    _check(blk_idx, "blk_idx", torch.int64, blk_idx.shape, dev)
    capB = blk_idx.shape[0]
    R = capB * g.B2
    if R >= _MAX_ENTRIES // 8:
        raise ValueError(f"{R} rays: the rows need fewer than 2^31 entries")
    p = _params(g)
    _camera(p, cam, dev)
    ray8 = torch.empty((R, 8), dtype=torch.float32, device=dev)
    if ray8.data_ptr() % 16:
        raise RuntimeError("bracket: the ray rows are not 16-byte aligned")
    p.grid, p.blk, p.s_end, p.bflags = (grid.data_ptr(), blk.data_ptr(),
                                        s_end.data_ptr(), flags.data_ptr())
    p.blk_idx, p.capB, p.ray8 = blk_idx.data_ptr(), capB, ray8.data_ptr()
    _launch("bracket", "rgbd_render_bracket", p, dev)
    return ray8


def hit_gather_plan(capH: int) -> dict:
    """The hit gather's launch for ``capH`` hit slots (csrc/render_stages.cu
    rgbd_render_hit_gather_plan): blocks and threads (a slot each)."""
    p = RenderParams()
    p.capH = capH
    out = (_I * 2)()
    _lib().rgbd_render_hit_gather_plan(ctypes.byref(p), out)
    return dict(blocks=out[0], threads=out[1])


def hit_gather_cuda(ray8, st8, hit_idx):
    """:func:`ops.render_stages.hit_gather_plain` in one launch. A row is
    read as 16-byte words, so ``ray8`` and ``st8`` must start on 16 bytes;
    another raises ValueError."""
    if ray8.dim() != 2 or hit_idx.dim() != 1:
        raise ValueError("ray8 must be (R, 8), hit_idx (capH,)")
    R = ray8.shape[0]
    dev = _check(ray8, "ray8", torch.float32, (R, 8), None)
    _check(st8, "st8", torch.float32, (R, 8), dev)
    _check(hit_idx, "hit_idx", torch.int64, hit_idx.shape, dev)
    if R == 0:
        raise ValueError("hit_gather needs at least one ray row")
    for name, x in (("ray8", ray8), ("st8", st8)):
        if x.data_ptr() % 16:
            raise ValueError(f"hit_gather: {name} must start on 16 bytes")
    capH = hit_idx.shape[0]
    rows = torch.empty((capH, 8), dtype=torch.float32, device=dev)
    pos = torch.empty((capH, 3), dtype=torch.float32, device=dev)
    live = torch.empty(capH, dtype=torch.bool, device=dev)
    if capH == 0:
        return rows, pos, live
    if rows.data_ptr() % 16:
        raise RuntimeError("hit_gather: the hit rows are not 16-byte aligned")
    p = RenderParams()
    p.ray8, p.st8, p.hit_idx = ray8.data_ptr(), st8.data_ptr(), \
        hit_idx.data_ptr()
    p.capH, p.R = capH, R
    p.hrows, p.hpos, p.live = rows.data_ptr(), pos.data_ptr(), \
        live.data_ptr()
    _launch("hit_gather", "rgbd_render_hit_gather", p, dev)
    return rows, pos, live


def compose_cuda(g, blk_slot, hit_slot, st8, rgba_h, depth_h, counts, caps):
    """:func:`ops.render_stages.compose_plain` in one launch."""
    if st8.dim() != 2 or rgba_h.dim() != 2:
        raise ValueError("st8 must be (R, 8), rgba_h (capH, 4)")
    R, capH = st8.shape[0], rgba_h.shape[0]
    dev = _check(st8, "st8", torch.float32, (R, 8), None)
    _check(blk_slot, "blk_slot", torch.int32, (g.NB,), dev)
    _check(hit_slot, "hit_slot", torch.int32, (R,), dev)
    _check(rgba_h, "rgba_h", torch.float32, (capH, 4), dev)
    _check(depth_h, "depth_h", torch.float32, (capH,), dev)
    if len(caps) != NUM_COUNTS:
        raise ValueError(f"caps must hold {NUM_COUNTS} capacities")
    p = _params(g)
    H, W = g.H, g.W
    planes = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    hit = torch.empty((H, W), dtype=torch.bool, device=dev)
    num = torch.empty((H, W), dtype=torch.int32, device=dev)
    overflow = torch.empty(4, dtype=torch.int32, device=dev)
    p.blk_slot, p.hit_slot, p.st8 = (blk_slot.data_ptr(),
                                     hit_slot.data_ptr(), st8.data_ptr())
    p.rgba_h, p.depth_h = rgba_h.data_ptr(), depth_h.data_ptr()
    p.planes, p.depth, p.hit, p.num = (planes.data_ptr(), depth.data_ptr(),
                                       hit.data_ptr(), num.data_ptr())
    p.counts, p.overflow = _counts(counts, dev), overflow.data_ptr()
    p.caps = (_I * NUM_COUNTS)(*[int(c) for c in caps])
    _launch("compose", "rgbd_render_compose", p, dev)
    return planes, depth, hit, num, overflow
