"""Launch wrappers of csrc/fuse.cu (the fuse's brick marking and its
brick-compact integration, one launch each, no host sync)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from ._build import check, library

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
_MAX_ENTRIES = 2 ** 31


class MarkParams(ctypes.Structure):
    """csrc/fuse.cu MarkParams, field for field."""

    _fields_ = [
        ("depth", _P), ("ds", _LL * 3),
        ("ray_a", _P), ("sa", _LL * 4),
        ("ray_b", _P), ("sb", _LL * 4),
        ("worlds", _P), ("ws", _LL * 4),
        ("bbox_min", _P), ("counts", _P),
        *[(k, _I) for k in ("N", "H", "W", "stride", "Hs", "Ws", "bx", "by",
                            "bz", "add")],
        ("inv_brick", _F), ("brick", _F), ("border", _F),
    ]


class IntegrateParams(ctypes.Structure):
    """csrc/fuse.cu IntegrateParams, field for field."""

    _fields_ = [
        ("proj", _P), ("proj_n", _LL), ("ids", _P), ("slot", _P),
        ("depth", _P), ("ds", _LL * 3),
        ("qual", _P), ("qs", _LL * 3),
        ("sil", _P), ("ss", _LL * 3),
        ("out", _P),
        *[(k, _I) for k in ("N", "H", "W", "Z", "Y", "X", "v", "Bz", "By",
                            "Bx", "V", "bilinear", "phantom_hull",
                            "capacity")],
        ("limit", _F), ("carve", _F),
    ]


_size_checked = []


def _lib():
    """The library, once its parameter blocks are checked against these
    mirrors."""
    lib = library()
    if not _size_checked:
        sizes = (_I * 2)()
        lib.rgbd_fuse_params_sizes(sizes)
        want = (ctypes.sizeof(MarkParams), ctypes.sizeof(IntegrateParams))
        if tuple(sizes) != want:
            raise RuntimeError(f"csrc/fuse.cu parameter blocks of "
                               f"{tuple(sizes)} bytes, the wrapper's {want}")
        _size_checked.append(True)
    return lib


def _to_f32(x: float) -> float:
    return float(np.float32(x))


def mark_scalars(brick_size: float):
    """(inv_brick, brick, border) as PyTorch's CUDA launches see the plain
    version's scalars: ``(p - bbox_min) / brick_size`` as p times
    f32(1) / f32(brick_size), ``* brick_size`` by its f32, and
    ``brick_size * 0.1`` as the f32 of the double product."""
    return (float(np.float32(1.0) / np.float32(brick_size)),
            _to_f32(brick_size), _to_f32(brick_size * 0.1))


def _check_f32(t, name, dim):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 tensor")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got "
                         f"{tuple(t.shape)}")


def _on_one_card(**tensors):
    """The card all ``tensors`` lie on (checked last, so that the other
    checks run on CPU tensors too)."""
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(f"{', '.join(tensors)} must be CUDA tensors on one "
                         f"card, got {sorted(map(str, devs))}")
    return dev


def sampled_size(n: int, stride: int) -> int:
    """len(range(stride // 2, n, stride)): the samples of one axis."""
    return len(range(stride // 2, n, stride))


def _mark_params(depth, bbox_min, brick_size, brick_res, stride, ray_a,
                 ray_b, worlds):
    _check_f32(depth, "depth", 3)
    N, H, W = depth.shape
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be an int >= 1, got {stride!r}")
    Hs, Ws = sampled_size(H, stride), sampled_size(W, stride)
    _check_f32(bbox_min, "bbox_min", 1)
    if bbox_min.shape != (3,):
        raise ValueError("bbox_min must be (3,)")
    bx, by, bz = (int(r) for r in brick_res)
    if min(bx, by, bz) < 1 or bx * by * bz >= _MAX_ENTRIES:
        raise ValueError(f"brick_res {brick_res} out of range")
    if N * Hs * Ws >= _MAX_ENTRIES:
        raise ValueError("at most 2^31 - 1 sampled pixels")
    q = MarkParams()
    q.depth = depth.data_ptr()
    q.ds[:] = depth.stride()
    if worlds is not None:
        if ray_a is not None or ray_b is not None:
            raise ValueError("pass the pixel models or worlds, not both")
        _check_f32(worlds, "worlds", 4)
        if tuple(worlds.shape) != (N, Hs, Ws, 3):
            raise ValueError(f"worlds must be {(N, Hs, Ws, 3)}, got "
                             f"{tuple(worlds.shape)}")
        q.worlds = worlds.data_ptr()
        q.ws[:] = worlds.stride()
    else:
        for name, r in (("ray_a", ray_a), ("ray_b", ray_b)):
            if r is None:
                raise ValueError("pass the pixel models (ray_a, ray_b) or "
                                 "worlds")
            _check_f32(r, name, 4)
            if tuple(r.shape) != (N, H, W, 3):
                raise ValueError(f"{name} must be {(N, H, W, 3)}, got "
                                 f"{tuple(r.shape)}")
        q.ray_a, q.ray_b = ray_a.data_ptr(), ray_b.data_ptr()
        q.sa[:] = ray_a.stride()
        q.sb[:] = ray_b.stride()
    inputs = dict(depth=depth, bbox_min=bbox_min)
    inputs.update({k: t for k, t in (("ray_a", ray_a), ("ray_b", ray_b),
                                     ("worlds", worlds)) if t is not None})
    _on_one_card(**inputs)
    q.bbox_min = bbox_min.data_ptr()
    q.N, q.H, q.W, q.stride, q.Hs, q.Ws = N, H, W, stride, Hs, Ws
    q.bx, q.by, q.bz = bx, by, bz
    q.add = stride * stride
    q.inv_brick, q.brick, q.border = mark_scalars(brick_size)
    return q


def mark_plan(depth, bbox_min, brick_size, brick_res, stride, ray_a=None,
              ray_b=None, worlds=None) -> dict:
    """The launch of :func:`brick_mark_cuda` on these arguments: blocks,
    threads, dynamic shared bytes, whether the counts go through a shared
    histogram a block (else straight to global memory), and how many
    touched bins a block lists before it flushes its whole histogram."""
    q = _mark_params(depth, bbox_min, brick_size, brick_res, stride, ray_a,
                     ray_b, worlds)
    out = (_I * 5)()
    with torch.cuda.device(depth.device):
        _lib().rgbd_brick_mark_plan(ctypes.byref(q), out)
    return dict(blocks=out[0], threads=out[1], shared_bytes=out[2],
                shared_histogram=bool(out[3]), list_capacity=out[4])


def brick_mark_cuda(depth, bbox_min, brick_size, brick_res, stride,
                    ray_a=None, ray_b=None, worlds=None) -> torch.Tensor:
    """:func:`ops.bricks.mark_pixels_plain` in one (cooperative) launch,
    which also zeroes the counts: the (Bz, By, Bx) int32 counts, stride^2
    a sampled pixel. ``depth`` is the (N, H, W) float32 normalized depth (any
    strides: ``maps.depth[..., 0]``); ``ray_a`` / ``ray_b`` the (N, H, W,
    3) pixel models, or ``worlds`` the (N, Hs, Ws, 3) world points of the
    sampled pixels; ``bbox_min`` (3,) on the same card; ``brick_res`` (Bx,
    By, Bz); ``brick_size`` a Python number."""
    q = _mark_params(depth, bbox_min, brick_size, brick_res, stride, ray_a,
                     ray_b, worlds)
    counts = torch.empty((q.bz, q.by, q.bx), dtype=torch.int32,
                         device=depth.device)
    q.counts = counts.data_ptr()
    lib = _lib()
    with torch.cuda.device(depth.device):
        err = lib.rgbd_brick_mark(
            ctypes.byref(q), torch.cuda.current_stream(depth.device)
            .cuda_stream)
    check(err, "brick_mark")
    LAUNCHES["brick_mark"] += 1
    return counts


def _integrate_params(proj_bricks, ids, slot, depths, qualities,
                      silhouettes, limit, vol_shape, brick_vox,
                      carve_sil_threshold, phantom_hull, taps):
    _check_f32(proj_bricks, "proj_bricks", 4)
    N, B, V, C = proj_bricks.shape
    st = proj_bricks.stride()
    if C != 4 or st[1:] != (4 * V, 4, 1) or st[0] % 4:
        raise ValueError("proj_bricks must be (N, B, V, 4) with each "
                         "sensor's (B, V, 4) contiguous, sensors a whole "
                         "number of rows apart")
    if proj_bricks.data_ptr() % 16:
        raise ValueError("proj_bricks must start on a 16-byte boundary")
    v = int(brick_vox)
    Z, Y, X = (int(s) for s in vol_shape)
    if v < 1 or V != v ** 3:
        raise ValueError(f"proj_bricks rows of {V} voxels, brick_vox {v}")
    Bz, By, Bx = -(-Z // v), -(-Y // v), -(-X // v)
    if B != Bz * By * Bx:
        raise ValueError(f"proj_bricks has {B} bricks, the volume "
                         f"{(Z, Y, X)} in bricks of {v} has {Bz * By * Bx}")
    if (not isinstance(slot, torch.Tensor) or slot.dtype != torch.int32
            or slot.shape != (B,) or not slot.is_contiguous()):
        raise ValueError(f"slot must be a contiguous ({B},) int32 tensor")
    if (not isinstance(ids, torch.Tensor) or ids.dtype != torch.int64
            or ids.dim() != 1 or not ids.is_contiguous()
            or ids.shape[0] >= _MAX_ENTRIES):
        raise ValueError("ids must be a contiguous (capacity,) int64 tensor")
    if Z * Y * (X + 3) >= _MAX_ENTRIES:
        raise ValueError(f"a volume of fewer than 2^31 voxels, got "
                         f"{(Z, Y, X)}")
    maps = (("depths", depths), ("qualities", qualities),
            ("silhouettes", silhouettes))
    for name, m in maps:
        _check_f32(m, name, 3)
        if m.shape[0] != N or m.shape != depths.shape:
            raise ValueError(f"{name} must be ({N}, H, W) like depths, got "
                             f"{tuple(m.shape)}")
    if taps not in ("nearest", "bilinear"):
        raise ValueError(f"taps must be 'nearest' or 'bilinear', got {taps!r}")
    _on_one_card(proj_bricks=proj_bricks, ids=ids, slot=slot, depths=depths,
                 qualities=qualities, silhouettes=silhouettes)
    H, W = depths.shape[1:]
    q = IntegrateParams()
    q.proj, q.ids, q.slot = (proj_bricks.data_ptr(), ids.data_ptr(),
                             slot.data_ptr())
    q.capacity = ids.shape[0]
    q.proj_n = st[0] // 4
    q.depth, q.qual, q.sil = (m.data_ptr() for _, m in maps)
    q.ds[:], q.qs[:], q.ss[:] = (m.stride() for _, m in maps)
    q.N, q.H, q.W = N, H, W
    q.Z, q.Y, q.X, q.v, q.Bz, q.By, q.Bx, q.V = Z, Y, X, v, Bz, By, Bx, V
    q.bilinear = int(taps == "bilinear")
    q.phantom_hull = int(bool(phantom_hull))
    q.limit, q.carve = _to_f32(limit), _to_f32(carve_sil_threshold)
    return q


def integrate_plan(vol_shape, brick_vox: int, capacity: int,
                   sensors: int = 4) -> dict:
    """The launch of :func:`brick_integrate_cuda` on the current card for
    a (Z, Y, X) volume in bricks of ``brick_vox`` voxels, a list of
    ``capacity`` entries and ``sensors`` sensors: the brick blocks (an
    item of ``threads`` voxels of a listed brick a block), the clear
    blocks (x-rows a warp), interleaved through the grid; the threads a
    block, the dynamic shared bytes, the items and the items a list entry.
    The library's launch decides them; bench/fuse_split.py's forms that
    stage the sensors' rows in shared memory read them here too."""
    q = IntegrateParams()
    q.Z, q.Y, q.X = (int(s) for s in vol_shape)
    q.v = int(brick_vox)
    q.Bz, q.By, q.Bx = (-(-s // q.v) for s in (q.Z, q.Y, q.X))
    q.V, q.capacity, q.N = q.v ** 3, int(capacity), int(sensors)
    out = (_I * 6)()
    _lib().rgbd_brick_integrate_plan(ctypes.byref(q), out)
    return dict(brick_blocks=out[0], clear_blocks=out[1], threads=out[2],
                shared_bytes=out[3], items=out[4], items_an_entry=out[5])


def kernel_attrs() -> dict:
    """Registers, static shared bytes and local (spill) bytes of the four
    kernels of csrc/fuse.cu (the marking with and without its shared
    histogram, the integrate with nearest and with bilinear taps), as the
    loaded library reports them."""
    lib = _lib()
    attrs = {}
    for which, name in enumerate(("mark_kernel<true>", "mark_kernel<false>",
                                  "integrate_kernel<nearest>",
                                  "integrate_kernel<bilinear>")):
        out = (_I * 3)()
        check(lib.rgbd_fuse_attrs(which, out), name)
        attrs[name] = dict(registers=out[0], shared_bytes=out[1],
                           local_bytes=out[2])
    return attrs


def brick_integrate_cuda(proj_bricks, ids, slot, depths, qualities,
                         silhouettes, limit, vol_shape, brick_vox,
                         carve_sil_threshold=1.0, phantom_hull=False,
                         taps="nearest") -> torch.Tensor:
    """:func:`ops.tsdf.integrate_bricks` of the listed bricks, in one
    launch: the dense (Z, Y, X) volume. ``ids`` and ``slot`` are
    ops/compact.py's list of the occupied flags ((capacity,) int64,
    ascending, padded with B) and its (B,) int32 slot map (-1: not listed,
    or past the capacity; those bricks take the clear value -limit), which
    must agree; ``proj_bricks``
    the (N, B, V, 4) bake on a 16-byte boundary, each sensor's (B, V, 4)
    contiguous (the sharded step's slabs are views); the (N, H, W)
    float32 maps may have any strides (``maps.depth[..., 0]``)."""
    q = _integrate_params(proj_bricks, ids, slot, depths, qualities,
                          silhouettes, limit, vol_shape, brick_vox,
                          carve_sil_threshold, phantom_hull, taps)
    dev = proj_bricks.device
    out = torch.empty((q.Z, q.Y, q.X), dtype=torch.float32, device=dev)
    q.out = out.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rgbd_brick_integrate(
            ctypes.byref(q), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "brick_integrate")
    LAUNCHES["brick_integrate"] += 1
    return out
