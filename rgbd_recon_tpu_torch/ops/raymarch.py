"""TSDF raymarching pieces of the render (counterpart of
rgbd_recon_tpu/ops/raymarch.py): the view camera, the march (nearest or
trilinear taps, with or without skip sentinels; on the card one launch of
csrc/march.cu, on the CPU its plain twin), the render's row march over its
ray and block rows by id (``march_rows``, ``march_grid``) and its chunked
nearest form, the oct cell-corner hit table with its secant refine and
gradient, the table-based secant refine and central-difference gradient,
the color blends (calibration volumes, their nearest-lookup variant,
analytic projection models, the normal-weighted blends, the
camera-influence view) and Blinn-Phong shading.

Marching happens in volume-normalized coordinates [0, 1]^3 with step
tsdf_limit / 2 (glsl/tsdf_raymarch.fs:34). A march table is a (Z, Y, X)
tensor: the raw f32 volume, or the bf16 sentinel-coded volume of
ops/bake.py, whose values below -1.5 encode a certified-safe advance of
-(value + 2) voxel extents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .sampling import (
    bilinear_2d,
    nearest_3d,
    pair_bilinear,
    pair_trilinear,
    quad_bilinear,
    trilinear_3d,
)


@dataclasses.dataclass(frozen=True)
class ViewCamera:
    """Virtual render camera (GL convention: camera looks along -z)."""

    width: int
    height: int
    fov_y: float = 50.0
    near: float = 0.1
    far: float = 20.0
    eye: Tuple[float, float, float] = (0.0, 1.2, 3.0)
    target: Tuple[float, float, float] = (0.0, 1.1, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def rotation(self) -> np.ndarray:
        """Camera-to-world rotation (x right, y up, z backward)."""
        eye = np.asarray(self.eye, np.float32)
        tgt = np.asarray(self.target, np.float32)
        fwd = tgt - eye
        fwd /= np.linalg.norm(fwd)
        up = np.asarray(self.up, np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        return np.stack([right, true_up, -fwd], axis=1)

    def ray_directions_world(self) -> np.ndarray:
        """(H, W, 3) un-normalized world-space ray directions through each
        pixel center."""
        H, W = self.height, self.width
        aspect = W / H
        tan_half = np.tan(np.radians(self.fov_y) * 0.5)
        xs = ((np.arange(W, dtype=np.float32) + 0.5) / W * 2.0 - 1.0) * tan_half * aspect
        ys = (1.0 - (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0) * tan_half
        xx, yy = np.meshgrid(xs, ys)
        dirs_cam = np.stack([xx, yy, -np.ones_like(xx)], axis=-1)
        return dirs_cam @ self.rotation().T

    def world_to_view(self, p: torch.Tensor) -> torch.Tensor:
        """World -> GL view space (camera at origin looking down -z)."""
        r = torch.from_numpy(self.rotation()).to(p.device)
        eye = torch.tensor(self.eye, dtype=torch.float32, device=p.device)
        return (p - eye) @ r

    def window_depth(self, view_z: torch.Tensor) -> torch.Tensor:
        """GL window-space depth in [0, 1] from positive view distance
        (tsdf_raymarch.fs:133's projection arithmetic)."""
        n, f = self.near, self.far
        z = torch.clamp_min(view_z, n * 1.001)
        return torch.clamp((1.0 / n - 1.0 / z) / (1.0 / n - 1.0 / f), 0.0, 1.0)


def sample_nearest_p(table: torch.Tensor, px, py, pz) -> torch.Tensor:
    """GL NEAREST sample of a (Z, Y, X) table at planar normalized
    positions, as f32."""
    D, H, W = table.shape
    xi = torch.clamp((px * W).to(torch.int32), 0, W - 1)
    yi = torch.clamp((py * H).to(torch.int32), 0, H - 1)
    zi = torch.clamp((pz * D).to(torch.int32), 0, D - 1)
    flat = ((zi * H + yi) * W + xi).to(torch.int64)
    return table.reshape(-1)[flat].to(torch.float32)


@dataclasses.dataclass(frozen=True)
class OctVolume:
    """Compact per-surface-brick cell-corner table for the hit path: row
    (slot, lz, ly, lx) holds the eight corners (order dz*4 + dy*2 + dx,
    edge-clamped) of the trilinear cell anchored at that voxel of the brick
    in ``slot``."""

    rows: torch.Tensor   # (capacity * V, 8)
    slots: torch.Tensor  # (num_bricks,) flat brick id -> slot, -1 invalid
    shape: Tuple[int, int, int]
    brick_vox: int

    def _cells(self, px, py, pz):
        D, H, W = self.shape
        v = self.brick_vox
        Bx, By = W // v, H // v
        cx = px * W - 0.5
        cy = py * H - 0.5
        cz = pz * D - 0.5
        x0f, y0f, z0f = torch.floor(cx), torch.floor(cy), torch.floor(cz)
        fx = torch.where(x0f < 0.0, 0.0, torch.clamp(cx - x0f, 0.0, 1.0))
        fy = torch.where(y0f < 0.0, 0.0, torch.clamp(cy - y0f, 0.0, 1.0))
        fz = torch.where(z0f < 0.0, 0.0, torch.clamp(cz - z0f, 0.0, 1.0))
        x0 = torch.clamp(x0f.to(torch.int32), 0, W - 1)
        y0 = torch.clamp(y0f.to(torch.int32), 0, H - 1)
        z0 = torch.clamp(z0f.to(torch.int32), 0, D - 1)
        bid = ((z0 // v) * By + y0 // v) * Bx + x0 // v
        slot = self.slots[bid.to(torch.int64)]
        valid = slot >= 0
        local = ((z0 % v) * v + y0 % v) * v + x0 % v
        row = torch.where(valid, slot, 0).to(torch.int64) * (v * v * v) + local
        rows = self.rows[row].to(torch.float32)
        return rows, valid, fx, fy, fz

    def sample_p(self, px, py, pz, fill: float):
        """Exact GL trilinear sample; ``fill`` where the cell is off-table."""
        c, valid, fx, fy, fz = self._cells(px, py, pz)
        c00 = c[..., 0] * (1 - fx) + c[..., 1] * fx
        c01 = c[..., 2] * (1 - fx) + c[..., 3] * fx
        c10 = c[..., 4] * (1 - fx) + c[..., 5] * fx
        c11 = c[..., 6] * (1 - fx) + c[..., 7] * fx
        val = ((c00 * (1 - fy) + c01 * fy) * (1 - fz)
               + (c10 * (1 - fy) + c11 * fy) * fz)
        return torch.where(valid, val, fill)

    def gradient_p(self, px, py, pz):
        """Analytic gradient of the trilinear field within the anchor cell,
        in volume-normalized units; returns ((..., 3), valid)."""
        D, H, W = self.shape
        c, valid, fx, fy, fz = self._cells(px, py, pz)
        wy0, wy1 = (1 - fy), fy
        wz0, wz1 = (1 - fz), fz
        gx = (
            (c[..., 1] - c[..., 0]) * wy0 * wz0
            + (c[..., 3] - c[..., 2]) * wy1 * wz0
            + (c[..., 5] - c[..., 4]) * wy0 * wz1
            + (c[..., 7] - c[..., 6]) * wy1 * wz1
        ) * W
        wx0, wx1 = (1 - fx), fx
        gy = (
            ((c[..., 2] - c[..., 0]) * wx0 + (c[..., 3] - c[..., 1]) * wx1)
            * wz0
            + ((c[..., 6] - c[..., 4]) * wx0 + (c[..., 7] - c[..., 5]) * wx1)
            * wz1
        ) * H
        gz = (
            ((c[..., 4] - c[..., 0]) * wx0 + (c[..., 5] - c[..., 1]) * wx1)
            * wy0
            + ((c[..., 6] - c[..., 2]) * wx0 + (c[..., 7] - c[..., 3]) * wx1)
            * wy1
        ) * D
        return torch.stack([gx, gy, gz], dim=-1), valid


def oct_rows_plain(volume: torch.Tensor, ids: torch.Tensor, brick_vox: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """(capacity * v^3, 8) cell-corner rows of the bricks ``ids`` (ids past
    the last brick, compact's padding, take the last brick's corners, as
    the JAX package's ``idc``): row (slot, lz, ly, lx) holds the corners
    dz*4 + dy*2 + dx of the cell at that voxel, edge-clamped, cast to
    ``dtype``. Requires brick-aligned volume dims."""
    Z, Y, X = volume.shape
    v = brick_vox
    Bz, By, Bx = Z // v, Y // v, X // v
    B = Bz * By * Bx
    capacity = ids.shape[0]
    idc = torch.clamp_max(ids, B - 1)
    bz = idc // (By * Bx)
    by = (idc // Bx) % By
    bx = idc % Bx
    r = torch.arange(v + 1, device=volume.device)
    ez = torch.clamp_max(bz[:, None] * v + r, Z - 1)       # (K, v+1)
    ey = torch.clamp_max(by[:, None] * v + r, Y - 1)
    ex = torch.clamp_max(bx[:, None] * v + r, X - 1)
    ext = volume[ez[:, :, None, None], ey[:, None, :, None],
                 ex[:, None, None, :]]                      # (K, v+1)^3
    corners = [ext[:, dz: dz + v, dy: dy + v, dx: dx + v]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    rows = torch.stack(corners, dim=-1).reshape(capacity * v * v * v, 8)
    return rows.to(dtype)


def oct_rows(volume: torch.Tensor, ids: torch.Tensor, brick_vox: int,
             dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`oct_rows_plain`: one csrc/bake.cu ``oct_table`` launch on
    CUDA tensors, the plain version on CPU tensors."""
    if volume.device.type == "cpu":
        return oct_rows_plain(volume, ids, brick_vox, dtype)
    from ..kernels.bake import oct_table_cuda

    return oct_table_cuda(volume.contiguous(), ids, brick_vox, dtype)


def _oct_volume(volume, occ, brick_vox, capacity, dtype, compact_fn,
                rows_fn) -> OctVolume:
    """The oct table from ``compact_fn``'s list of the surface bricks and
    its slot map, rows by ``rows_fn``."""
    flags = occ.reshape(-1).view(torch.uint8)
    count = torch.empty(1, dtype=torch.int32, device=flags.device)
    ids, slots = compact_fn(flags, 0, capacity, count, 0, want_slot=True)
    return OctVolume(rows=rows_fn(volume, ids, brick_vox, dtype),
                     slots=slots, shape=tuple(volume.shape),
                     brick_vox=brick_vox)


def build_oct_bricks(volume: torch.Tensor, occ: torch.Tensor, brick_vox: int,
                     capacity: int, dtype=torch.bfloat16) -> OctVolume:
    """Cell-corner table over the first ``capacity`` surface bricks (in
    ascending brick id; the padding slots hold the last brick's corners)
    and the slot of each brick (-1 unlisted). On CUDA tensors one
    ``compact`` launch and one ``oct_table`` launch, no host sync; on CPU
    tensors :func:`build_oct_plain`. Requires brick-aligned volume
    dims."""
    from .compact import compact

    return _oct_volume(volume, occ, brick_vox, capacity, dtype, compact,
                       oct_rows)


def build_oct_plain(volume: torch.Tensor, occ: torch.Tensor, brick_vox: int,
                    capacity: int, dtype=torch.bfloat16) -> OctVolume:
    """:func:`build_oct_bricks`' plain twin: ``compact_plain``'s list and
    slot map, ``oct_rows_plain``'s rows."""
    from .compact import compact_plain

    return _oct_volume(volume, occ, brick_vox, capacity, dtype,
                       compact_plain, oct_rows_plain)


def _secant_den(den):
    return torch.where(torch.abs(den) < 1e-20, 1e-20, den)


def oct_refine_crossing(oct: OctVolume, pos0, dn, lo_t, hi_t, hit, hit_pos,
                        limit: float, widen_steps: float = 0.0,
                        widen_samples: int = 6) -> torch.Tensor:
    """Trilinear secant refinement at the crossing bracket from the oct
    table. With ``widen_steps > 0`` the bracket is widened by that many
    march steps each side, sampled at ``widen_samples`` points, the first
    rising sign change is taken and two secant iterations run."""
    p0x, p0y, p0z = pos0
    dnx, dny, dnz = dn
    sd = float(np.float32(limit) * np.float32(0.5))
    if widen_steps > 0.0 and widen_samples >= 3:
        K = int(widen_samples)
        span_lo = lo_t - widen_steps * sd
        span = (hi_t - lo_t) + 2.0 * widen_steps * sd
        ks = torch.arange(K, dtype=torch.float32, device=lo_t.device) / (K - 1)
        tk = span_lo[..., None] + ks * span[..., None]
        d = oct.sample_p(p0x[..., None] + dnx[..., None] * tk,
                         p0y[..., None] + dny[..., None] * tk,
                         p0z[..., None] + dnz[..., None] * tk, -limit)
        rising = (d[..., 1:] > 0.0) & (d[..., :-1] <= 0.0)
        found = hit & rising.any(dim=-1)
        kstar = rising.to(torch.float32).argmax(dim=-1)     # first crossing
        d_lo = torch.gather(d[..., :-1], -1, kstar[..., None])[..., 0]
        d_hi = torch.gather(d[..., 1:], -1, kstar[..., None])[..., 0]
        step = span / (K - 1)
        t_lo = span_lo + kstar.to(torch.float32) * step
        t_hi = t_lo + step
        ts = t_hi - (t_hi - t_lo) * (d_hi / _secant_den(d_hi - d_lo))
        dm = oct.sample_p(p0x + dnx * ts, p0y + dny * ts, p0z + dnz * ts,
                          -limit)
        up = dm > 0.0
        t_lo2 = torch.where(up, t_lo, ts)
        d_lo2 = torch.where(up, d_lo, dm)
        t_hi2 = torch.where(up, ts, t_hi)
        d_hi2 = torch.where(up, dm, d_hi)
        tstar = t_hi2 - (t_hi2 - t_lo2) * (d_hi2 / _secant_den(d_hi2 - d_lo2))
        refined = torch.stack([p0x + dnx * tstar, p0y + dny * tstar,
                               p0z + dnz * tstar], dim=-1)
        return torch.where(found[..., None], refined, hit_pos)
    v1 = oct.sample_p(p0x + dnx * hi_t, p0y + dny * hi_t, p0z + dnz * hi_t,
                      -limit)
    v0 = oct.sample_p(p0x + dnx * lo_t, p0y + dny * lo_t, p0z + dnz * lo_t,
                      -limit)
    ok = hit & (v1 > 0.0) & (v0 <= 0.0)
    tstar = hi_t - (hi_t - lo_t) * (v1 / _secant_den(v1 - v0))
    refined = torch.stack([p0x + dnx * tstar, p0y + dny * tstar,
                           p0z + dnz * tstar], dim=-1)
    return torch.where(ok[..., None], refined, hit_pos)


def refine_crossing(table: torch.Tensor, pos0, dn, lo_t, hi_t, hit,
                    hit_pos, clamp_floor=None) -> torch.Tensor:
    """Trilinear secant refinement at the march's crossing bracket
    [lo_t, hi_t] (tsdf_raymarch.fs:98-101) from the (Z, Y, X) march table;
    ``clamp_floor`` neutralises skip sentinels. Rays whose trilinear
    bracket does not confirm the crossing keep ``hit_pos``."""
    p0x, p0y, p0z = pos0
    dnx, dny, dnz = dn
    v1 = pair_trilinear(table, p0x + dnx * hi_t, p0y + dny * hi_t,
                        p0z + dnz * hi_t, clamp_floor)
    v0 = pair_trilinear(table, p0x + dnx * lo_t, p0y + dny * lo_t,
                        p0z + dnz * lo_t, clamp_floor)
    ok = hit & (v1 > 0.0) & (v0 <= 0.0)
    tstar = hi_t - (hi_t - lo_t) * (v1 / _secant_den(v1 - v0))
    refined = torch.stack([p0x + dnx * tstar, p0y + dny * tstar,
                           p0z + dnz * tstar], dim=-1)
    return torch.where(ok[..., None], refined, hit_pos)


def gradient_normal(table: torch.Tensor, pos: torch.Tensor, limit: float,
                    mode: str = "trilinear", clamp_floor=None
                    ) -> torch.Tensor:
    """Central-difference TSDF gradient at +-step along each axis, negated
    and normalized (get_gradient, tsdf_raymarch.fs:148-157), in volume-
    normalized space. ``mode="nearest"`` takes nearest samples;
    ``clamp_floor`` clamps each sample (each tap when trilinear) from
    below."""
    sd = float(np.float32(limit) * np.float32(0.5))
    p = [pos[..., 0], pos[..., 1], pos[..., 2]]

    def s(q):
        if mode == "nearest":
            v = sample_nearest_p(table, *q)
            return v if clamp_floor is None else torch.clamp_min(
                v, clamp_floor)
        return pair_trilinear(table, *q, clamp_floor)

    def diff(axis):
        hi = [x + sd if j == axis else x for j, x in enumerate(p)]
        lo = [x - sd if j == axis else x for j, x in enumerate(p)]
        return s(hi) - s(lo)

    g = torch.stack([diff(0), diff(1), diff(2)], dim=-1)
    return -g / torch.clamp_min(_norm(g), 1e-20)


# a CPU-side .any() check of the loop condition every this many steps:
# extra iterations past the last active ray change nothing (the body
# freezes inactive rays), so the results equal a per-step exit
_EXIT_CHECK_EVERY = 8


def unit_cube_entry(eye: torch.Tensor, dirs, limit: float):
    """Start positions and ray lengths of rays from ``eye`` through the unit
    cube (the slab test of tsdf_raymarch.fs:371-382 in march steps of
    tsdf_limit / 2): the ``start_end`` of a full-screen march. Rays that
    miss the cube, or whose exit lies behind the eye, get length 0."""
    sd = float(np.float32(limit) * np.float32(0.5))
    dnx, dny, dnz = dirs

    def slab(c0, d):
        inv = 1.0 / (d * sd)
        tb = inv * (0.0 - c0)
        tt = inv * (1.0 - c0)
        return torch.minimum(tb, tt), torch.maximum(tb, tt)

    l0, h0 = slab(eye[0], dnx)
    l1, h1 = slab(eye[1], dny)
    l2, h2 = slab(eye[2], dnz)
    t0 = torch.maximum(torch.maximum(l0, l1), l2)
    t1 = torch.minimum(torch.minimum(h0, h1), h2)
    is_t0 = t0 <= t1
    t_near = torch.clamp_min(torch.where(is_t0, t0, t1), 0.0)
    t_far = torch.where(is_t0, t1, t0)
    pos0 = tuple(eye[i] + d * sd * t_near
                 for i, d in enumerate((dnx, dny, dnz)))
    length = torch.where(is_t0 & (t_far > t_near), (t_far - t_near) * sd,
                         0.0)
    return pos0, length


def march(table: torch.Tensor, limit: float, max_steps: int,
          start_end, dirs, mode: str = "nearest", sentinel_skip: bool = True,
          sentinel_scale: float = 1.0, resume=None):
    """The march of :func:`march_plain`: the CUDA kernel (csrc/march.cu, one
    launch, one thread a ray) on a CUDA table, the plain version on a CPU
    table. Same arguments and results."""
    if table.device.type == "cpu":
        return march_plain(table, limit, max_steps, start_end, dirs, mode,
                           sentinel_skip, sentinel_scale, resume)
    from ..kernels.raymarch import march_cuda

    return march_cuda(table, limit, max_steps, start_end, dirs, mode,
                      sentinel_skip, sentinel_scale, resume)


def march_plain(table: torch.Tensor, limit: float, max_steps: int,
                start_end, dirs, mode: str = "nearest",
                sentinel_skip: bool = True, sentinel_scale: float = 1.0,
                resume=None):
    """The march loop of tsdf_raymarch.fs:62-114: each active ray samples
    the table at its position (``mode`` "nearest": the nearest texel;
    "trilinear": sampling.pair_trilinear), records the secant zero of the
    (prev_t, t) bracket on the first positive sample and advances by one
    step (tsdf_limit / 2). With ``sentinel_skip`` a sample below -1.5 is a
    skip sentinel: the ray advances by max(safe_steps * sentinel_scale,
    step) and the sample counts as -limit.

    ``start_end`` = ((px, py, pz) start positions, (R,) ray lengths), e.g.
    from :func:`unit_cube_entry`; ``dirs`` = planar unit directions;
    ``resume`` = (t, prev_t, prev) from an earlier march. Runs at most
    ``max_steps`` iterations and stops early once no ray is active.
    Returns (hit, num, state) with state = (t, prev_t, prev, lo_t, hi_t,
    hit_t) in arc length from the start."""
    sd = float(np.float32(limit) * np.float32(0.5))
    (pos0x, pos0y, pos0z), ray_len = start_end
    dnx, dny, dnz = dirs
    shape, dev = dnx.shape, dnx.device
    if resume is not None:
        t, prev_t, prev = (x.clone() for x in resume)
    else:
        t = torch.zeros(shape, dtype=torch.float32, device=dev)
        prev_t = torch.zeros_like(t)
        prev = torch.full(shape, -limit, dtype=torch.float32, device=dev)
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    hit_t = torch.zeros_like(t)
    lo_t = torch.zeros_like(t)
    hi_t = torch.zeros_like(t)
    num = torch.zeros(shape, dtype=torch.int32, device=dev)
    marchable = ray_len > 0.0

    for k in range(max_steps):
        active = (~hit) & (t <= ray_len) & marchable
        if k % _EXIT_CHECK_EVERY == 0 and not bool(active.any()):
            break
        px = pos0x + dnx * t
        py = pos0y + dny * t
        pz = pos0z + dnz * t
        if mode == "nearest":
            raw = sample_nearest_p(table, px, py, pz)
        else:
            raw = pair_trilinear(table, px, py, pz)
        density = torch.clamp_min(raw, -limit)   # neutralise the sentinel
        found = active & (density > 0.0)
        tstar = t - (t - prev_t) * (density / _secant_den(density - prev))
        hit_t = torch.where(found, tstar, hit_t)
        lo_t = torch.where(found, prev_t, lo_t)
        hi_t = torch.where(found, t, hi_t)
        if sentinel_skip:
            advance = torch.where(
                raw < -1.5, torch.clamp_min((-raw - 2.0) * sentinel_scale, sd),
                sd)
        else:
            advance = sd
        num = torch.where(active, num + 1, num)
        prev_t = torch.where(active, t, prev_t)
        prev = torch.where(active, density, prev)
        t = torch.where(active, t + advance, t)
        hit = hit | found
    return hit, num, (t, prev_t, prev, lo_t, hi_t, hit_t)


def state_rows(hit, num, state, num_base=None) -> torch.Tensor:
    """(N, 8) state rows of a march's (hit, num, state): t, prev_t, prev,
    lo_t, hi_t, hit_t, hit as 0/1, num as f32 (plus ``num_base``)."""
    n = num.to(torch.float32)
    if num_base is not None:
        n = num_base + n
    return torch.stack([*state, hit.to(torch.float32), n], dim=-1)


def row_flags(st8: torch.Tensor, ray8: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 flags of the state rows ``st8`` of the rays ``ray8``
    (pos0, dir, full length, bracket length): bit 0 the ray hit, bit 1 it
    is unfinished (no hit, t within its full length, a length > 0)."""
    full = ray8[:, 6]
    hit = st8[:, 6] > 0.5
    unfinished = (st8[:, 6] < 0.5) & (st8[:, 0] <= full) & (full > 0.0)
    return hit.to(torch.uint8) | (unfinished.to(torch.uint8) << 1)


def _put_rows(buf: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor):
    """buf[ids] = rows in place, dropping ids past the end (the padding of
    a list): written through a spare row, without a host sync."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    ext[torch.clamp_max(ids, n)] = rows
    buf.copy_(ext[:n])
    return buf


def march_rows_plain(table: torch.Tensor, limit: float, max_steps: int,
                     ray8: torch.Tensor, len_col: int = 6, *,
                     mode: str = "nearest", sentinel_skip: bool = True,
                     sentinel_scale: float = 1.0, st8=None, flags=None,
                     ids=None):
    """The render's march over its (R, 8) ray rows ``ray8`` (pos0, dir,
    full length, bracket length), :func:`march_plain` per ray. Without
    ``ids``: every row from its start over column ``len_col``; returns new
    (st8 (R, 8) state rows, flags (R,) uint8: :func:`row_flags`). With
    ``ids`` (a list padded with R): the listed rows resumed from ``st8``'s
    (t, prev_t, prev) over column ``len_col``; their rows of ``st8`` (num
    added to the earlier count) and ``flags`` are updated in place, and
    (st8, flags) returned."""
    R = ray8.shape[0]
    kw = dict(mode=mode, sentinel_skip=sentinel_skip,
              sentinel_scale=sentinel_scale)
    if ids is None:
        hit, num, st = march_plain(
            table, limit, max_steps,
            ((ray8[:, 0], ray8[:, 1], ray8[:, 2]), ray8[:, len_col]),
            (ray8[:, 3], ray8[:, 4], ray8[:, 5]), **kw)
        st8 = state_rows(hit, num, st)
        return st8, row_flags(st8, ray8)
    safe = torch.clamp_max(ids, R - 1)
    rg = ray8[safe]
    sg = st8[safe]
    length = torch.where(ids < R, rg[:, len_col], 0.0)
    hit, num, st = march_plain(
        table, limit, max_steps, ((rg[:, 0], rg[:, 1], rg[:, 2]), length),
        (rg[:, 3], rg[:, 4], rg[:, 5]),
        resume=(sg[:, 0], sg[:, 1], sg[:, 2]), **kw)
    _put_rows(st8, ids, state_rows(hit, num, st, sg[:, 7]))
    flags.copy_(row_flags(st8, ray8))
    return st8, flags


def march_rows(table: torch.Tensor, limit: float, max_steps: int,
               ray8: torch.Tensor, len_col: int = 6, *,
               mode: str = "nearest", sentinel_skip: bool = True,
               sentinel_scale: float = 1.0, st8=None, flags=None, ids=None):
    """:func:`march_rows_plain`: one launch of csrc/march.cu's row march on
    a CUDA table (rows read and written by id, in place), the plain
    version on a CPU table. Same arguments and results."""
    kw = dict(mode=mode, sentinel_skip=sentinel_skip,
              sentinel_scale=sentinel_scale, st8=st8, flags=flags, ids=ids)
    if table.device.type == "cpu":
        return march_rows_plain(table, limit, max_steps, ray8, len_col, **kw)
    from ..kernels.raymarch import march_rows_cuda

    return march_rows_cuda(table, limit, max_steps, ray8, len_col, **kw)


def march_grid_plain(table: torch.Tensor, limit: float, max_steps: int,
                     blk: torch.Tensor, ids: torch.Tensor,
                     grid: torch.Tensor, *, mode: str = "nearest",
                     sentinel_skip: bool = True,
                     sentinel_scale: float = 1.0) -> torch.Tensor:
    """The coarse march of the listed blocks: row b = ids[i] of the (NB, 8)
    block rows ``blk`` (pos0, dir, length, interval start) marched from its
    start (ids past NB: the list's padding); a block whose ray hits gets
    (1, start + lo_t, start + hi_t) in its entries of the (3, NB) hit / lo
    / hi ``grid``, in place (the others keep theirs). Returns ``grid``."""
    NB = blk.shape[0]
    live = ids < NB
    rows = blk[torch.clamp_max(ids, NB - 1)]
    length = torch.where(live, rows[:, 6], 0.0)
    start = torch.where(live, rows[:, 7], 0.0)
    hit, _, st = march_plain(
        table, limit, max_steps, ((rows[:, 0], rows[:, 1], rows[:, 2]),
                                  length),
        (rows[:, 3], rows[:, 4], rows[:, 5]), mode=mode,
        sentinel_skip=sentinel_skip, sentinel_scale=sentinel_scale)
    lo = start + st[3]
    hi = start + st[4]
    inf = float("inf")
    _put_rows(grid.T, ids, torch.stack([
        hit.to(torch.float32), torch.where(hit, lo, inf),
        torch.where(hit, hi, -inf)], dim=-1))
    return grid


def march_grid(table: torch.Tensor, limit: float, max_steps: int,
               blk: torch.Tensor, ids: torch.Tensor, grid: torch.Tensor, *,
               mode: str = "nearest", sentinel_skip: bool = True,
               sentinel_scale: float = 1.0) -> torch.Tensor:
    """:func:`march_grid_plain`: one launch of csrc/march.cu's row march in
    its grid mode on a CUDA table, the plain version on a CPU table."""
    kw = dict(mode=mode, sentinel_skip=sentinel_skip,
              sentinel_scale=sentinel_scale)
    if table.device.type == "cpu":
        return march_grid_plain(table, limit, max_steps, blk, ids, grid, **kw)
    from ..kernels.raymarch import march_grid_cuda

    return march_grid_cuda(table, limit, max_steps, blk, ids, grid, **kw)


def march_chunked(table: torch.Tensor, limit: float, max_steps: int,
                  start_end, dirs, chunk: int, sentinel_skip: bool = True,
                  sentinel_scale: float = 1.0, resume=None):
    """The chunked nearest march (raymarch.march_chunked of the JAX
    package): each iteration samples ``chunk`` points per ray one step
    (tsdf_limit / 2) apart from its position in one gather, takes the first
    positive sample in range, and records the secant zero of its bracket
    with the sample before it (the previous chunk's last sample when it is
    the chunk's first). A ray that finds none moves on one step past the
    chunk's last sample, or with ``sentinel_skip`` to the furthest point a
    skip sentinel in the chunk certifies (sample position + its clearance).
    Arguments as :func:`march`; runs at most ceil(max_steps / chunk)
    iterations and returns the same (hit, num, state) as :func:`march`, so
    the pipeline's stages can mix the two."""
    sd = float(np.float32(limit) * np.float32(0.5))
    C = int(chunk)
    (p0x, p0y, p0z), ray_len = start_end
    dnx, dny, dnz = dirs
    shape, dev = dnx.shape, dnx.device
    ks = torch.arange(C, dtype=torch.float32, device=dev)
    if resume is not None:
        t, prev_t, prev = (x.clone() for x in resume)
    else:
        t = torch.zeros(shape, dtype=torch.float32, device=dev)
        prev_t = torch.zeros_like(t)
        prev = torch.full(shape, -limit, dtype=torch.float32, device=dev)
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    hit_t = torch.zeros_like(t)
    lo_t = torch.zeros_like(t)
    hi_t = torch.zeros_like(t)
    num = torch.zeros(shape, dtype=torch.int32, device=dev)
    marchable = ray_len > 0.0
    last_off = float(np.float32(C - 1) * np.float32(sd))

    for k in range(-(-int(max_steps) // C)):
        active = (~hit) & (t <= ray_len) & marchable
        if k % _EXIT_CHECK_EVERY == 0 and not bool(active.any()):
            break
        tk = t[..., None] + ks * sd                              # (..., C)
        raw = sample_nearest_p(table, p0x[..., None] + dnx[..., None] * tk,
                               p0y[..., None] + dny[..., None] * tk,
                               p0z[..., None] + dnz[..., None] * tk)
        density = torch.clamp_min(raw, -limit)
        in_len = tk <= ray_len[..., None]
        pos = (density > 0.0) & in_len
        found = active & pos.any(dim=-1)
        kstar = pos.to(torch.uint8).argmax(dim=-1)               # first True
        d_hi = torch.gather(density, -1, kstar[..., None])[..., 0]
        d_lo_in = torch.gather(density, -1,
                               torch.clamp_min(kstar - 1, 0)[..., None])[..., 0]
        t_hi = t + kstar.to(torch.float32) * sd
        first = kstar == 0
        d_lo = torch.where(first, prev, d_lo_in)
        t_lo = torch.where(first, prev_t, t_hi - sd)
        tstar = t_hi - (t_hi - t_lo) * (d_hi / _secant_den(d_hi - d_lo))
        hit_t = torch.where(found, tstar, hit_t)
        lo_t = torch.where(found, t_lo, lo_t)
        hi_t = torch.where(found, t_hi, hi_t)
        n_in = in_len.sum(dim=-1, dtype=torch.int32)
        num = num + torch.where(active, torch.where(
            found, kstar.to(torch.int32) + 1, n_in), 0).to(torch.int32)
        t_last = t + last_off
        t_next = t_last + sd
        if sentinel_skip:
            clr = (-raw - 2.0) * sentinel_scale
            certified = torch.where(in_len & (raw < -1.5), tk + clr,
                                    float("-inf")).amax(dim=-1)
            t_next = torch.maximum(t_next, certified)
        cont = active & ~found
        prev_t = torch.where(cont, t_last, prev_t)
        prev = torch.where(cont, density[..., C - 1], prev)
        t = torch.where(cont, t_next, t)
        hit = hit | found
    return hit, num, (t, prev_t, prev, lo_t, hi_t, hit_t)


def _blend_accumulate(col, depth, qual, z, in_frustum, limit, acc):
    """One sensor's term of the blendColors fold (tsdf_raymarch.fs:
    303-338): quality / (dist + 0.01) weights inside the truncation band,
    inverse-distance weights for the fallback."""
    total_c, total_w, total_c2, total_w2 = acc
    dist = torch.abs(depth - z)
    qual = torch.where((dist < limit) & in_frustum, qual, 0.0)
    w = qual / (dist + 0.01)
    w2 = torch.where(in_frustum, 1.0 / torch.clamp_min(dist, 1e-20), 0.0)
    return (total_c + col * w[..., None], total_w + w,
            total_c2 + col * w2[..., None], total_w2 + w2)


def _blend_finalize(acc):
    """(..., 4) rgba: the quality blend with alpha 1 where any quality
    weight is positive, else the inverse-distance blend with alpha -1."""
    total_c, total_w, total_c2, total_w2 = acc
    use_primary = total_w > 0.0
    primary = total_c / torch.clamp_min(total_w, 1e-20)[..., None]
    fallback = total_c2 / torch.clamp_min(total_w2, 1e-20)[..., None]
    rgb = torch.where(use_primary[..., None], primary, fallback)
    alpha = torch.where(use_primary, 1.0, -1.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _blend_zeros(shape, device):
    z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
    z1 = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z3, z1, z3, z1)


def blend_colors(sample_pos: torch.Tensor, cv_xyz_inv, cv_uv, colors,
                 depths, qualities, limit: float) -> torch.Tensor:
    """The reference-exact color blend (blendColors, tsdf_raymarch.fs:
    303-338) through the calibration volumes: per sensor, a trilinear
    cv_xyz_inv lookup at the volume-normalized hit position, a trilinear
    cv_uv lookup for the color texcoord, and bilinear fetches of color,
    depth and quality. Returns (..., 4) rgba."""
    acc = _blend_zeros(sample_pos.shape[:-1], sample_pos.device)
    dq = torch.stack([depths, qualities], dim=-1)
    for i in range(colors.shape[0]):
        lookup = trilinear_3d(cv_xyz_inv[i], sample_pos)
        pos_calib = lookup[..., :3]
        in_frustum = lookup[..., 3] > 0.99
        pos_color = trilinear_3d(cv_uv[i], pos_calib)[..., :2]
        col = bilinear_2d(colors[i], pos_color)
        dqv = bilinear_2d(dq[i], pos_calib[..., :2])
        acc = _blend_accumulate(col, dqv[..., 0], dqv[..., 1],
                                pos_calib[..., 2], in_frustum, limit, acc)
    return _blend_finalize(acc)


def blend_colors_fast(sample_pos: torch.Tensor, cv_xyz_inv, cv_uv, colors,
                      depths, qualities, limit: float) -> torch.Tensor:
    """:func:`blend_colors` with nearest calibration-volume lookups (the
    volumes vary smoothly at voxel scale), colors rounded to bf16, and
    color and f32 depth/quality read with sampling.pair_bilinear (the
    x-pair tap rule of the JAX package's raymarch._pair_bilinear)."""
    acc = _blend_zeros(sample_pos.shape[:-1], sample_pos.device)
    col_bf = colors.to(torch.bfloat16)
    dq = torch.stack([depths, qualities], dim=-1)
    for i in range(colors.shape[0]):
        lookup = nearest_3d(cv_xyz_inv[i], sample_pos)
        pos_calib = lookup[..., :3]
        in_frustum = lookup[..., 3] > 0.99
        pos_color = nearest_3d(cv_uv[i], pos_calib)
        col = pair_bilinear(col_bf[i], pos_color[..., 0], pos_color[..., 1])
        dqv = pair_bilinear(dq[i], pos_calib[..., 0], pos_calib[..., 1])
        acc = _blend_accumulate(col, dqv[..., 0], dqv[..., 1],
                                pos_calib[..., 2], in_frustum, limit, acc)
    return _blend_finalize(acc)


def blend_colors_analytic(world_pos: torch.Tensor, proj_models, colors,
                          depths, qualities, limit: float,
                          dq_taps: str = "nearest") -> torch.Tensor:
    """Quality-weighted multi-sensor color blend (blendColors,
    tsdf_raymarch.fs:303-338) through the analytic projection models:
    per sensor, a bilinear color fetch from the bf16-rounded color map and
    a fetch of depth/quality at the nearest texel (``dq_taps="nearest"``)
    or with the four-corner rule of sampling.quad_bilinear from the f32
    maps (``"bilinear"``). Returns (..., 4) rgba; alpha 1 for the quality
    blend, -1 for the inverse-distance fallback."""
    N = colors.shape[0]
    H, W = depths.shape[1:3]
    px, py, pz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    tc = [torch.zeros_like(px) for _ in range(3)]
    tw = torch.zeros_like(px)
    tc2 = [torch.zeros_like(px) for _ in range(3)]
    tw2 = torch.zeros_like(px)
    col_bf = colors.to(torch.bfloat16)
    dq = torch.stack([depths, qualities], dim=-1)
    for i in range(N):
        u, v, d = proj_models.uvd_p(i, px, py, pz)
        in_frustum = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                      & (d >= 0.0) & (d <= 1.0))
        cu, cv_ = proj_models.color_uv_p(i, px, py, pz)
        col = quad_bilinear(col_bf[i], cu, cv_)
        if dq_taps == "nearest":
            xi = torch.clamp((u * W).to(torch.int32), 0, W - 1)
            yi = torch.clamp((v * H).to(torch.int32), 0, H - 1)
            dqv = dq[i].reshape(H * W, 2)[(yi * W + xi).to(torch.int64)]
        else:
            dqv = quad_bilinear(dq[i], u, v)
        depth = dqv[..., 0]
        qual = dqv[..., 1]
        dist = torch.abs(depth - d)
        qual = torch.where((dist < limit) & in_frustum, qual, 0.0)
        w = qual / (dist + 0.01)
        w2 = torch.where(in_frustum, 1.0 / torch.clamp_min(dist, 1e-20), 0.0)
        for j in range(3):
            tc[j] = tc[j] + col[..., j] * w
            tc2[j] = tc2[j] + col[..., j] * w2
        tw = tw + w
        tw2 = tw2 + w2
    use_primary = tw > 0.0
    inv_w = 1.0 / torch.clamp_min(tw, 1e-20)
    inv_w2 = 1.0 / torch.clamp_min(tw2, 1e-20)
    rgb = [torch.where(use_primary, tc[j] * inv_w, tc2[j] * inv_w2)
           for j in range(3)]
    alpha = torch.where(use_primary, 1.0, -1.0)
    return torch.stack(rgb + [alpha], dim=-1)


def blend_colors_normal(sample_pos: torch.Tensor, world_pos: torch.Tensor,
                        surf_normal: torch.Tensor, proj_models, cv_xyz_inv,
                        cv_uv, colors, depths, normal_maps, limit: float,
                        variant: str = "deviation") -> torch.Tensor:
    """The reference's alternative blends (blendColors2, tsdf_raymarch.fs:
    266-301). Per sensor: its (u, v, depth) and color texcoord from the
    projection models (nearest calibration-volume lookups without them),
    then color, depth and the sensor's normal with the x-pair tap rule of
    sampling.pair_bilinear. The weight is dev / dist with dev =
    min(dot(-surf_normal, sensor normal), 0) (getNormalDev, :195-204) for
    ``variant="deviation"``; ``"best_two"`` gives weight 1 / dist to the two
    sensors of most negative dev (getNormalTwo, :221-244), ties broken by
    sensor order. As in the JAX package, the denominator holds these
    weights alone (the shader's also carries its first loop's quality
    weights, an accumulator left over, :266-301), and alpha is 1 where the
    weights sum to more than 1e-12 in magnitude, else -1 (the shader's -1
    everywhere would make the pull-push fill erase every hit).
    Returns (..., 4) rgba."""
    N = colors.shape[0]
    devs, dists, cols = [], [], []
    px, py, pz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    for i in range(N):
        if proj_models is not None:
            u, v, d = proj_models.uvd_p(i, px, py, pz)
            cu, cv_ = proj_models.color_uv_p(i, px, py, pz)
        else:
            uvd = nearest_3d(cv_xyz_inv[i], sample_pos)
            u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
            cuv = nearest_3d(cv_uv[i], uvd[..., :3])
            cu, cv_ = cuv[..., 0], cuv[..., 1]
        col = pair_bilinear(colors[i], cu, cv_)
        depth = pair_bilinear(depths[i][..., None], u, v)[..., 0]
        n_i = pair_bilinear(normal_maps[i], u, v)
        dists.append(torch.abs(depth - d))
        devs.append(torch.clamp_max((-surf_normal * n_i).sum(dim=-1), 0.0))
        cols.append(col)
    dev = torch.stack(devs)                      # (N, ...)
    dist = torch.clamp_min(torch.stack(dists), 1e-6)
    col = torch.stack(cols)
    if variant == "best_two":
        # stable, as jnp.argsort: equal deviations keep sensor order
        order = torch.sort(dev, dim=0, stable=True).indices
        sensors = torch.arange(N, device=dev.device).view(
            (N,) + (1,) * (dev.dim() - 1))
        sel = ((sensors == order[0]).to(torch.float32)
               + (sensors == order[1]).to(torch.float32))
        w = sel / dist
    else:
        w = dev / dist
    total_w = w.sum(dim=0)
    rgb = (col * w[..., None]).sum(dim=0) / torch.where(
        torch.abs(total_w) < 1e-20, 1e-20, total_w)[..., None]
    alpha = torch.where(torch.abs(total_w) > 1e-12, 1.0, -1.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


# the per-camera palette of the camera-influence view (shading.glsl:24-30)
_CAMERA_PALETTE = np.array([[228, 26, 28], [55, 126, 184], [77, 175, 74],
                            [152, 78, 163], [255, 127, 0]],
                           np.float32) / 255.0


def blend_cameras(sample_pos: torch.Tensor, cv_xyz_inv, depths, qualities,
                  limit: float) -> torch.Tensor:
    """Camera-influence debug view (blendCameras + getWeights,
    tsdf_raymarch.fs:159-174, 354-369): each sensor's palette color,
    weighted by its quality where the hit lies within ``limit`` of its
    depth (trilinear cv_xyz_inv lookup, bilinear depth and quality);
    white where no sensor weighs in. Returns (..., 3) rgb."""
    palette = torch.from_numpy(_CAMERA_PALETTE).to(sample_pos.device)
    total_c = torch.zeros(sample_pos.shape[:-1] + (3,), dtype=torch.float32,
                          device=sample_pos.device)
    total_w = torch.zeros(sample_pos.shape[:-1], dtype=torch.float32,
                          device=sample_pos.device)
    dq = torch.stack([depths, qualities], dim=-1)
    for i in range(depths.shape[0]):
        pos_calib = trilinear_3d(cv_xyz_inv[i], sample_pos)[..., :3]
        dqv = bilinear_2d(dq[i], pos_calib[..., :2])
        dist = torch.abs(dqv[..., 0] - pos_calib[..., 2])
        qual = torch.where(dist < limit, dqv[..., 1], 0.0)
        total_c = total_c + palette[i % 5] * qual[..., None]
        total_w = total_w + qual
    out = total_c / torch.clamp_min(total_w, 1e-20)[..., None]
    return torch.where(total_w[..., None] > 0.0, out, 1.0)


_LIGHT_POSITION = (1.5, 1.0, 1.0)       # view space (shading.glsl:5)
_LIGHT_DIFFUSE = (1.0, 0.9, 0.7)
_LIGHT_SPECULAR = (1.0, 1.0, 1.0)
_KS = 0.5
_SHININESS = 20.0
_SOLID_DIFFUSE = 0.5


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def _unit(x):
    return x / torch.clamp_min(_norm(x), 1e-20)


def shade(view_pos, view_normal, diffuse, shade_mode: int = 0,
          world_normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """shading.glsl:32-69; view_pos/view_normal in GL view space. Mode 0
    textured, 1 Blinn-Phong, 2 normals."""
    if shade_mode == 0:
        return diffuse
    if shade_mode == 2:
        return world_normal if world_normal is not None else view_normal
    if shade_mode != 1:
        return torch.ones_like(diffuse)
    dev = view_pos.device
    light_pos = torch.tensor(_LIGHT_POSITION, dtype=torch.float32, device=dev)
    to_light = _unit(light_pos - view_pos)
    light_angle = (view_normal * to_light).sum(dim=-1)
    lit = light_angle > 0.0
    diff = torch.clamp_min(light_angle, 0.0)
    to_viewer = _unit(-view_pos)
    halfway = _unit(to_light + to_viewer)
    spec = torch.pow(torch.clamp_min((halfway * view_normal).sum(dim=-1),
                                     1e-20), _SHININESS)
    a = (1.0 - light_angle) * (1.0 - light_angle)
    spec = spec * (1.0 - a * (a * a))
    diff = torch.where(lit, diff, 0.0)
    spec = torch.where(lit, spec, 0.0)
    ld = torch.tensor(_LIGHT_DIFFUSE, dtype=torch.float32, device=dev)
    ls = torch.tensor(_LIGHT_SPECULAR, dtype=torch.float32, device=dev)
    return (ld * 0.2 * _SOLID_DIFFUSE + ld * _SOLID_DIFFUSE * diff[..., None]
            + ls * _KS * spec[..., None])
