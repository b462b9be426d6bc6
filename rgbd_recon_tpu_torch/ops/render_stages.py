"""The block stages of the render's staged march (counterpart of
rgbd_recon_tpu/recon/tsdf_pipeline.py:1208 render_from_baked: ray_dirs
:881, surface_aabb :899, scan_intervals :920, upc :1253, the bracket
:1327, ray8 :1390, hit_pos_h :1472 and the image assembly after :1521).

Each stage is a dispatch: CUDA tensors go to csrc/render_stages.cu (one
launch a stage, kernels/render_stages.py), CPU tensors to its plain twin
``<stage>_plain``, the render's torch code. The stages hand each other
device arrays and read nothing back to the host:

  scan         the interval scan of the coarse rays (half block
               resolution): (5, Hs, Ws) first, last, first-surface, s0, s1
               arc lengths; the surface bricks' count into ``counts``
  block_setup  the scan's 3x3 pools at block resolution: the (NB, 8) block
               rows (pos0, dir, length, interval start) of each block's
               centre ray, its interval end, its flags (bit 0 active, bit
               1 an interval found) and the coarse march's (3, NB) hit /
               lo / hi grids, initialised
  bracket      the 3x3 pools of the coarse grids, the bracket, and the
               (R, 8) ray rows (pos0, dir, full length, bracket length) of
               the listed blocks' rays
  hit_gather   the listed hits' rows: (capH, 8) pos0, dir, lo_t, hi_t,
               (capH, 3) secant positions, the live mask
  compose      the image by a gather a pixel through the block and hit
               lists' slot maps: (4, H, W) rgba planes, window depth, hit,
               march steps, and the (4,) overflow vector

Between them the render runs ops/compact.py's compaction and the row
march of ops/raymarch.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """The static sizes and constants of one camera's staged march (Python
    numbers: the render's configuration)."""

    H: int
    W: int
    ds: int                          # block edge in pixels
    sc: int                          # scan stride in blocks
    tan_half: float
    bbox_size: Tuple[float, float, float]
    vol_shape: Tuple[int, int, int]  # (Z, Y, X)
    brick_vox: int
    n_scan: int
    step_len: float
    brick_norm: float
    bracket_max_steps: float
    bracket_margin_steps: float
    sd: float                        # tsdf_limit / 2 of the configuration
    per_block: bool                  # bracket_per_block

    @property
    def Hp(self):
        return -(-self.H // self.ds) * self.ds

    @property
    def Wp(self):
        return -(-self.W // self.ds) * self.ds

    @property
    def Hb(self):
        return self.Hp // self.ds

    @property
    def Wb(self):
        return self.Wp // self.ds

    @property
    def NB(self):
        return self.Hb * self.Wb

    @property
    def B2(self):
        return self.ds * self.ds

    @property
    def Hs(self):
        return -(-self.Hb // self.sc)

    @property
    def Ws(self):
        return -(-self.Wb // self.sc)

    @property
    def aspect(self):
        return self.W / self.H

    @property
    def pad(self):
        return 0.75 * self.step_len


def _pool3(x: torch.Tensor, op) -> torch.Tensor:
    """3x3 min/max pooling with edge padding (tsdf_pipeline pool3)."""
    H, W = x.shape
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    out = x
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = op(out, p[dy: dy + H, dx: dx + W])
    return out


def ray_dirs(g: BlockGeometry, cam, hh: int, ww: int):
    """Planar unit volume-space directions of the first (hh, ww) pixels,
    3x (hh, ww)."""
    dev = cam.rot.device
    xs = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5
          ) / g.W * 2.0 - 1.0
    ys = 1.0 - (torch.arange(hh, dtype=torch.float32, device=dev)
                + 0.5) / g.H * 2.0
    yy, xx = torch.meshgrid(ys * g.tan_half, xs * g.tan_half * g.aspect,
                            indexing="ij")
    dv = [(xx * cam.rot[j, 0] + yy * cam.rot[j, 1] - cam.rot[j, 2])
          / float(g.bbox_size[j]) for j in range(3)]
    inv_n = torch.rsqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
    return tuple(d * inv_n for d in dv)


def _block_centres(g: BlockGeometry, cam):
    """The directions of the blocks' centre rays, 3x (Hb, Wb)."""
    ds = g.ds
    return tuple(d[ds // 2::ds, ds // 2::ds]
                 for d in ray_dirs(g, cam, g.Hp, g.Wp))


# ---- scan -----------------------------------------------------------------

def surface_aabb(g: BlockGeometry, occ: torch.Tensor):
    """Normalized AABB of the surface bricks."""
    dev = occ.device
    Z, Y, X = g.vol_shape
    bv = g.brick_vox

    def lohi(any_ax, n, true_n):
        idx = torch.arange(n, device=dev)
        lo = torch.where(any_ax, idx, n).min()
        hi = torch.where(any_ax, idx, -1).max()
        return (lo.to(torch.float32) * bv / true_n,
                torch.clamp_max((hi + 1).to(torch.float32) * bv / true_n,
                                1.0))

    Bz, By, Bx = occ.shape
    zlo, zhi = lohi(occ.any(dim=2).any(dim=1), Bz, Z)
    ylo, yhi = lohi(occ.any(dim=2).any(dim=0), By, Y)
    xlo, xhi = lohi(occ.any(dim=1).any(dim=0), Bx, X)
    return torch.stack([xlo, ylo, zlo]), torch.stack([xhi, yhi, zhi])


def scan_intervals(g: BlockGeometry, occ, bsafe, cam, dirs_c):
    """Per coarse ray (first, last, first-surface, s0, s1) arc lengths:
    first sample in the 1-brick-dilated surface set, last and first
    samples in an actual surface brick, and the AABB entry/exit (the
    brick-hull depth peel of the reference)."""
    dev = occ.device
    Z, Y, X = g.vol_shape
    bv = g.brick_vox
    n_scan = g.n_scan
    Bz, By, Bx = occ.shape
    field = torch.where(occ, -1.0,
                        torch.where(bsafe == 0.0, 0.0, 1.0)).reshape(-1)
    box_min, box_max = surface_aabb(g, occ)
    dcx, dcy, dcz = dirs_c

    def slab(c0, d, lo, hi):
        inv = 1.0 / d
        tb = inv * (lo - c0)
        tt = inv * (hi - c0)
        return torch.minimum(tb, tt), torch.maximum(tb, tt)

    l0, h0 = slab(cam.eye_vol[0], dcx, box_min[0], box_max[0])
    l1, h1 = slab(cam.eye_vol[1], dcy, box_min[1], box_max[1])
    l2, h2 = slab(cam.eye_vol[2], dcz, box_min[2], box_max[2])
    s0 = torch.maximum(torch.maximum(l0, l1), l2)
    s1 = torch.minimum(torch.minimum(h0, h1), h2)
    valid = (s0 <= s1) & (s1 > 0.0)
    s0 = torch.clamp_min(s0, 0.0)
    s1 = torch.where(valid, s1, -1.0)
    ks = torch.arange(n_scan, dtype=torch.float32, device=dev)
    spacing = torch.clamp_max((s1 - s0) / (n_scan - 1), g.step_len)
    t = s0[..., None] + ks * spacing[..., None]

    def brick_idx(e, d, n, nb):
        i = ((e + d[..., None] * t) * n).to(torch.int32) // bv
        return torch.clamp(i, 0, nb - 1)

    bx = brick_idx(cam.eye_vol[0], dcx, X, Bx)
    by = brick_idx(cam.eye_vol[1], dcy, Y, By)
    bz = brick_idx(cam.eye_vol[2], dcz, Z, Bz)
    s = field[((bz * By + by) * Bx + bx).to(torch.int64)]
    inside = valid[..., None] & (t <= s1[..., None])
    tgt = (s < 0.5) & inside
    surf = (s < -0.5) & inside
    inf = float("inf")
    first = torch.where(tgt, t, inf).min(dim=-1).values
    last = torch.where(surf, t, -inf).max(dim=-1).values
    fsurf = torch.where(surf, t, inf).min(dim=-1).values
    return first, last, fsurf, s0, torch.where(valid, s1, 0.0)


def scan_plain(g: BlockGeometry, occ: torch.Tensor, bsafe: torch.Tensor,
               cam, counts: torch.Tensor, count_slot: int) -> torch.Tensor:
    """The interval scan at half block resolution: (5, Hs, Ws) first,
    last, first-surface, s0, s1 (:func:`scan_intervals` of the coarse rays
    of every ``sc``-th block); ``counts[count_slot]`` receives the number
    of surface bricks."""
    sc = g.sc
    dirs_c = _block_centres(g, cam)
    out = scan_intervals(g, occ, bsafe, cam,
                         tuple(d[::sc, ::sc] for d in dirs_c))
    counts[count_slot] = occ.sum(dtype=torch.int32)
    return torch.stack(out)


def scan(g: BlockGeometry, occ: torch.Tensor, bsafe: torch.Tensor, cam,
         counts: torch.Tensor, count_slot: int) -> torch.Tensor:
    """:func:`scan_plain`: one launch of csrc/render_stages.cu's scan on
    CUDA tensors, the plain version on CPU tensors."""
    if occ.device.type == "cpu":
        return scan_plain(g, occ, bsafe, cam, counts, count_slot)
    from ..kernels.render_stages import scan_cuda

    return scan_cuda(g, occ, bsafe, cam, counts, count_slot)


# ---- block set-up -----------------------------------------------------------

def block_setup_plain(g: BlockGeometry, scan5: torch.Tensor, cam):
    """The scan's pools at block resolution and each block's interval:
    (blk (NB, 8): the centre ray's pos0 at the interval start, its
    direction, the interval length (0 without one), the start; s_end (NB,);
    flags (NB,) uint8: bit 0 length > 0, bit 1 an interval found; grid
    (3, NB): hit 0, lo inf, hi -inf)."""
    Hb, Wb, NB, sc = g.Hb, g.Wb, g.NB, g.sc
    dev = scan5.device
    first_c, last_c, fsurf_c, s0_c, s1_c = scan5

    def upc(xc, op):
        p = _pool3(xc, op)
        r = p.repeat_interleave(sc, 0).repeat_interleave(sc, 1)
        return r[:Hb, :Wb]

    first = upc(first_c, torch.minimum)
    last = upc(last_c, torch.maximum)
    fsurf = upc(fsurf_c, torch.minimum)
    s0p = upc(s0_c, torch.minimum)
    s1p = upc(s1_c, torch.maximum)
    pad = g.pad
    found = torch.isfinite(first) & torch.isfinite(last)
    s_start = torch.maximum(
        torch.maximum(first - pad, fsurf - g.brick_norm - pad), s0p)
    s_end = torch.minimum(last + g.step_len + pad, s1p)
    length = torch.where(found, torch.clamp_min(s_end - s_start, 0.0), 0.0)
    s_start = torch.where(found, s_start, 0.0).reshape(NB)
    dirs_c = tuple(d.reshape(NB) for d in _block_centres(g, cam))
    pos0 = tuple(cam.eye_vol[i] + dirs_c[i] * s_start for i in range(3))
    blk = torch.stack([*pos0, *dirs_c, length.reshape(NB), s_start], dim=-1)
    flags = ((length > 0.0).reshape(NB).to(torch.uint8)
             | (found.reshape(NB).to(torch.uint8) << 1))
    inf = float("inf")
    grid = torch.stack([torch.zeros(NB, device=dev),
                        torch.full((NB,), inf, device=dev),
                        torch.full((NB,), -inf, device=dev)])
    return blk, s_end.reshape(NB), flags, grid


def block_setup(g: BlockGeometry, scan5: torch.Tensor, cam):
    """:func:`block_setup_plain`: one launch of csrc/render_stages.cu's
    block set-up on CUDA tensors, the plain version on CPU tensors."""
    if scan5.device.type == "cpu":
        return block_setup_plain(g, scan5, cam)
    from ..kernels.render_stages import block_setup_cuda

    return block_setup_cuda(g, scan5, cam)


# ---- bracket ----------------------------------------------------------------

def bracket_plain(g: BlockGeometry, grid: torch.Tensor, blk: torch.Tensor,
                  s_end: torch.Tensor, flags: torch.Tensor,
                  blk_idx: torch.Tensor, cam) -> torch.Tensor:
    """The coarse march's bracket of each block and the fine march's ray
    rows: (R, 8) pos0 at the start, direction, full length, bracket length
    of the rays of the listed blocks ``blk_idx`` (R = capacity x B2, a
    block's rays in row-major order; the padding's rows start at the eye
    with length 0)."""
    Hb, Wb, NB, ds, B2 = g.Hb, g.Wb, g.NB, g.ds, g.B2
    hit_g, lo_g, hi_g = (grid[i].reshape(Hb, Wb) for i in range(3))
    s_start = blk[:, 7].reshape(Hb, Wb)
    length = blk[:, 6].reshape(Hb, Wb)
    s_end = s_end.reshape(Hb, Wb)
    found = ((flags >> 1) & 1).to(torch.bool).reshape(Hb, Wb)
    pad, sd = g.pad, g.sd
    all9 = _pool3(hit_g, torch.minimum) > 0.5
    lo9 = _pool3(lo_g, torch.minimum)
    hi9 = _pool3(hi_g, torch.maximum)
    margin = g.bracket_margin_steps * sd
    # trust the bracket only when every neighboring block ray hit, it is
    # narrow, and it starts close to the interval entry
    bracket_ok = (
        all9
        & ((hi9 - lo9) < g.bracket_max_steps * sd)
        & ((lo9 - s_start) < 2.0 * g.brick_norm + pad)
    )
    if g.per_block:
        # each block's own coarse bracket, widened by 1/8 of the 3x3
        # spread (the local slope); the guards above keep the pooled values
        spread = 0.125 * (hi9 - lo9)
        b_lo = (torch.where(torch.isfinite(lo_g), lo_g, s_start)
                - margin - spread)
        b_hi = (torch.where(torch.isfinite(hi_g), hi_g, s_end)
                + margin + spread)
    else:
        b_lo = lo9 - margin
        b_hi = hi9 + margin
    f_start = torch.where(bracket_ok, torch.maximum(b_lo, s_start), s_start)
    len_brkt = torch.where(
        found & bracket_ok,
        torch.clamp_min(torch.minimum(b_hi, s_end) - f_start, 0.0),
        length)
    len_full = torch.clamp_min(
        torch.where(found, s_end - f_start, 0.0), 0.0)

    # fine march: all rays of the active blocks
    capB = blk_idx.shape[0]
    safe = torch.clamp_max(blk_idx, NB - 1)
    live_b = blk_idx < NB
    sstart_b = torch.where(live_b, f_start.reshape(NB)[safe], 0.0)
    lbrkt_b = torch.where(live_b, len_brkt.reshape(NB)[safe], 0.0)
    lfull_b = torch.where(live_b, len_full.reshape(NB)[safe], 0.0)
    R = capB * B2

    def to_rays(plane):
        blocks = (plane.reshape(Hb, ds, Wb, ds).permute(0, 2, 1, 3)
                  .reshape(NB, B2))
        return blocks[safe].reshape(R)

    def per_ray(x):
        return x[:, None].expand(capB, B2).reshape(R)

    dn_f = tuple(to_rays(d) for d in ray_dirs(g, cam, g.Hp, g.Wp))
    sstart_f = per_ray(sstart_b)
    pos0_f = tuple(cam.eye_vol[i] + dn_f[i] * sstart_f for i in range(3))
    return torch.stack([*pos0_f, *dn_f, per_ray(lfull_b), per_ray(lbrkt_b)],
                       dim=-1)


def bracket(g: BlockGeometry, grid: torch.Tensor, blk: torch.Tensor,
            s_end: torch.Tensor, flags: torch.Tensor, blk_idx: torch.Tensor,
            cam) -> torch.Tensor:
    """:func:`bracket_plain`: one launch of csrc/render_stages.cu's bracket
    on CUDA tensors, the plain version on CPU tensors."""
    if grid.device.type == "cpu":
        return bracket_plain(g, grid, blk, s_end, flags, blk_idx, cam)
    from ..kernels.render_stages import bracket_cuda

    return bracket_cuda(g, grid, blk, s_end, flags, blk_idx, cam)


# ---- hits -------------------------------------------------------------------

def hit_gather_plain(ray8: torch.Tensor, st8: torch.Tensor,
                     hit_idx: torch.Tensor):
    """The listed hits' inputs to the refine and the shade: (rows (capH, 8)
    pos0, direction, lo_t, hi_t; positions (capH, 3) pos0 + dir * hit_t;
    live (capH,) bool: the entry is no padding)."""
    R = ray8.shape[0]
    safe = torch.clamp_max(hit_idx, R - 1)
    live = hit_idx < R
    rh = ray8[safe]
    sh = st8[safe]
    rows = torch.cat([rh[:, :6], sh[:, 3:5]], dim=1)
    pos = torch.stack([rh[:, i] + rh[:, 3 + i] * sh[:, 5] for i in range(3)],
                      dim=-1)
    return rows, pos, live


def hit_gather(ray8: torch.Tensor, st8: torch.Tensor,
               hit_idx: torch.Tensor):
    """:func:`hit_gather_plain`: one launch of csrc/render_stages.cu's hit
    gather on CUDA tensors, the plain version on CPU tensors."""
    if ray8.device.type == "cpu":
        return hit_gather_plain(ray8, st8, hit_idx)
    from ..kernels.render_stages import hit_gather_cuda

    return hit_gather_cuda(ray8, st8, hit_idx)


# ---- compose ----------------------------------------------------------------

# The (NUM_COUNTS,) int32 list counts a render keeps on the device, by slot:
# the block list, the tail stages' lists, the hit list and the surface
# bricks (against the oct table). compact and scan write their slot;
# compose turns them into the (4,) overflow [blocks, the larger tail,
# hits, surface bricks] (csrc/render_stages.cu compose_kernel reads the
# same slots).
COUNT_BLOCKS, COUNT_TAILS, COUNT_HITS, COUNT_SURFACE = 0, (1, 2), 3, 4
NUM_COUNTS = 5


def count_caps(blocks: int, tails, hits: int, surface: int):
    """The capacity of each count slot: ``tails`` holds one capacity for
    each tail stage that runs; a list that is not made (a tail stage that
    does not run, ``surface`` -1 without the oct table) has -1."""
    caps = [-1] * NUM_COUNTS
    caps[COUNT_BLOCKS], caps[COUNT_HITS] = blocks, hits
    caps[COUNT_SURFACE] = surface
    for slot, cap in zip(COUNT_TAILS, tails):
        caps[slot] = cap
    return caps


def overflow_plain(counts: torch.Tensor, caps) -> torch.Tensor:
    """(4,) int32 [blocks past their list, the most rays past a tail
    stage's list, hits past theirs, surface bricks past the oct table] from
    the list ``counts``, each against its capacity in ``caps``
    (:func:`count_caps`; a negative capacity: the list was not made, it
    counts 0)."""
    zero = torch.zeros((), dtype=torch.int32, device=counts.device)

    def past(k):
        if caps[k] < 0:
            return zero
        return torch.clamp_min(counts[k] - caps[k], 0)

    tail = past(COUNT_TAILS[0])
    for k in COUNT_TAILS[1:]:
        tail = torch.maximum(tail, past(k))
    return torch.stack([past(COUNT_BLOCKS), tail, past(COUNT_HITS),
                        past(COUNT_SURFACE)]).to(torch.int32)


def compose_plain(g: BlockGeometry, blk_slot: torch.Tensor,
                  hit_slot: torch.Tensor, st8: torch.Tensor,
                  rgba_h: torch.Tensor, depth_h: torch.Tensor,
                  counts: torch.Tensor, caps):
    """The pre-fill image, a pixel at a time through the slot maps: its
    block's place in the block list, its ray's row, the row's place in the
    hit list. Returns ((4, H, W) rgba planes, (H, W) window depth (1 off
    the hits), (H, W) hit mask, (H, W) int32 march steps, the (4,) int32
    overflow of :func:`overflow_plain`)."""
    H, W, ds, Wb, B2 = g.H, g.W, g.ds, g.Wb, g.B2
    dev = st8.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    b = (yy // ds) * Wb + xx // ds
    k = (yy % ds) * ds + xx % ds
    sb = blk_slot[b]
    in_b = sb >= 0
    r = torch.clamp_min(sb, 0).to(torch.int64) * B2 + k
    num = torch.where(in_b, st8[r, 7], 0.0).to(torch.int32)
    hs = torch.where(in_b, hit_slot[r], -1)
    hit = hs >= 0
    hsafe = torch.clamp_min(hs, 0).to(torch.int64)
    planes = torch.where(hit[None], rgba_h[hsafe].permute(2, 0, 1), 0.0)
    depth = torch.where(hit, depth_h[hsafe], 1.0)
    return planes, depth, hit, num, overflow_plain(counts, caps)


def compose(g: BlockGeometry, blk_slot: torch.Tensor,
            hit_slot: torch.Tensor, st8: torch.Tensor, rgba_h: torch.Tensor,
            depth_h: torch.Tensor, counts: torch.Tensor, caps):
    """:func:`compose_plain`: one launch of csrc/render_stages.cu's compose
    on CUDA tensors, the plain version on CPU tensors."""
    if st8.device.type == "cpu":
        return compose_plain(g, blk_slot, hit_slot, st8, rgba_h, depth_h,
                             counts, caps)
    from ..kernels.render_stages import compose_cuda

    return compose_cuda(g, blk_slot, hit_slot, st8, rgba_h, depth_h, counts,
                        caps)

