"""The render's staged march as recon/tsdf_pipeline.py ran it up to commit
70204a5, before its block stages moved to the device (its
render_from_baked verbatim but for the recorded intermediates): the
reference the CPU tests hold ops/render_stages.py's twins and the whole
CPU render against, bit for bit."""

import numpy as np
import torch

from rgbd_recon_tpu_torch.ops import hits as hit_ops
from rgbd_recon_tpu_torch.ops import holefill, raymarch
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import RenderOutput, _uses_sentinels


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


def _first_ids(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The first ``capacity`` True indices of a 1-D mask in ascending order,
    padded with len(mask) (the fixed-size nonzero of the reference)."""
    n = mask.shape[0]
    ids = torch.nonzero(mask).reshape(-1)[:capacity]
    pad = torch.full((capacity - ids.shape[0],), n, dtype=ids.dtype,
                     device=mask.device)
    return torch.cat([ids, pad])


def _scatter_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """buf[idx] = rows, dropping out-of-range idx (mode="drop")."""
    keep = idx < buf.shape[0]
    buf[idx[keep]] = rows[keep]
    return buf


def reference_render(pipe, camera, max_steps=None):
    """``render_from_baked(baked, maps, cam, proj_models, limit, trace)``
    of the pipeline ``pipe`` for ``camera`` as it ran then; ``trace``
    (a dict) receives its intermediates."""
    self = pipe
    c = self.config
    dev = self.device
    H, W = camera.height, camera.width
    near, far = float(camera.near), float(camera.far)
    tan_half = float(np.tan(np.radians(camera.fov_y) * 0.5))
    aspect = W / H
    bbox_size = np.asarray(self.bbox.size, np.float32)
    vol_shape = self.volume_grid.shape
    brick_vox = self.brick_vox

    if max_steps is None:
        # worst case: volume diagonal at limit/2 normalized steps
        max_steps = int(np.ceil(np.sqrt(3.0) / (c.tsdf_limit * 0.5)))
    sd = c.tsdf_limit * 0.5
    blk_budget = min(max_steps, 64)
    # the auto tail budget is what the reference computes,
    # 10*max(phase1, 8)+32 (its docstring says 10*phase1+32)
    tail_budget = (
        min(max_steps, c.march_tail_budget) if c.march_tail_budget > 0
        else min(max_steps, 10 * max(c.march_phase1_steps, 8) + 32)
    )
    ds = max(int(c.interval_downsample), 1)
    Hp, Wp = -(-H // ds) * ds, -(-W // ds) * ds
    Hb, Wb = Hp // ds, Wp // ds
    B2 = ds * ds
    NB = Hb * Wb
    # degenerate-small images (fewer than 4 blocks per axis) and the
    # configs without space skipping march every pixel instead
    use_blocks = (c.skip_space and c.bricking and c.ray_compaction > 0.0
                  and Hb >= 4 and Wb >= 4)
    if not (0.0 < c.interval_step_frac <= 1.0):
        raise ValueError(
            "interval_step_frac must be in (0, 1]: the dilated-set "
            f"detection guarantee breaks beyond 1.0 (got "
            f"{c.interval_step_frac})")
    skip_ = _uses_sentinels(c)
    # the oct hit table needs a brick-aligned volume with an even X
    use_oct = (skip_ and c.oct_hit_table and c.surface_skip
               and brick_vox >= 2
               and all(s % brick_vox == 0 for s in vol_shape)
               and vol_shape[2] % 2 == 0)
    h_min = 1.0 / max(vol_shape)
    brick_norm = brick_vox * h_min
    step_len = c.interval_step_frac * brick_norm
    n_scan = int(np.ceil(np.sqrt(3.0) / step_len)) + 2
    oct_capacity = -(-int(1.2 * c.brick_capacity) // 8) * 8
    # the sentinel table and the oct table in the march dtype
    table_dtype = (torch.bfloat16 if c.march_dtype == "bfloat16"
                   else torch.float32)
    num_lods = c.num_lods
    Z, Y, X = vol_shape
    # the chunked march serves the fine stage's first march
    chunked = c.march_chunk > 0 and c.march_mode == "nearest"
    def ray_dirs(cam, hh, ww):
        """Planar unit volume-space directions, 3x (hh, ww)."""
        xs = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5
              ) / W * 2.0 - 1.0
        ys = 1.0 - (torch.arange(hh, dtype=torch.float32, device=dev)
                    + 0.5) / H * 2.0
        yy, xx = torch.meshgrid(ys * tan_half, xs * tan_half * aspect,
                                indexing="ij")
        dv = [(xx * cam.rot[j, 0] + yy * cam.rot[j, 1] - cam.rot[j, 2])
              / float(bbox_size[j]) for j in range(3)]
        inv_n = torch.rsqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
        return tuple(d * inv_n for d in dv)

    def surface_aabb(occ):
        """Normalized AABB of the surface bricks."""
        def lohi(any_ax, n, true_n):
            idx = torch.arange(n, device=dev)
            lo = torch.where(any_ax, idx, n).min()
            hi = torch.where(any_ax, idx, -1).max()
            return (lo.to(torch.float32) * brick_vox / true_n,
                    torch.clamp_max((hi + 1).to(torch.float32)
                                    * brick_vox / true_n, 1.0))

        Bz, By, Bx = occ.shape
        zlo, zhi = lohi(occ.any(dim=2).any(dim=1), Bz, Z)
        ylo, yhi = lohi(occ.any(dim=2).any(dim=0), By, Y)
        xlo, xhi = lohi(occ.any(dim=1).any(dim=0), Bx, X)
        return torch.stack([xlo, ylo, zlo]), torch.stack([xhi, yhi, zhi])

    def scan_intervals(occ, bsafe, cam, dirs_c):
        """Per coarse ray (first, last, first-surface, s0, s1) arc
        lengths: first sample in the 1-brick-dilated surface set, last
        and first samples in an actual surface brick, and the AABB
        entry/exit (the brick-hull depth peel of the reference)."""
        Bz, By, Bx = occ.shape
        field = torch.where(occ, -1.0,
                            torch.where(bsafe == 0.0, 0.0, 1.0)
                            ).reshape(-1)
        box_min, box_max = surface_aabb(occ)
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
        spacing = torch.clamp_max((s1 - s0) / (n_scan - 1), step_len)
        t = s0[..., None] + ks * spacing[..., None]

        def brick_idx(e, d, n, nb):
            i = ((e + d[..., None] * t) * n).to(torch.int32) // brick_vox
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

    def finalize(rgba, depth_win, hit_img, num_img, overflow):
        if c.colorfill:
            filled, depth_out = holefill.fill_colors_planar(
                [rgba[..., i] for i in range(4)], depth_win, num_lods)
            rgb_planes = filled[:3]
        else:
            rgb_planes = [rgba[..., i] for i in range(3)]
            depth_out = depth_win
        # background compositing: empty pixels keep window depth 1.0
        shown = depth_out < 1.0
        color = torch.stack([torch.where(shown, p, 0.0)
                             for p in rgb_planes], dim=-1)
        return RenderOutput(color=color, depth=depth_out, hit=hit_img,
                            num_samples=num_img, overflow=overflow)
    def do_march(table, limit, budget, pos0, dirs, length, resume=None,
                 chunk=None):
        """The chunked march when ``chunk`` is given and the config
        asks for it, the stepwise march otherwise."""
        if chunked and chunk:
            return raymarch.march_chunked(
                table, limit, budget, (pos0, length), dirs,
                chunk=min(chunk, budget), sentinel_skip=skip_,
                sentinel_scale=h_min, resume=resume)
        return raymarch.march(table, limit, budget, (pos0, length), dirs,
                              mode=c.march_mode, sentinel_skip=skip_,
                              sentinel_scale=h_min, resume=resume)
    def render_from_baked(baked, maps, cam, proj_models, limit, trace):
        """Block march (staged with sentinels, else one full-length
        march) + hit refine + shading + hole fill."""
        table, oct, occ, bsafe = baked
        floor = -limit if skip_ else None   # sentinel clamp
        dn = ray_dirs(cam, Hp, Wp)
        dirs_c = tuple(d[ds // 2::ds, ds // 2::ds] for d in dn)

        # interval scan at half block resolution, 3x3-pooled back up
        sc = 2
        first_c, last_c, fsurf_c, s0_c, s1_c = scan_intervals(
            occ, bsafe, cam, tuple(d[::sc, ::sc] for d in dirs_c))

        def upc(xc, op):
            p = _pool3(xc, op)
            r = p.repeat_interleave(sc, 0).repeat_interleave(sc, 1)
            return r[:Hb, :Wb]

        trace["scan5"] = torch.stack([first_c, last_c, fsurf_c, s0_c, s1_c])
        first = upc(first_c, torch.minimum)
        last = upc(last_c, torch.maximum)
        fsurf = upc(fsurf_c, torch.minimum)
        s0p = upc(s0_c, torch.minimum)
        s1p = upc(s1_c, torch.maximum)
        pad = 0.75 * step_len
        found = torch.isfinite(first) & torch.isfinite(last)
        s_start = torch.maximum(
            torch.maximum(first - pad, fsurf - brick_norm - pad), s0p)
        s_end = torch.minimum(last + step_len + pad, s1p)
        length = torch.where(found, torch.clamp_min(s_end - s_start, 0.0),
                             0.0)
        s_start = torch.where(found, s_start, 0.0)

        # block compaction: fixed-capacity list of active 4x4 blocks
        flags = (length > 0.0).reshape(NB)
        capB = min(NB, max(-(-int(NB * c.ray_compaction) // 8) * 8, 2048))
        blk_idx = _first_ids(flags, capB)
        trace.update(flags=flags, found=found.reshape(NB),
                     s_start=s_start.reshape(NB), s_end=s_end.reshape(NB),
                     length=length.reshape(NB), blk_idx=blk_idx,
                     dirs_c=torch.stack([d.reshape(NB) for d in dirs_c]))
        safe = torch.clamp_max(blk_idx, NB - 1)
        live_b = blk_idx < NB

        # coarse density march: one center ray per active block
        dirs_cb = tuple(d.reshape(NB)[safe] for d in dirs_c)
        sstart_c = torch.where(live_b, s_start.reshape(NB)[safe], 0.0)
        len_c = torch.where(live_b, length.reshape(NB)[safe], 0.0)
        pos0_c = tuple(cam.eye_vol[i] + dirs_cb[i] * sstart_c
                       for i in range(3))
        bhit, _, bst = do_march(table, limit, blk_budget, pos0_c, dirs_cb,
                                len_c)
        blo = sstart_c + bst[3]
        bhi = sstart_c + bst[4]

        inf = float("inf")
        hit_g = _scatter_rows(torch.zeros(NB, device=dev), blk_idx,
                              bhit.to(torch.float32)).reshape(Hb, Wb)
        lo_g = _scatter_rows(torch.full((NB,), inf, device=dev), blk_idx,
                             torch.where(bhit, blo, inf)).reshape(Hb, Wb)
        hi_g = _scatter_rows(torch.full((NB,), -inf, device=dev), blk_idx,
                             torch.where(bhit, bhi, -inf)).reshape(Hb, Wb)
        trace["grid"] = torch.stack([hit_g.reshape(NB), lo_g.reshape(NB),
                                     hi_g.reshape(NB)])
        all9 = _pool3(hit_g, torch.minimum) > 0.5
        lo9 = _pool3(lo_g, torch.minimum)
        hi9 = _pool3(hi_g, torch.maximum)
        margin = c.bracket_margin_steps * sd
        # trust the bracket only when every neighboring block ray hit,
        # it is narrow, and it starts close to the interval entry
        bracket_ok = (
            all9
            & ((hi9 - lo9) < c.bracket_max_steps * sd)
            & ((lo9 - s_start) < 2.0 * brick_norm + pad)
        )
        if c.bracket_per_block:
            # each block's own coarse bracket, widened by 1/8 of the
            # 3x3 spread (the local slope); the guards above keep the
            # pooled values
            spread = 0.125 * (hi9 - lo9)
            b_lo = (torch.where(torch.isfinite(lo_g), lo_g, s_start)
                    - margin - spread)
            b_hi = (torch.where(torch.isfinite(hi_g), hi_g, s_end)
                    + margin + spread)
        else:
            b_lo = lo9 - margin
            b_hi = hi9 + margin
        f_start = torch.where(bracket_ok, torch.maximum(b_lo, s_start),
                              s_start)
        len_brkt = torch.where(
            found & bracket_ok,
            torch.clamp_min(torch.minimum(b_hi, s_end) - f_start, 0.0),
            length)
        len_full = torch.clamp_min(
            torch.where(found, s_end - f_start, 0.0), 0.0)

        # fine march: all rays of the active blocks
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

        dn_f = tuple(to_rays(d) for d in dn)
        sstart_f = per_ray(sstart_b)
        pos0_f = tuple(cam.eye_vol[i] + dn_f[i] * sstart_f
                       for i in range(3))
        len_brkt_f = per_ray(lbrkt_b)
        len_full_f = per_ray(lfull_b)
        # per-ray constants: pos0 (3), dir (3), full length, bracket
        ray8 = torch.stack([*pos0_f, *dn_f, len_full_f, len_brkt_f],
                           dim=-1)
        trace["ray8"] = ray8
        trace["st8"] = []
        trace["tail_idx"] = []

        def state8(hit, num, st, num_base=None):
            n = num.to(torch.float32)
            if num_base is not None:
                n = num_base + n
            return torch.stack([*st, hit.to(torch.float32), n], dim=-1)

        overflow2 = 0
        p1 = c.march_phase1_steps
        if p1 > 0 and skip_:
            hit, num, st = do_march(table, limit, p1, pos0_f, dn_f,
                                    len_brkt_f, chunk=p1)
            st8 = state8(hit, num, st)
            trace["st8"].append(st8.clone())
            budget_used = p1
            # narrowing tail stages over the full interval
            for divisor, budget in ((3, 3 * p1), (10, tail_budget)):
                steps = min(budget, max_steps - budget_used)
                if steps <= 0:
                    break
                unfinished = ((st8[:, 6] < 0.5)
                              & (st8[:, 0] <= ray8[:, 6])
                              & (ray8[:, 6] > 0.0))
                cap_t = max(-(-R // divisor // 8) * 8, min(R, 1024))
                idx2 = _first_ids(unfinished, cap_t)
                safe2 = torch.clamp_max(idx2, R - 1)
                rg = ray8[safe2]
                sg = st8[safe2]
                len2 = torch.where(idx2 < R, rg[:, 6], 0.0)
                hit2, num2, st2 = do_march(
                    table, limit, steps, (rg[:, 0], rg[:, 1], rg[:, 2]),
                    (rg[:, 3], rg[:, 4], rg[:, 5]), len2,
                    resume=(sg[:, 0], sg[:, 1], sg[:, 2]))
                budget_used += steps
                st8 = _scatter_rows(st8, idx2,
                                    state8(hit2, num2, st2, sg[:, 7]))
                trace["st8"].append(st8.clone())
                trace["tail_idx"].append(idx2)
                overflow2 = max(overflow2,
                                int(unfinished.sum()) - cap_t)
        else:
            hit, num, st = do_march(table, limit, max_steps, pos0_f,
                                    dn_f, len_full_f)
            st8 = state8(hit, num, st)
            trace["st8"].append(st8.clone())

        hit = st8[:, 6] > 0.5

        # hit compaction: refine, normals, color and shading run on the
        # hit set only
        hit_frac = c.hit_compaction if c.hit_compaction > 0.0 else 1.0
        capH = min(R, -(-int(R * hit_frac) // 8) * 8)
        hit_idx = _first_ids(hit, capH)
        safeH = torch.clamp_max(hit_idx, R - 1)
        live_h = hit_idx < R
        rh = ray8[safeH]
        sh = st8[safeH]
        pos0_h = (rh[:, 0], rh[:, 1], rh[:, 2])
        dn_h = (rh[:, 3], rh[:, 4], rh[:, 5])
        hit_pos_h = torch.stack([rh[:, i] + rh[:, 3 + i] * sh[:, 5]
                                 for i in range(3)], dim=-1)
        trace.update(hit_idx=hit_idx, hit_pos=hit_pos_h, live=live_h,
                     hit_rows=torch.cat([rh[:, :6], sh[:, 3:5]], dim=1))
        if "refine" in c.debug_skip:
            hp = hit_pos_h        # the march's own secant position
        else:
            # the oct table's refine where there is one, else the
            # march table's
            hp = hit_ops.refine_hits(
                pos0_h, dn_h, sh[:, 3], sh[:, 4], live_h, hit_pos_h,
                limit, oct=oct, table=table, clamp_floor=floor,
                widen_steps=c.refine_widen_steps,
                widen_samples=c.refine_widen_samples)
        rgba_h, depth_h = hit_ops.shade_hits(
            c, self.calib, self.bbox, live_h, hp, maps, proj_models, cam,
            near, far, limit, table, floor, oct)

        hit6 = torch.cat([rgba_h, depth_h[:, None],
                          live_h.to(torch.float32)[:, None]], dim=-1)
        buf6 = _scatter_rows(torch.zeros((R, 6), device=dev), hit_idx,
                             hit6)
        buf8 = torch.cat([buf6, st8[:, 7:8],
                          torch.zeros((R, 1), device=dev)], dim=-1)
        img8_full = _scatter_rows(
            torch.zeros((NB, B2, 8), device=dev), blk_idx,
            buf8.reshape(capB, B2, 8))
        img8 = (img8_full.reshape(Hb, Wb, ds, ds, 8)
                .permute(0, 2, 1, 3, 4).reshape(Hp, Wp, 8)[:H, :W])
        rgba_img = img8[..., :4]
        hit_img = img8[..., 5] > 0.5
        depth_img = torch.where(hit_img, img8[..., 4], 1.0)
        num_img = img8[..., 6].to(torch.int32)

        trace.update(planes=rgba_img.permute(2, 0, 1), depth=depth_img,
                     hit=hit_img, num=num_img)
        overflow = torch.tensor([
            max(int(flags.sum()) - capB, 0),
            overflow2,
            max(int(hit.sum()) - capH, 0),
            max(int(occ.sum()) - oct_capacity, 0) if oct is not None
            else 0,
        ], dtype=torch.int32, device=dev)
        return finalize(rgba_img, depth_img, hit_img, num_img, overflow)
    return render_from_baked
