"""The flagship reconstruction pipeline: preprocess -> integrate -> staged
raymarch (counterpart of rgbd_recon_tpu/recon/tsdf_pipeline.py).

  frames --preprocess (5-pass chain)--> sensor maps
         --brick marking (histogram)--> occupancy counts
         --TSDF integration (brick-compact, or dense)--> volume
         --bake (surface bricks; sentinel march table and oct hit table
           on the fast path, the raw f32 volume otherwise)
         --block-compacted staged march (or a full-screen march)
           + secant refine + gradient + blend--> hits
         --pull-push colorfill--> final frame

This port covers the fast configuration and the reference-exact parity
configuration with their variants; the configuration values it does not
implement raise NotImplementedError naming the value (check_supported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rgbd_recon_tpu.core.config import PipelineConfig
from rgbd_recon_tpu.core.grid import BoundingBox, BrickGrid, VolumeGrid

from ..calib.sensors import (
    CalibrationSet,
    derive_pixel_models,
    derive_projection_models,
)
from ..ops import bake as bake_ops
from ..ops import bricks as brick_ops
from ..ops import holefill, raymarch, tsdf
from ..ops.preprocess import SensorMaps, preprocess_frames
from ..ops.sampling import trilinear_3d
from ..sensors.frames import FrameSet


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    """Final render + debug maps."""

    color: torch.Tensor        # (H, W, 3) final shaded image
    depth: torch.Tensor        # (H, W) window depth [0, 1]
    hit: torch.Tensor          # (H, W) bool surface mask
    num_samples: torch.Tensor  # (H, W) int32 march step counts
    # (4,) int32 [active blocks beyond block capacity, tail rays beyond
    # tail capacity, hits beyond hit-shading capacity, surface bricks
    # beyond the oct table capacity]; nonzero means pixels were dropped
    overflow: torch.Tensor = None


@dataclasses.dataclass(frozen=True)
class CamParams:
    """Render-camera pose as tensors."""

    eye_w: torch.Tensor    # (3,) world-space eye
    rot: torch.Tensor      # (3, 3) camera-to-world rotation (GL convention)
    eye_vol: torch.Tensor  # (3,) eye in volume-normalized coords

    @classmethod
    def from_camera(cls, camera: raymarch.ViewCamera, bbox: BoundingBox,
                    device="cpu") -> "CamParams":
        eye = np.asarray(camera.eye, np.float32)
        return cls(
            eye_w=torch.from_numpy(eye).to(device),
            rot=torch.from_numpy(camera.rotation()).to(device),
            eye_vol=torch.from_numpy(bbox.normalize(eye)).to(device),
        )

    @classmethod
    def from_matrix(cls, mat, bbox: BoundingBox, device="cpu") -> "CamParams":
        """Pose from a 4x4 camera-to-world matrix (GL convention: camera
        looks along -z), the form the feedback channel delivers
        (FeedbackReceiver cyclops/model mats, kinect_client.cpp:637-673)."""
        m = np.asarray(mat, np.float32)
        eye = np.ascontiguousarray(m[:3, 3])
        return cls(
            eye_w=torch.from_numpy(eye).to(device),
            rot=torch.from_numpy(np.ascontiguousarray(m[:3, :3])).to(device),
            eye_vol=torch.from_numpy(bbox.normalize(eye)).to(device),
        )


def _uses_sentinels(c: PipelineConfig) -> bool:
    """The render marches a bf16 skip-sentinel table (else the raw f32
    volume) exactly when the march is nearest with empty-space skipping."""
    return c.march_empty_skip and c.march_mode == "nearest"


def check_supported(c: PipelineConfig) -> None:
    """Raise NotImplementedError for configuration values this port does not
    implement yet. ``recon_mode`` is not among them: it picks the renderer
    (the app's choice), and the pipeline fuses in every mode."""
    unsupported = {
        "march_chunk": c.march_chunk > 0,
        "bracket_per_block": bool(c.bracket_per_block),
        "blend_mode": c.blend_mode != "quality",
        "shade_mode": c.shade_mode == 3,
        "debug_skip": bool(c.debug_skip),
        # an f32 sentinel table needs an f32 output of the bake kernel
        "march_dtype": _uses_sentinels(c) and c.march_dtype != "bfloat16",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(f"{k}={getattr(c, k)!r}"
                                           for k in bad))


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


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def _scatter_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """buf[idx] = rows, dropping out-of-range idx (mode="drop")."""
    keep = idx < buf.shape[0]
    buf[idx[keep]] = rows[keep]
    return buf


class TsdfPipeline:
    """Owns the grids, the baked projections and the calibration fits for
    one scene setup; ``fuse`` and ``make_renderer`` are the entry points."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None,
                 bbox: BoundingBox = None):
        self.config = config or PipelineConfig()
        check_supported(self.config)
        self.bbox = bbox or calib.bbox
        self.calib = calib
        self.device = calib.device
        # the reference computes these products in full f32; TF32 would keep
        # ~3 decimal digits (the only matmuls are in the render's shading
        # transform and the hole-fill resampling)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._limit = float(np.float32(self.config.tsdf_limit))
        self._pixel_models_cache = {}
        self._projection_models = None   # (models or None,) once fitted
        self._build_grids()

    def _build_grids(self):
        c = self.config
        self.volume_grid = VolumeGrid(bbox=self.bbox, voxel_size=c.voxel_size)
        self.brick_grid = BrickGrid(bbox=self.bbox, brick_size=c.brick_size,
                                    min_voxels=c.min_voxels_per_brick)
        ratio = c.brick_size / c.voxel_size
        self.brick_vox = int(round(ratio))
        self.compact = (
            c.bricking and abs(ratio - self.brick_vox) < 1e-6
            and self.brick_vox >= 1
            and tsdf.brick_layout(self.volume_grid.shape, self.brick_vox)[0]
            == self.brick_grid.shape
        )
        # frame-invariant per-voxel projections, brick-major for the compact
        # integration, dense otherwise (None: looked up every frame)
        if self.compact:
            self.projections = tsdf.bake_projections_bricks(
                self.calib.cv_xyz_inv, self.volume_grid.shape,
                self.brick_vox)
        elif c.precompute_projections:
            self.projections = tsdf.bake_projections(
                self.calib.cv_xyz_inv, self.volume_grid.shape)
        else:
            self.projections = None

    def _get_pixel_models(self, depth_hw):
        """Per-pixel calibration closed forms for this depth resolution,
        fitted once; None when disabled or when the fit residual exceeds
        ~1 depth pixel (the preprocess chain then samples the volumes)."""
        if not self.config.pixel_ray_model:
            return None
        key = tuple(depth_hw)
        if key not in self._pixel_models_cache:
            models, residual = derive_pixel_models(
                self.calib.cv_xyz, self.calib.cv_uv, key)
            if residual > 2e-3:
                print(f"pixel-ray model residual {residual:.2e} too large; "
                      "falling back to calibration-volume lookups")
                models = None
            self._pixel_models_cache[key] = models
        return self._pixel_models_cache[key]

    def _get_projection_models(self):
        """Analytic world -> sensor models for the color blend, fitted once;
        None when disabled or when the fit residual exceeds ~one sensor
        pixel (2e-3 normalized units): the blend then goes through the
        calibration volumes."""
        if not self.config.projection_model:
            return None
        if self._projection_models is None:
            models, residual = derive_projection_models(
                self.calib.cv_xyz, self.calib.cv_uv)
            if residual > 2e-3:
                print(f"projection-model residual {residual:.2e} too large; "
                      "blending through calibration volumes")
                models = None
            self._projection_models = (models,)
        return self._projection_models[0]

    # -- fuse -----------------------------------------------------------------

    def _mark_bricks(self, pixel_models, maps: SensorMaps) -> torch.Tensor:
        """Brick occupancy from valid depth pixels (pre_normal.fs side
        effect). With mark_stride s > 1 every s-th pixel scatters s^2
        counts."""
        N, H, W = maps.depth.shape[:3]
        s = max(int(self.config.mark_stride), 1)
        d_all = maps.depth[..., 0]
        if s > 1:
            d_all = d_all[:, s // 2::s, s // 2::s]
        valids = (d_all > 0.0) & (d_all < 1.0)
        if pixel_models is not None:
            ray_a, ray_b = pixel_models.ray_a, pixel_models.ray_b
            if s > 1:
                ray_a = ray_a[:, s // 2::s, s // 2::s]
                ray_b = ray_b[:, s // 2::s, s // 2::s]
            worlds = torch.stack([ray_a[..., j] + ray_b[..., j] * d_all
                                  for j in range(3)], dim=-1)
        else:
            dev = d_all.device
            u = (torch.arange(W, dtype=torch.float32, device=dev)[s // 2::s]
                 + 0.5) / W
            v = (torch.arange(H, dtype=torch.float32, device=dev)[s // 2::s]
                 + 0.5) / H
            vv, uu = torch.meshgrid(v, u, indexing="ij")
            worlds = torch.stack([
                trilinear_3d(self.calib.cv_xyz[i],
                             torch.stack([uu, vv, d_all[i]], dim=-1))
                for i in range(N)
            ])
        counts = brick_ops.mark_bricks(
            worlds, valids, self.calib.bbox_min, self.config.brick_size,
            self.brick_grid.res)
        return counts * (s * s)

    def preprocess(self, frames: FrameSet):
        """frames -> (SensorMaps, (Bz, By, Bx) int32 brick counts)."""
        c = self.config
        calib = self.calib
        pm = self._get_pixel_models(frames.depths.shape[1:3])
        maps = preprocess_frames(
            frames.depths, frames.colors, calib.cv_xyz, calib.cv_uv,
            calib.bbox_min, calib.bbox_max, calib.depth_limits,
            calib.camera_positions, morph=c.morph,
            bilateral=c.bilateral and c.processed, refine=c.refine,
            pixel_models=pm,
        )
        return maps, self._mark_bricks(pm, maps)

    def _voxel_mask(self, brick_counts: torch.Tensor):
        """Per-voxel gate of the dense integration: the occupied bricks'
        voxels, or None without bricking."""
        c = self.config
        if not c.bricking:
            return None
        occ = brick_ops.occupied_mask(brick_counts, c.min_voxels_per_brick)
        return brick_ops.expand_mask_to_voxel_grid(
            occ, self.volume_grid.shape,
            tuple(float(s) for s in self.bbox.size), c.brick_size)

    def integrate(self, maps: SensorMaps, brick_counts: torch.Tensor,
                  limit: Optional[float] = None) -> torch.Tensor:
        """Brick-compact integration of the occupied bricks when the brick
        edge is a whole number of voxels, else dense integration gated by
        the occupied bricks (ungated without bricking)."""
        c = self.config
        lim = self._limit if limit is None else float(np.float32(limit))
        if not self.compact:
            return tsdf.integrate(
                self.volume_grid.shape, self.calib.cv_xyz_inv,
                maps.depth[..., 0], maps.quality, maps.silhouette, lim,
                voxel_mask=self._voxel_mask(brick_counts),
                projections=self.projections,
                carve_sil_threshold=c.carve_sil_threshold,
                phantom_hull=c.phantom_hull,
            )
        ids = tsdf.occupied_brick_ids(brick_counts, c.min_voxels_per_brick,
                                      c.brick_capacity)
        return tsdf.integrate_bricks(
            self.projections, ids, maps.depth[..., 0], maps.quality,
            maps.silhouette, lim, self.volume_grid.shape, self.brick_vox,
            carve_sil_threshold=c.carve_sil_threshold,
            phantom_hull=c.phantom_hull, taps=c.integrate_taps,
        )

    def fuse(self, frames: FrameSet):
        """One fused frame update: preprocess + mark + integrate. Returns
        (volume, maps, brick_counts)."""
        maps, counts = self.preprocess(frames)
        return self.integrate(maps, counts), maps, counts

    def diagnostics(self, brick_counts: torch.Tensor,
                    render_out: Optional[RenderOutput] = None) -> dict:
        """Host-side overflow/occupancy report for one frame: occupied brick
        count vs the compact-integration capacity, plus the render's
        block/ray/hit/oct capacity drops. Any nonzero ``*_dropped`` means
        geometry or pixels were lost to a fixed capacity this frame: raise
        ``brick_capacity`` / ``ray_compaction`` / ``hit_compaction``."""
        c = self.config
        n_occ = int((brick_counts > c.min_voxels_per_brick).sum())
        out = {
            "occupied_bricks": n_occ,
            "brick_capacity": c.brick_capacity,
            "bricks_dropped": (max(0, n_occ - c.brick_capacity)
                               if self.compact else 0),
        }
        if render_out is not None and render_out.overflow is not None:
            ov = render_out.overflow.tolist()
            out["blocks_dropped"] = ov[0]
            out["phase2_rays_dropped"] = ov[1]
            out["hits_dropped"] = ov[2]
            if len(ov) > 3:
                out["oct_bricks_dropped"] = ov[3]
        return out

    # -- render ---------------------------------------------------------------

    def _shade_hits(self, hit, hit_pos, maps: SensorMaps, proj_models,
                    cam: CamParams, near: float, far: float, limit: float,
                    table: torch.Tensor, clamp_floor=None,
                    oct: Optional[raymarch.OctVolume] = None):
        """Normal, color blend and shading at the hit positions. The normal
        is the analytic oct-cell gradient with an oct table, else the
        central-difference gradient of the march table; the blend goes
        through the projection models when they fit, else through the
        calibration volumes. Returns (rgba, window depth)."""
        c = self.config
        calib = self.calib
        bbox_sz = torch.from_numpy(np.asarray(self.bbox.size, np.float32)
                                   ).to(hit_pos.device)
        if oct is not None:
            g, gvalid = oct.gradient_p(hit_pos[..., 0], hit_pos[..., 1],
                                       hit_pos[..., 2])
            grad = -g / torch.clamp_min(_norm(g), 1e-20)
            # hits anchored off the oct table shade with a toward-camera
            # normal
            w = cam.eye_w - (hit_pos * bbox_sz + calib.bbox_min)
            fb = w * bbox_sz
            fb = fb / torch.clamp_min(_norm(fb), 1e-20)
            grad = torch.where(gvalid[..., None], grad, fb)
        else:
            grad = raymarch.gradient_normal(table, hit_pos, limit,
                                            mode=c.march_mode,
                                            clamp_floor=clamp_floor)
        n_world = grad / bbox_sz
        n_world = n_world / torch.clamp_min(_norm(n_world), 1e-20)

        world_pos = hit_pos * bbox_sz + calib.bbox_min
        view_pos = (world_pos - cam.eye_w) @ cam.rot
        view_normal = n_world @ cam.rot
        if proj_models is not None:
            rgba = raymarch.blend_colors_analytic(
                world_pos, proj_models, maps.color, maps.depth[..., 0],
                maps.quality, limit, dq_taps=c.integrate_taps)
        else:
            blend = (raymarch.blend_colors_fast if c.march_mode == "nearest"
                     else raymarch.blend_colors)
            rgba = blend(hit_pos, calib.cv_xyz_inv, calib.cv_uv, maps.color,
                         maps.depth[..., 0], maps.quality, limit)
        shaded = raymarch.shade(view_pos, view_normal, rgba[..., :3],
                                shade_mode=c.shade_mode, world_normal=n_world)
        rgba = torch.cat([shaded, rgba[..., 3:]], dim=-1)
        view_z = torch.clamp_min(-view_pos[..., 2], near * 1.001)
        depth_win = torch.clamp(
            (1.0 / near - 1.0 / view_z) / (1.0 / near - 1.0 / far), 0.0, 1.0)
        depth_win = torch.where(hit, depth_win, 1.0)
        rgba = torch.where(hit[..., None], rgba, 0.0)
        return rgba, depth_win

    def make_render_fn(self, camera: raymarch.ViewCamera,
                       max_steps: Optional[int] = None):
        """Build the render function for ``camera``'s projection. Returns
        ``(render, cam0)`` with ``render(volume, maps, brick_counts, cam,
        proj_models, limit) -> RenderOutput`` and ``cam0`` the camera's
        CamParams. On the block path (``render.use_blocks``),
        ``render.bake(volume, brick_counts)`` and
        ``render.render_from_baked(baked, maps, cam, proj_models, limit)``
        are its two halves; otherwise ``render`` is one full-screen march
        and ``render_from_baked`` is None."""
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
        num_lods = c.num_lods
        Z, Y, X = vol_shape

        def ray_dirs(cam: CamParams, hh, ww):
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

        def scan_intervals(occ, bsafe, cam: CamParams, dirs_c):
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

        def bake(volume, brick_counts):
            """volume -> (march table, oct hit table or None, surface-brick
            mask, brick clearance field). The surface-brick mask is the
            bricks whose 1-voxel dilation holds a positive voxel, or the
            marked occupancy without ``surface_skip``. The march table is
            the bf16 skip-sentinel table with sentinels, else the raw f32
            volume."""
            volume = volume.contiguous()
            if c.surface_skip:
                occ = bake_ops.surface_occ(volume, brick_vox)
            else:
                occ = brick_ops.occupied_mask(brick_counts,
                                              c.min_voxels_per_brick)
            # brick-level clearance to the surface bricks (plain torch)
            bsafe = bake_ops.fine_safe_field(occ, c.skip_brick_rounds)
            if not skip_:
                return volume, None, occ, bsafe
            table = bake_ops.sentinel_bake(
                volume, (bsafe * float(brick_vox)).contiguous(), brick_vox,
                c.skip_fine_rounds)
            oct = (raymarch.build_oct_bricks(volume, occ, brick_vox,
                                             oct_capacity)
                   if use_oct else None)
            return table, oct, occ, bsafe

        def do_march(table, limit, budget, pos0, dirs, length, resume=None):
            return raymarch.march(table, limit, budget, (pos0, length), dirs,
                                  mode=c.march_mode, sentinel_skip=skip_,
                                  sentinel_scale=h_min, resume=resume)

        def render_from_baked(baked, maps: SensorMaps, cam: CamParams,
                              proj_models, limit):
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

            def state8(hit, num, st, num_base=None):
                n = num.to(torch.float32)
                if num_base is not None:
                    n = num_base + n
                return torch.stack([*st, hit.to(torch.float32), n], dim=-1)

            overflow2 = 0
            p1 = c.march_phase1_steps
            if p1 > 0 and skip_:
                hit, num, st = do_march(table, limit, p1, pos0_f, dn_f,
                                        len_brkt_f)
                st8 = state8(hit, num, st)
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
                    overflow2 = max(overflow2,
                                    int(unfinished.sum()) - cap_t)
            else:
                hit, num, st = do_march(table, limit, max_steps, pos0_f,
                                        dn_f, len_full_f)
                st8 = state8(hit, num, st)

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
            if oct is not None:
                hp = raymarch.oct_refine_crossing(
                    oct, pos0_h, dn_h, sh[:, 3], sh[:, 4], live_h,
                    hit_pos_h, limit, widen_steps=c.refine_widen_steps,
                    widen_samples=c.refine_widen_samples)
            else:
                hp = raymarch.refine_crossing(
                    table, pos0_h, dn_h, sh[:, 3], sh[:, 4], live_h,
                    hit_pos_h, clamp_floor=floor)
            rgba_h, depth_h = self._shade_hits(
                live_h, hp, maps, proj_models, cam, near, far, limit, table,
                clamp_floor=floor, oct=oct)

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

            overflow = torch.tensor([
                max(int(flags.sum()) - capB, 0),
                overflow2,
                max(int(hit.sum()) - capH, 0),
                max(int(occ.sum()) - oct_capacity, 0) if oct is not None
                else 0,
            ], dtype=torch.int32, device=dev)
            return finalize(rgba_img, depth_img, hit_img, num_img, overflow)

        def render_dense(volume, maps: SensorMaps, cam: CamParams,
                         proj_models, limit):
            """Full-screen march of the raw volume without compaction (the
            parity/debug path): every pixel's ray from its unit-cube entry,
            a trilinear secant refine after a nearest march, shading."""
            dn = ray_dirs(cam, H, W)
            pos0, length = raymarch.unit_cube_entry(cam.eye_vol, dn, limit)
            hit, num, st = raymarch.march(
                volume, limit, max_steps, (pos0, length), dn,
                mode=c.march_mode, sentinel_skip=False)
            hit_pos = torch.stack([pos0[i] + dn[i] * st[5] for i in range(3)],
                                  dim=-1)
            if c.march_mode == "nearest":
                hit_pos = raymarch.refine_crossing(
                    volume, pos0, dn, st[3], st[4], hit, hit_pos)
            rgba, depth_win = self._shade_hits(
                hit, hit_pos, maps, proj_models, cam, near, far, limit,
                volume)
            overflow = torch.zeros(4, dtype=torch.int32, device=dev)
            return finalize(rgba, depth_win, hit, num, overflow)

        def render(volume, maps: SensorMaps, brick_counts, cam: CamParams,
                   proj_models, limit):
            if not use_blocks:
                return render_dense(volume, maps, cam, proj_models, limit)
            return render_from_baked(bake(volume, brick_counts), maps, cam,
                                     proj_models, limit)

        render.use_blocks = use_blocks
        render.bake = bake
        render.render_from_baked = render_from_baked if use_blocks else None
        return render, CamParams.from_camera(camera, self.bbox, dev)

    def make_renderer(self, camera: raymarch.ViewCamera,
                      max_steps: Optional[int] = None):
        """Returns ``renderer(volume, maps, brick_counts=None,
        camera_pose=None) -> RenderOutput``; pass a ViewCamera or CamParams
        as ``camera_pose`` to move the view (same projection).
        ``brick_counts`` (the fuse's brick occupancy counts) is read only
        with ``surface_skip=False``, whose block march skips around the
        marked bricks instead of the volume's surface bricks."""
        render, cam0 = self.make_render_fn(camera, max_steps)

        def renderer(volume, maps: SensorMaps, brick_counts=None,
                     camera_pose=None):
            if camera_pose is None:
                cam = cam0
            elif isinstance(camera_pose, CamParams):
                cam = camera_pose
            else:
                cam = CamParams.from_camera(camera_pose, self.bbox,
                                            self.device)
            return render(volume, maps, brick_counts, cam,
                          self._get_projection_models(), self._limit)

        return renderer
