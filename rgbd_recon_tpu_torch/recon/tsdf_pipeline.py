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

Beside the frame path: dense integration with observer counts, calibration
swaps, runtime reconfiguration (limit, voxel and brick size, any config
field) and sensor-pose refinement (refine/pose_ba.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..calib.sensors import (
    CalibrationSet,
    derive_pixel_models,
    derive_projection_models,
)
from ..core.config import PipelineConfig
from ..core.grid import BoundingBox, BrickGrid, VolumeGrid
from ..device import DEFAULT, resolve
from ..ops import bake as bake_ops
from ..ops import bricks as brick_ops
from ..ops import compact as compact_ops
from ..ops import hits as hit_ops
from ..ops import holefill, raymarch, tsdf
from ..ops import render_stages as stages
from ..ops.preprocess import SensorMaps, preprocess_frames
from ..ops.sampling import trilinear_3d
from ..refine import pose_ba
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
                    device=DEFAULT) -> "CamParams":
        """Pose of ``camera`` on ``device`` (the card unless the caller
        names another)."""
        device = resolve(device)
        eye = np.asarray(camera.eye, np.float32)
        return cls(
            eye_w=torch.from_numpy(eye).to(device),
            rot=torch.from_numpy(camera.rotation()).to(device),
            eye_vol=torch.from_numpy(bbox.normalize(eye)).to(device),
        )

    @classmethod
    def from_matrix(cls, mat, bbox: BoundingBox,
                    device=DEFAULT) -> "CamParams":
        """Pose from a 4x4 camera-to-world matrix (GL convention: camera
        looks along -z), the form the feedback channel delivers
        (FeedbackReceiver cyclops/model mats, kinect_client.cpp:637-673),
        on ``device`` (the card unless the caller names another)."""
        device = resolve(device)
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


class TsdfPipeline:
    """Owns the grids, the baked projections and the calibration fits for
    one scene setup; ``fuse`` and ``make_renderer`` are the entry points."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None,
                 bbox: BoundingBox = None):
        self.config = config or PipelineConfig()
        self.bbox = bbox or calib.bbox
        self.calib = calib
        self.device = calib.device
        # the reference computes these products in full f32; TF32 would keep
        # ~3 decimal digits (the only matmuls are in the render's shading
        # transform and the hole-fill resampling)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._limit = float(np.float32(self.config.tsdf_limit))
        # bumped by every reconfigure(): renderers rebuild on their next call
        self._generation = 0
        self._pixel_models_cache = {}
        self._projection_models = None   # (models or None,) once fitted
        self._build_grids()

    def _build_grids(self):
        """The grids and the per-voxel projection bakes of the current
        config and calibration: everything with a shape."""
        c = self.config
        # integrate_dense's per-voxel projections, baked on first use
        self._dense_projections = None
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
        self._bake_projections()

    def _bake_projections(self):
        """Frame-invariant per-voxel projections of the calibration,
        brick-major for the compact integration, dense otherwise (None:
        looked up every frame)."""
        if self.compact:
            self.projections = tsdf.bake_projections_bricks(
                self.calib.cv_xyz_inv, self.volume_grid.shape,
                self.brick_vox)
        elif self.config.precompute_projections:
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

    def _mark_bricks(self, pixel_models, maps: SensorMaps,
                     calib: Optional[CalibrationSet] = None) -> torch.Tensor:
        """Brick occupancy from valid depth pixels (pre_normal.fs side
        effect) of the sensors of ``calib`` (the pipeline's by default).
        With mark_stride s > 1 every s-th pixel scatters s^2 counts."""
        calib = self.calib if calib is None else calib
        N, H, W = maps.depth.shape[:3]
        s = max(int(self.config.mark_stride), 1)
        depth = maps.depth[..., 0]
        ray_a = ray_b = worlds = None
        if pixel_models is not None:
            # the marking makes the world points ray_a + ray_b * d itself
            ray_a, ray_b = pixel_models.ray_a, pixel_models.ray_b
        else:
            d_all = brick_ops.sample_pixels(depth, s)
            dev = d_all.device
            u = (torch.arange(W, dtype=torch.float32, device=dev)[s // 2::s]
                 + 0.5) / W
            v = (torch.arange(H, dtype=torch.float32, device=dev)[s // 2::s]
                 + 0.5) / H
            vv, uu = torch.meshgrid(v, u, indexing="ij")
            worlds = torch.stack([
                trilinear_3d(calib.cv_xyz[i],
                             torch.stack([uu, vv, d_all[i]], dim=-1))
                for i in range(N)
            ])
        return brick_ops.mark_pixels(
            depth, calib.bbox_min, self.config.brick_size,
            self.brick_grid.res, s, ray_a=ray_a, ray_b=ray_b, worlds=worlds)

    def preprocess(self, frames: FrameSet):
        """frames -> (SensorMaps, (Bz, By, Bx) int32 brick counts)."""
        return self._preprocess_impl(
            self.calib, self._get_pixel_models(frames.depths.shape[1:3]),
            frames)

    def _preprocess_impl(self, calib: CalibrationSet, pm, frames: FrameSet):
        """:meth:`preprocess` of the sensors of ``calib`` with their pixel
        models ``pm`` (dist/ runs it on each shard's sensors)."""
        c = self.config
        maps = preprocess_frames(
            frames.depths, frames.colors, calib.cv_xyz, calib.cv_uv,
            calib.bbox_min, calib.bbox_max, calib.depth_limits,
            calib.camera_positions, morph=c.morph,
            bilateral=c.bilateral and c.processed, refine=c.refine,
            pixel_models=pm,
        )
        return maps, self._mark_bricks(pm, maps, calib)

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
        return tsdf.integrate_compact(
            self.projections, brick_counts, c.min_voxels_per_brick,
            c.brick_capacity, maps.depth[..., 0], maps.quality,
            maps.silhouette, lim, self.volume_grid.shape, self.brick_vox,
            carve_sil_threshold=c.carve_sil_threshold,
            phantom_hull=c.phantom_hull, taps=c.integrate_taps,
        )

    def integrate_dense(self, maps: SensorMaps, limit: Optional[float] = None,
                        return_observers: bool = False):
        """Dense integration of every voxel, without brick gating, at the
        band ``limit`` (the pipeline's limit by default): pose refinement's
        wide-band volumes, which the brick-compact volume cannot hold
        (only occupied bricks' voxels exist there). ``return_observers``
        also returns the per-voxel observer count (ops/tsdf.py integrate).
        The per-voxel projections are baked once and kept until the
        calibration or the grid changes."""
        c = self.config
        lim = self._limit if limit is None else float(np.float32(limit))
        if self._dense_projections is None:
            self._dense_projections = (
                self.projections
                if not self.compact and self.projections is not None
                else tsdf.bake_projections(self.calib.cv_xyz_inv,
                                           self.volume_grid.shape))
        return tsdf.integrate(
            self.volume_grid.shape, self.calib.cv_xyz_inv,
            maps.depth[..., 0], maps.quality, maps.silhouette, lim,
            projections=self._dense_projections,
            carve_sil_threshold=c.carve_sil_threshold,
            phantom_hull=c.phantom_hull, return_observers=return_observers,
        )

    def fuse(self, frames: FrameSet):
        """One fused frame update: preprocess + mark + integrate. Returns
        (volume, maps, brick_counts)."""
        maps, counts = self.preprocess(frames)
        return self.integrate(maps, counts), maps, counts

    def fuse_single_program(self, frames: FrameSet):
        """:meth:`fuse`. The JAX package compiles the whole frame update
        into one XLA program here; PyTorch runs operations as they come,
        so there is no separate program and this is the same call."""
        return self.fuse(frames)

    # -- runtime reconfiguration (recon_integration.cpp:341-354, 468-484;
    #    kinect_client.cpp:362-376) ----------------------------------------

    def set_tsdf_limit(self, limit: float) -> None:
        """Change the truncation limit: later fuses integrate at the new
        band and renders march with it. Renderers keep the march step
        bound sized from the limit they were built with, so a smaller
        limit may leave grazing rays unfinished (RenderOutput.overflow)."""
        self.config = dataclasses.replace(self.config,
                                          tsdf_limit=float(limit))
        self._limit = float(np.float32(limit))

    def set_voxel_size(self, voxel_size: float) -> None:
        """Rebuild the volume grid and the projection bakes at a new
        resolution (the reference rebuilds its volume,
        recon_integration.cpp:341-354)."""
        self.reconfigure(voxel_size=float(voxel_size))

    def set_brick_size(self, brick_size: float) -> None:
        self.reconfigure(brick_size=float(brick_size))

    def reconfigure(self, **updates) -> None:
        """Apply config updates (voxel_size, brick_size, processing
        toggles, ...). A change of a field with a shape (voxel_size,
        brick_size, bricking, min_voxels_per_brick) rebuilds the grids and
        the projection bakes; every call makes renderers built earlier
        rebuild on their next call. An unknown field raises
        AttributeError."""
        shape_keys = {"voxel_size", "brick_size", "bricking",
                      "min_voxels_per_brick"}
        fields = {f.name for f in dataclasses.fields(self.config)}
        for k in updates:
            if k not in fields:
                raise AttributeError(f"unknown config field {k}")
        reshape = any(k in shape_keys and getattr(self.config, k) != v
                      for k, v in updates.items())
        self.config = dataclasses.replace(self.config, **updates)
        if "tsdf_limit" in updates:
            self._limit = float(np.float32(self.config.tsdf_limit))
        if reshape:
            self._build_grids()
        self._generation += 1

    def update_calibration(self, calib: CalibrationSet) -> None:
        """Swap in a new calibration of the same shapes (e.g. pose-refined
        by refine.pose_ba.apply_pose_corrections): re-bake the projections
        and drop the fitted models. Renderers made earlier read the
        calibration and the models at each call, so they take the new one
        without a rebuild."""
        self.calib = calib
        self._bake_projections()
        self._dense_projections = None
        self._pixel_models_cache = {}
        self._projection_models = None

    def refine_sensor_poses(self, maps: SensorMaps, brick_counts,
                            iters: int = 5, apply: bool = True,
                            rounds: int = 1, frames: FrameSet = None,
                            worst_only: bool = True,
                            band_schedule=(4.0, 2.0, 1.0)):
        """Per-sensor 6-DoF corrections against the leave-one-out
        consensus surfaces, applied to the calibration unless ``apply`` is
        False: the drift-correction loop (the reference trusts its offline
        calibration; drift shows as doubled surfaces).

        ``rounds`` > 1 alternates refine -> apply -> re-fuse (pass
        ``frames``): a misaligned sensor contaminates the others'
        leave-one-out consensus, so one shot is biased. ``band_schedule``
        sets each round's band in units of the limit, consumed from its
        end (one round: the last entry; more rounds than entries repeat
        the first). Each round's consensus is observer-weighted: voxels
        that fewer than min(2, N - 1) other sensors saw weigh less or
        nothing.

        ``worst_only`` keeps only the correction of the sensor with the
        highest consensus residual (ranked at the nominal limit, without
        the observer mask, which would hide the displaced points that mark
        it). When applying, three gates: the margin (its residual above
        1.12 x the rig's median), continuity (the margin is waived for the
        sensor applied the round before) and the improvement (the
        correction lowers that residual by at least 5%); a round that
        fails them applies nothing. Without ``apply`` the estimates
        accumulate through the schedule.

        Returns (poses of the last round (N, 6), its residual history).
        ``self.refine_report`` holds one dict per round: band, residuals,
        worst sensor, gate results and the sensor applied (None if
        none)."""
        n_rounds = max(rounds, 1)
        sched = list(band_schedule) if band_schedule else [1.0]
        if n_rounds <= len(sched):
            sched = sched[len(sched) - n_rounds:]
        else:
            sched = [sched[0]] * (n_rounds - len(sched)) + sched

        poses = history = total = None
        applied_sensor = -1
        self.refine_report = []
        for r in range(n_rounds):
            band = self.config.tsdf_limit * float(sched[r])
            vols, obs = pose_ba.leave_one_out_volumes(
                self, maps, brick_counts, limit=band, return_observers=True)
            # a leave-one-out consensus has N - 1 potential witnesses
            n_obs = min(2.0, float(self.calib.num_sensors - 1))
            poses, history = pose_ba.refine_poses(
                self.calib, maps, None, band, iters=iters, volumes=vols,
                init=None if apply else total,
                # trim the unknown region's negative tail at half the band,
                # never tighter than the nominal limit
                mask_floor=-max(band * 0.5, self.config.tsdf_limit * 0.999),
                observers=obs, min_observers=n_obs,
            )
            report = {"round": r, "band": band, "applied": None}
            if worst_only:
                res_h = pose_ba.pose_residual_stats(
                    self.calib, maps, None, self.config.tsdf_limit,
                    volumes=vols).cpu().numpy()
                worst = int(np.argmax(res_h))
                keep = (torch.arange(poses.shape[0], device=poses.device)
                        == worst)[:, None]
                poses = torch.where(keep, poses, 0.0)
                report.update(residuals=res_h.tolist(), worst=worst)
                if apply:
                    margin = bool(res_h[worst] > 1.12 * float(
                        np.median(res_h)) or worst == applied_sensor)
                    res_after = pose_ba.pose_residual_stats(
                        self.calib, maps, None, self.config.tsdf_limit,
                        poses=poses, volumes=vols).cpu().numpy()
                    improve = bool(res_after[worst] < 0.95 * res_h[worst])
                    report.update(margin=margin, improve=improve,
                                  residual_after=float(res_after[worst]))
                    if margin and improve:
                        applied_sensor = report["applied"] = worst
                    else:
                        poses = torch.zeros_like(poses)
            self.refine_report.append(report)
            if not apply:
                total = poses
                continue
            self.update_calibration(
                pose_ba.apply_pose_corrections(self.calib, poses))
            if r + 1 < n_rounds:
                if frames is None:
                    break
                _, maps, brick_counts = self.fuse(frames)
        return poses, history

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
        # the march table's bake, kernel or plain, by configuration as in
        # the JAX package (ops/bake.py uses_kernel_bake)
        kernel_bake = bake_ops.uses_kernel_bake(brick_vox,
                                                c.skip_fine_rounds)
        # the chunked march serves the fine stage's first march
        chunked = c.march_chunk > 0 and c.march_mode == "nearest"

        geom = stages.BlockGeometry(
            H=H, W=W, ds=ds, sc=2, tan_half=tan_half,
            bbox_size=tuple(float(v) for v in bbox_size), vol_shape=vol_shape,
            brick_vox=brick_vox, n_scan=n_scan, step_len=step_len,
            brick_norm=brick_norm, bracket_max_steps=c.bracket_max_steps,
            bracket_margin_steps=c.bracket_margin_steps, sd=sd,
            per_block=bool(c.bracket_per_block))
        # the block list, the march's tail lists and the hit list
        capB = min(NB, max(-(-int(NB * c.ray_compaction) // 8) * 8, 2048))
        R = capB * B2
        hit_frac = c.hit_compaction if c.hit_compaction > 0.0 else 1.0
        capH = min(R, -(-int(R * hit_frac) // 8) * 8)
        p1 = c.march_phase1_steps
        staged = p1 > 0 and skip_
        # narrowing tail stages over the full interval: (steps, capacity)
        tails = []
        if staged:
            budget_used = p1
            for divisor, budget in ((3, 3 * p1), (10, tail_budget)):
                steps = min(budget, max_steps - budget_used)
                if steps <= 0:
                    break
                tails.append((steps,
                              max(-(-R // divisor // 8) * 8, min(R, 1024))))
                budget_used += steps
        caps = stages.count_caps(capB, [cap for _, cap in tails], capH,
                                 oct_capacity if use_oct else -1)

        def finalize(planes, depth_win, hit_img, num_img, overflow):
            """The fill of the pre-fill ``planes`` (4 rgba planes) and the
            background."""
            if c.colorfill:
                filled, depth_out = holefill.fill_colors_planar(
                    list(planes), depth_win, num_lods)
                rgb_planes = filled[:3]
            else:
                rgb_planes = list(planes[:3])
                depth_out = depth_win
            # background compositing: empty pixels keep window depth 1.0
            shown = depth_out < 1.0
            color = torch.stack([torch.where(shown, p, 0.0)
                                 for p in rgb_planes], dim=-1)
            return RenderOutput(color=color, depth=depth_out, hit=hit_img,
                                num_samples=num_img, overflow=overflow)

        def brick_safe_field(occ):
            """Brick-level clearance to the surface bricks (the kernel on
            the card)."""
            return bake_ops.brick_clearance(occ, c.skip_brick_rounds,
                                            brick_vox)[0]

        def sentinel_bake(volume, bs_scaled):
            """The march table of ``volume`` (the kernel's by configuration,
            on the card) from the brick clearance times brick_vox of its
            own bricks."""
            bake_table = (bake_ops.sentinel_bake if kernel_bake
                          else bake_ops.sentinel_bake_plain)
            return bake_table(volume, bs_scaled, brick_vox,
                              c.skip_fine_rounds, table_dtype)

        # the bake of one z-slab of the volume, for dist/: the slab comes
        # grown by slab_halo ghost rows on each side (the neighbours' rows,
        # the clear value beyond the volume's z faces), one brick for the
        # kernels, the K rows of the plain clearance rounds otherwise
        slab_halo = (brick_vox if kernel_bake
                     else max(brick_vox, c.skip_fine_rounds))

        def slab_occ(ext):
            """The surface-brick rows of the slab inside ``ext``."""
            g = slab_halo - brick_vox
            grown = ext[g: ext.shape[0] - g].contiguous()
            return bake_ops.surface_occ(grown, brick_vox)[1:-1]

        def bake_slab(ext, bs_ext):
            """The march-table rows of the slab inside ``ext``, from its
            bricks' clearance times brick_vox with one ghost brick row on
            each side (``bs_ext``): the kernel bake of the slab grown by one
            brick, else the plain encode of the clearance of the K-row
            halo."""
            h = slab_halo
            if kernel_bake:
                return bake_ops.sentinel_bake(
                    ext.contiguous(), bs_ext.contiguous(), brick_vox,
                    c.skip_fine_rounds, table_dtype)[h:-h]
            fine = bake_ops.fine_safe_field(ext > 0.0, c.skip_fine_rounds)
            return bake_ops.sentinel_encode(ext[h:-h], fine[h:-h],
                                            bs_ext[1:-1], brick_vox,
                                            table_dtype)

        def build_oct(volume, occ):
            """The oct hit table of the RAW volume."""
            return raymarch.build_oct_bricks(volume, occ, brick_vox,
                                             oct_capacity, table_dtype)

        def bake(volume, brick_counts):
            """volume -> (march table, oct hit table or None, surface-brick
            mask, brick clearance field). The surface-brick mask is the
            bricks whose 1-voxel dilation holds a positive voxel, or the
            marked occupancy without ``surface_skip``. The march table is
            the skip-sentinel table in the march dtype (bf16 or f32) with
            sentinels, else the raw f32
            volume."""
            volume = volume.contiguous()
            if c.surface_skip:
                occ = bake_ops.surface_occ(volume, brick_vox)
            else:
                occ = brick_ops.occupied_mask(brick_counts,
                                              c.min_voxels_per_brick)
            bsafe, bs_scaled = bake_ops.brick_clearance(
                occ, c.skip_brick_rounds, brick_vox)
            if not skip_:
                return volume, None, occ, bsafe
            table = sentinel_bake(volume, bs_scaled)
            oct = build_oct(volume, occ) if use_oct else None
            return table, oct, occ, bsafe

        def render_from_baked(baked, maps: SensorMaps, cam: CamParams,
                              proj_models, limit):
            """Block march (staged with sentinels, else one full-length
            march) + hit refine + shading + hole fill. Every stage runs on
            the device (ops/render_stages.py, ops/compact.py, the row march
            of ops/raymarch.py): nothing is read back before the fill."""
            table, oct, occ, bsafe = baked
            floor = -limit if skip_ else None   # sentinel clamp
            march_kw = dict(mode=c.march_mode, sentinel_skip=skip_,
                            sentinel_scale=h_min)
            # the lists' counts (stages.COUNT_*)
            counts = torch.zeros(stages.NUM_COUNTS, dtype=torch.int32,
                                 device=dev)

            # interval scan at half block resolution, 3x3-pooled back up
            scan5 = stages.scan(geom, occ, bsafe, cam, counts,
                                stages.COUNT_SURFACE)
            blk, s_end, bflags, grid = stages.block_setup(geom, scan5, cam)

            # block compaction: fixed-capacity list of active 4x4 blocks
            blk_idx, blk_slot = compact_ops.compact(
                bflags, 0, capB, counts, stages.COUNT_BLOCKS, want_slot=True)
            # coarse density march: one centre ray per active block
            raymarch.march_grid(table, limit, blk_budget, blk, blk_idx, grid,
                                **march_kw)
            # fine march: all rays of the active blocks
            ray8 = stages.bracket(geom, grid, blk, s_end, bflags, blk_idx,
                                  cam)
            if staged:
                if chunked:
                    hit, num, st = raymarch.march_chunked(
                        table, limit, p1,
                        ((ray8[:, 0], ray8[:, 1], ray8[:, 2]), ray8[:, 7]),
                        (ray8[:, 3], ray8[:, 4], ray8[:, 5]), chunk=p1,
                        sentinel_skip=skip_, sentinel_scale=h_min)
                    st8 = raymarch.state_rows(hit, num, st)
                    rflags = raymarch.row_flags(st8, ray8)
                else:
                    st8, rflags = raymarch.march_rows(table, limit, p1, ray8,
                                                      7, **march_kw)
                for k, (steps, cap_t) in enumerate(tails):
                    idx2, _ = compact_ops.compact(rflags, 1, cap_t, counts,
                                                  stages.COUNT_TAILS[k])
                    raymarch.march_rows(table, limit, steps, ray8, 6,
                                        st8=st8, flags=rflags, ids=idx2,
                                        **march_kw)
            else:
                st8, rflags = raymarch.march_rows(table, limit, max_steps,
                                                  ray8, 6, **march_kw)

            # hit compaction: refine, normals, color and shading run on the
            # hit set only
            hit_idx, hit_slot = compact_ops.compact(
                rflags, 0, capH, counts, stages.COUNT_HITS, want_slot=True)
            hrows, hit_pos_h, live_h = stages.hit_gather(ray8, st8, hit_idx)
            pos0_h = (hrows[:, 0], hrows[:, 1], hrows[:, 2])
            dn_h = (hrows[:, 3], hrows[:, 4], hrows[:, 5])
            if "refine" in c.debug_skip:
                hp = hit_pos_h        # the march's own secant position
            else:
                # the oct table's refine where there is one, else the
                # march table's
                hp = hit_ops.refine_hits(
                    pos0_h, dn_h, hrows[:, 6], hrows[:, 7], live_h,
                    hit_pos_h, limit, oct=oct, table=table,
                    clamp_floor=floor, widen_steps=c.refine_widen_steps,
                    widen_samples=c.refine_widen_samples)
            rgba_h, depth_h = hit_ops.shade_hits(
                c, self.calib, self.bbox, live_h, hp, maps, proj_models, cam,
                near, far, limit, table, floor, oct)
            planes, depth_img, hit_img, num_img, overflow = stages.compose(
                geom, blk_slot, hit_slot, st8, rgba_h.contiguous(),
                depth_h.contiguous(), counts, caps)
            return finalize(planes, depth_img, hit_img, num_img, overflow)

        def render_dense(volume, maps: SensorMaps, cam: CamParams,
                         proj_models, limit):
            """Full-screen march of the raw volume without compaction (the
            parity/debug path): every pixel's ray from its unit-cube entry,
            a trilinear secant refine after a nearest march, shading. Of
            the ``debug_skip`` switches, "grad" and "blend" act here (in
            ops/hits.py shade_hits) and "refine" does not, as in the JAX
            package's render_dense, whose march always refines."""
            dn = stages.ray_dirs(geom, cam, H, W)
            pos0, length = raymarch.unit_cube_entry(cam.eye_vol, dn, limit)
            hit, num, st = raymarch.march(
                volume, limit, max_steps, (pos0, length), dn,
                mode=c.march_mode, sentinel_skip=False)
            hit_pos = torch.stack([pos0[i] + dn[i] * st[5] for i in range(3)],
                                  dim=-1)
            if c.march_mode == "nearest":
                hit_pos = hit_ops.refine_hits(pos0, dn, st[3], st[4], hit,
                                              hit_pos, limit, table=volume)
            rgba, depth_win = hit_ops.shade_hits(
                c, self.calib, self.bbox, hit, hit_pos, maps, proj_models,
                cam, near, far, limit, volume, None, None)
            overflow = torch.zeros(4, dtype=torch.int32, device=dev)
            return finalize(rgba.permute(2, 0, 1), depth_win, hit, num,
                            overflow)

        def render(volume, maps: SensorMaps, brick_counts, cam: CamParams,
                   proj_models, limit):
            if not use_blocks:
                return render_dense(volume, maps, cam, proj_models, limit)
            return render_from_baked(bake(volume, brick_counts), maps, cam,
                                     proj_models, limit)

        render.use_blocks = use_blocks
        render.bake = bake
        render.render_from_baked = render_from_baked if use_blocks else None
        # the slab-wise bake of dist/, where the render bakes a march table
        # of the volume's surface bricks
        slab_bake = use_blocks and skip_ and c.surface_skip
        render.slab_halo = slab_halo
        render.slab_occ = slab_occ
        render.brick_safe_field = brick_safe_field
        render.bake_slab = bake_slab if slab_bake else None
        render.build_oct = build_oct if use_oct else None
        return render, CamParams.from_camera(camera, self.bbox, dev)

    def make_renderer(self, camera: raymarch.ViewCamera,
                      max_steps: Optional[int] = None):
        """Returns ``renderer(volume, maps, brick_counts=None,
        camera_pose=None) -> RenderOutput``; pass a ViewCamera or CamParams
        as ``camera_pose`` to move the view (same projection).
        ``brick_counts`` (the fuse's brick occupancy counts) is read only
        with ``surface_skip=False``, whose block march skips around the
        marked bricks instead of the volume's surface bricks. The renderer
        rebuilds itself on its next call after a reconfigure() (a new
        grid or config), and reads the calibration, the projection models
        and the limit at every call."""
        state = {}

        def build():
            state["render"], state["cam0"] = self.make_render_fn(camera,
                                                                 max_steps)
            state["gen"] = self._generation

        build()

        def renderer(volume, maps: SensorMaps, brick_counts=None,
                     camera_pose=None):
            if state["gen"] != self._generation:
                build()
            if camera_pose is None:
                cam = state["cam0"]
            elif isinstance(camera_pose, CamParams):
                cam = camera_pose
            else:
                cam = CamParams.from_camera(camera_pose, self.bbox,
                                            self.device)
            return state["render"](volume, maps, brick_counts, cam,
                                   self._get_projection_models(),
                                   self._limit)

        return renderer
