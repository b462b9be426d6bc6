"""Point-cloud reconstruction (mode 0): one splat per depth pixel
(counterpart of rgbd_recon_tpu/recon/points.py).

Re-design of ReconPoints (recon_points.cpp + glsl/points.{vs,gs,fs}) as a
z-buffered scatter renderer:

  VS  (points.vs:22-35)  world pos / color texcoord via cv_xyz / cv_uv
  GS  (points.gs:35-61)  cull invalid depth + out-of-bbox; distance-scaled
                         point size (10 px / view distance; 4 in camera mode)
  FS  (points.fs:36-101) cull color border (uv outside [0.01, 0.99]),
                         shade(view_pos, view_normal, color)
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_recon_tpu.core.config import PipelineConfig

from ..calib.sensors import CalibrationSet
from ..ops import splat
from ..ops.preprocess import SensorMaps
from ..ops.raymarch import ViewCamera, shade
from ..ops.sampling import bilinear_2d, trilinear_3d

# shade_mode 3 camera colors (points.fs)
_PALETTE = np.array([[228, 26, 28], [55, 126, 184], [77, 175, 74],
                     [152, 78, 163], [255, 127, 0]], np.float32) / 255.0


def sensor_points(calib: CalibrationSet, maps: SensorMaps):
    """Every depth pixel of every sensor as a point: (world (N, H, W, 3),
    color (N, H, W, 3), texcoord (N, H, W, 2), in-box (N, H, W) bool)."""
    N, H, W = maps.depth.shape[:3]
    dev = maps.depth.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    world, color, texco = [], [], []
    for i in range(N):
        coords = torch.stack([uu, vv, maps.depth[i, ..., 0]], dim=-1)
        world.append(trilinear_3d(calib.cv_xyz[i], coords))
        texco.append(trilinear_3d(calib.cv_uv[i], coords)[..., :2])
        color.append(bilinear_2d(maps.color[i], texco[i]))
    world, color, texco = (torch.stack(world), torch.stack(color),
                           torch.stack(texco))
    in_box = ((world >= calib.bbox_min) & (world <= calib.bbox_max)).all(-1)
    return world, color, texco, in_box


def inside_border(texco: torch.Tensor) -> torch.Tensor:
    """The FS color-border cull (points.fs:38-42): texcoord in (0.01, 0.99)."""
    return ((texco[..., 0] > 0.01) & (texco[..., 0] < 0.99)
            & (texco[..., 1] > 0.01) & (texco[..., 1] < 0.99))


def splat_depth(zbuf: torch.Tensor, camera: ViewCamera) -> torch.Tensor:
    """Window depth of a z-buffer, 1.0 where nothing landed."""
    return torch.where(torch.isfinite(zbuf), camera.window_depth(zbuf), 1.0)


class PointsPipeline:
    """Mode-0 strategy: renders SensorMaps directly, no volume."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None):
        self.calib = calib
        self.config = config or PipelineConfig()

    def make_renderer(self, camera: ViewCamera):
        """Returns ``renderer(maps) -> (image (H, W, 3), window depth
        (H, W), covered (H, W) bool)``."""
        cfg = self.config
        calib = self.calib
        dev = calib.device
        max_size = 4.0 if cfg.shade_mode == 3 else 10.0  # points.gs:55-58
        rot = torch.from_numpy(camera.rotation()).to(dev)
        eye = torch.tensor(camera.eye, dtype=torch.float32, device=dev)

        def renderer(maps: SensorMaps):
            N, H, W = maps.depth.shape[:3]
            world, color, texco, in_box = sensor_points(calib, maps)
            # GS cull (points.gs:39-41) + FS border cull (points.fs:38-42)
            valid = (maps.depth[..., 0] > 0.0) & in_box & inside_border(texco)

            P = N * H * W
            world = world.reshape(P, 3)
            color = color.reshape(P, 3)
            normal = maps.normal.reshape(P, 3)
            valid = valid.reshape(P)

            xy, z = splat.project_points(world, camera)
            valid = valid & (z > camera.near)
            # gl_PointSize = max_size / dist (points.gs:60); splat radius in
            # extra pixels beyond the center = size / 2
            rel = world - eye
            dist = torch.sqrt((rel * rel).sum(-1))
            radius = torch.clamp(max_size / torch.clamp_min(dist, 1e-3) * 0.5,
                                 0.0, 2.0)
            zbuf = splat.zbuffer_min(xy, z, valid, (camera.height,
                                                    camera.width), radius)
            if cfg.shade_mode == 3:
                # kept as written: the first N % 6 palette rows, cut to N
                palette = torch.from_numpy(_PALETTE).to(dev)
                shaded = torch.repeat_interleave(palette[:N % 6][:N], H * W,
                                                 dim=0)
            else:
                shaded = shade(rel @ rot, normal @ rot, color,
                               shade_mode=cfg.shade_mode, world_normal=normal)
            img, covered = splat.resolve_winners(xy, z, valid, shaded, zbuf,
                                                 radius=radius, z_tol=1e-4)
            img = torch.where(covered[..., None], img, 0.0)
            return img, splat_depth(zbuf, camera), covered

        return renderer
