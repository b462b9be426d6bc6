"""TSDF / calibration debug visualization (mode 4, "calib vis")
(counterpart of rgbd_recon_tpu/recon/calibs.py).

Re-design of ReconCalibs (recon_calibs.cpp + glsl/calib_vis.{vs,fs}): every
voxel center is drawn as a point colored by its TSDF value:

  tsd > 0          red,  brightness 1 - |tsd|/limit   (calib_vis.fs:19-21)
  tsd <= 0         green, brightness 1 - |tsd|/limit  (:23-24)
  tsd >= +limit    solid blue                          (:26-28)
  tsd <= -limit    discarded                           (:30)

The points are z-buffer splatted into the view like the points mode.
``active_kinect`` is kept for the interface of the reference's per-sensor
selection (ReconCalibs::setActiveKinect); the coloring does not depend on
it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import VolumeGrid
from ..ops import splat
from ..ops.raymarch import ViewCamera
from ..ops.tsdf import voxel_centers
from .points import splat_depth


class CalibVisPipeline:
    """Debug strategy: renders the TSDF volume itself, no sensor data."""

    def __init__(self, volume_grid: VolumeGrid, tsdf_limit: float = 0.01,
                 active_kinect: int = 0, max_points: int = 1 << 20):
        self.volume_grid = volume_grid
        self.tsdf_limit = float(tsdf_limit)
        self.active_kinect = active_kinect
        # voxel stride keeping the splat count bounded (the reference draws
        # every voxel; a debug view does not need 8.8 M points)
        n = volume_grid.num_voxels
        self.stride = max(1, int(np.ceil((n / max_points) ** (1.0 / 3.0))))

    def set_active_kinect(self, num: int) -> None:
        """The sensor selection of ReconCalibs::setActiveKinect."""
        self.active_kinect = num

    def set_tsdf_limit(self, limit: float) -> None:
        """The coloring band of renderers made after this call."""
        self.tsdf_limit = float(limit)

    def make_renderer(self, camera: ViewCamera):
        """Returns ``renderer(volume) -> (image, window depth, covered)``."""
        grid = self.volume_grid
        s = self.stride
        limit = self.tsdf_limit
        bbox_min = np.asarray(grid.bbox.min, np.float32)
        bbox_size = np.asarray(grid.bbox.size, np.float32)

        def renderer(volume: torch.Tensor):
            dev = volume.device
            tsd = volume[::s, ::s, ::s].reshape(-1)
            pos = voxel_centers(grid.shape, device=dev)[::s, ::s, ::s]
            world = (pos.reshape(-1, 3) * torch.from_numpy(bbox_size).to(dev)
                     + torch.from_numpy(bbox_min).to(dev))

            bright = 1.0 - torch.clamp(torch.abs(tsd) / limit, 0.0, 1.0)
            zero = torch.zeros_like(bright)
            red = torch.stack([bright, zero, zero], -1)
            green = torch.stack([zero, bright, zero], -1)
            blue = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(red)
            color = torch.where((tsd > 0.0)[..., None], red, green)
            color = torch.where((tsd >= limit)[..., None], blue, color)
            valid = tsd > -limit  # discard at <= -limit (calib_vis.fs:30)

            xy, z = splat.project_points(world, camera)
            valid = valid & (z > camera.near)
            radius = torch.full_like(z, 0.5)
            zbuf = splat.zbuffer_min(xy, z, valid,
                                     (camera.height, camera.width), radius,
                                     max_radius=1)
            img, covered = splat.resolve_winners(xy, z, valid, color, zbuf,
                                                 radius=radius, z_tol=1e-4,
                                                 max_radius=1)
            img = torch.where(covered[..., None], img, 0.0)
            return img, splat_depth(zbuf, camera), covered

        return renderer
