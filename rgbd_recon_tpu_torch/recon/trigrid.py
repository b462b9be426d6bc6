"""Triangle-grid reconstruction (mode 2): visibility-epsilon accumulation
(counterpart of rgbd_recon_tpu/recon/trigrid.py).

Re-design of ReconTrigrid (recon_trigrid.cpp + glsl/trigrid_accum.{vs,gs,fs},
trigrid_normalize.fs). The reference builds a screen-space triangle mesh
over each sensor's depth grid (2 triangles per pixel, recon_trigrid.cpp:
48-61) and renders it twice:

  pass 1     depth only -> per-pixel closest surface
  pass 2     additive blend of quality-premultiplied shaded colors for
             fragments within epsilon (0.075 m, recon_trigrid.cpp:35) of
             the pass-1 depth (trigrid_accum.fs:61-76)
  normalize  color / accumulated quality (trigrid_normalize.fs)

Rasterization becomes fragment splatting: each valid grid cell emits its
triangle vertices as fragments (with the GS triangle cull: no negative
depths, edge lengths < min_length * avg_depth * 4, trigrid_accum.gs:27-37);
the two passes are a scatter-min and a masked scatter-add.
"""

from __future__ import annotations

import torch

from rgbd_recon_tpu.core.config import PipelineConfig

from ..calib.sensors import CalibrationSet
from ..ops import splat
from ..ops.preprocess import SensorMaps
from ..ops.raymarch import ViewCamera, shade
from .points import inside_border, sensor_points, splat_depth

_EPSILON = 0.075        # recon_trigrid.cpp:35
_MIN_LENGTH = 0.0125    # KinectCalibrationFile.cpp:96 default


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The grid neighbor at (+dy, +dx) of every (N, H, W, ...) cell,
    wrapping around (jnp.roll)."""
    return torch.roll(a, (-dy, -dx), dims=(1, 2))


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def fragment_valid(d: torch.Tensor, world: torch.Tensor,
                   min_length: float) -> torch.Tensor:
    """(N, H, W) depth + world -> vertex fragments of a surviving triangle:
    the GS cull on both triangles of each 2x2 cell, a cell kept if either
    survives, a vertex kept if any adjacent cell is."""
    d00, d10, d01, d11 = d, _shift(d, 0, 1), _shift(d, 1, 0), _shift(d, 1, 1)
    w00, w10 = world, _shift(world, 0, 1)
    w01, w11 = _shift(world, 1, 0), _shift(world, 1, 1)

    def tri_ok(da, db, dc, wa, wb, wc):
        has_depth = (da >= 0.0) & (db >= 0.0) & (dc >= 0.0)
        avg = (da + db + dc) / 3.0
        lim = min_length * avg * 4.0
        return (has_depth & (_norm(wb - wa) < lim) & (_norm(wc - wa) < lim)
                & (_norm(wc - wb) < lim))

    cell_ok = (tri_ok(d00, d10, d01, w00, w10, w01)
               | tri_ok(d10, d11, d01, w10, w11, w01))
    # no cell exists in the last row/col (the rolled neighbors wrap)
    cell_ok[:, -1, :] = False
    cell_ok[:, :, -1] = False
    return (cell_ok | torch.roll(cell_ok, 1, dims=2)
            | torch.roll(cell_ok, 1, dims=1)
            | torch.roll(cell_ok, (1, 1), dims=(1, 2)))


class TrigridPipeline:
    """Mode-2 strategy: per-sensor surface meshes, epsilon-blended."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None,
                 min_length: float = _MIN_LENGTH, epsilon: float = _EPSILON):
        self.calib = calib
        self.config = config or PipelineConfig()
        self.min_length = min_length
        self.epsilon = epsilon

    def render_maps(self, maps: SensorMaps, camera: ViewCamera):
        """(image (H, W, 3), window depth (H, W), covered (H, W) bool) of
        the triangle grids of ``maps`` seen from ``camera``."""
        calib = self.calib
        N, H, W = maps.depth.shape[:3]
        d = maps.depth[..., 0]
        world, color, texco, in_box = sensor_points(calib, maps)
        valid = (fragment_valid(d, world, self.min_length) & in_box
                 & inside_border(texco) & (d > 0.0))

        P = N * H * W
        world = world.reshape(P, 3)
        color = color.reshape(P, 3)
        quality = maps.quality.reshape(P)
        valid = valid.reshape(P)

        xy, z = splat.project_points(world, camera)
        valid = valid & (z > camera.near)
        # splat footprint ~ projected cell size, roughly constant: a 1 px
        # radius covers the grid
        radius = torch.ones_like(z)
        zbuf = splat.zbuffer_min(xy, z, valid, (camera.height, camera.width),
                                 radius, max_radius=1)

        view_pos = camera.world_to_view(world)
        shaded = shade(view_pos, torch.zeros_like(view_pos), color,
                       shade_mode=0)
        premult = shaded * quality[:, None]  # trigrid_accum.fs:71-75
        acc, wsum = splat.accumulate_epsilon(xy, z, valid, premult, quality,
                                             zbuf, self.epsilon,
                                             radius=radius, max_radius=1)
        covered = wsum > 0.0
        img = torch.where(covered[..., None],
                          acc / torch.clamp_min(wsum, 1e-20)[..., None],
                          0.0)  # trigrid_normalize.fs:19-24
        return img, splat_depth(zbuf, camera), covered

    def make_renderer(self, camera: ViewCamera):
        """Returns ``renderer(maps) -> (image, window depth, covered)``."""

        def renderer(maps: SensorMaps):
            return self.render_maps(maps, camera)

        return renderer
