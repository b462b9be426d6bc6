"""Multi-view texturing reconstruction (mode 3) (counterpart of
rgbd_recon_tpu/recon/mvt.py).

Re-design of ReconMVT (recon_mvt.cpp + glsl/mvt_accum.{vs,gs,fs}). The
reference's mode-3 draw() is disabled (recon_mvt.cpp:84-86), but the
capability it documents is the trigrid accumulation driven by *raw* depths
with the bilateral filter applied inline in the vertex stage
(mvt_accum.vs:43-98). Here the raw morphed depth is bilateral-filtered again
(the 13x13 window sums of ``ops/stencil13.bilateral13``, the CUDA kernel on
the card) and fed through the trigrid accumulation of mode 2.
"""

from __future__ import annotations

import dataclasses

from ..ops import stencil13
from ..ops.preprocess import SensorMaps, bilateral_lab
from ..ops.raymarch import ViewCamera
from .trigrid import TrigridPipeline


class MvtPipeline(TrigridPipeline):
    """Mode-3 strategy: trigrid accumulation over re-filtered RAW depth."""

    def render_maps(self, maps: SensorMaps, camera: ViewCamera):
        calib = self.calib
        # rebuild the depth channel from the raw morphed depth with the
        # vertex-stage bilateral (mvt_accum.vs:43-98); colors and quality
        # reuse the standard chain's maps. The bbox cull goes through the
        # calibration volumes, as the JAX package's per-sensor call does.
        raw = maps.raw_depth.contiguous()
        bf_sums = (stencil13.bilateral13(raw, calib.depth_limits.contiguous())
                   if self.config.bilateral else None)
        depth2 = bilateral_lab(raw, calib.bbox_min, calib.bbox_max,
                               calib.depth_limits, bf_sums,
                               pixel_models=None, cv_xyz=calib.cv_xyz)
        return super().render_maps(dataclasses.replace(maps, depth=depth2),
                                   camera)
