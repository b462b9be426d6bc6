"""Port of rgbd_recon_tpu/recon: the TSDF pipeline (mode 1) and the points,
trigrid, MVT and calib-vis renderers (modes 0, 2, 3, 4)."""

from .tsdf_pipeline import TsdfPipeline, RenderOutput
from .points import PointsPipeline
from .trigrid import TrigridPipeline
from .mvt import MvtPipeline
from .calibs import CalibVisPipeline

__all__ = [
    "TsdfPipeline",
    "RenderOutput",
    "PointsPipeline",
    "TrigridPipeline",
    "MvtPipeline",
    "CalibVisPipeline",
]
