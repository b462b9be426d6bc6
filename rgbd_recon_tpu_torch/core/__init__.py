"""The port's copy of the host-side core (rgbd_recon_tpu/core without its
compile-cache tooling): spatial grids, cameras and the pipeline config."""

from .grid import BoundingBox, VolumeGrid, BrickGrid
from .camera import PinholeCamera, SensorRig
from .config import PipelineConfig, parse_conf, parse_ks, SceneDescription

__all__ = [
    "BoundingBox",
    "VolumeGrid",
    "BrickGrid",
    "PinholeCamera",
    "SensorRig",
    "PipelineConfig",
    "parse_conf",
    "parse_ks",
    "SceneDescription",
]
