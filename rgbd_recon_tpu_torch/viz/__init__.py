"""Port of rgbd_recon_tpu/viz: PNG output and stereo composition."""

from .render import (
    save_image,
    colorize_depth,
    colorize_normals,
    sensor_map_gallery,
    tsdf_slice_image,
)
from .stereo import (
    StereoCamera,
    compose_anaglyph,
    compose_side_by_side,
    make_stereo_renderer,
)

__all__ = [
    "save_image",
    "colorize_depth",
    "colorize_normals",
    "sensor_map_gallery",
    "tsdf_slice_image",
    "StereoCamera",
    "compose_anaglyph",
    "compose_side_by_side",
    "make_stereo_renderer",
]
