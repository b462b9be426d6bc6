"""Port of rgbd_recon_tpu/viz: PNG output, stereo composition, the orbit
navigator and the live MJPEG preview (with its own JPEG encoder)."""

from .jpeg import encode_jpeg
from .navigation import OrbitNavigator
from .preview import PreviewServer
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
    "encode_jpeg",
    "OrbitNavigator",
    "PreviewServer",
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
