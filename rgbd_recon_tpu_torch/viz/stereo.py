"""Stereo output modes: mono / anaglyph / side-by-side (counterpart of
rgbd_recon_tpu/viz/stereo.py).

Replicates the reference's three display modes (source/kinect_client.cpp
draw3d :612-673):

  mono          one eye at the cyclops position
  anaglyph      two passes with glColorMask(R / GB) and eyes separated by
                +-eyesep/2 (kinect_client.cpp:626-649)
  side-by-side  two viewports (kinect_client.cpp:651-673)

The scene is rendered twice with laterally displaced eyes and the two
images are composed on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.raymarch import ViewCamera

# reference default eye separation (kinect_client.cpp:631,636: +-0.0325
# -> 6.5 cm interocular)
DEFAULT_EYE_SEPARATION = 0.065


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Cyclops camera + eye separation (gloost::StereoCamera)."""

    cyclops: ViewCamera
    eye_separation: float = DEFAULT_EYE_SEPARATION

    def eye_camera(self, side: float) -> ViewCamera:
        """side = -1 left, +1 right: the eye and the look target move along
        the camera's right axis by side * eyesep / 2."""
        right = self.cyclops.rotation()[:, 0]
        off = right * (side * self.eye_separation * 0.5)
        eye = np.asarray(self.cyclops.eye, np.float32) + off
        tgt = np.asarray(self.cyclops.target, np.float32) + off
        return dataclasses.replace(self.cyclops, eye=tuple(eye.tolist()),
                                   target=tuple(tgt.tolist()))

    @property
    def left(self) -> ViewCamera:
        return self.eye_camera(-1.0)

    @property
    def right(self) -> ViewCamera:
        return self.eye_camera(+1.0)


def compose_anaglyph(left_rgb: torch.Tensor,
                     right_rgb: torch.Tensor) -> torch.Tensor:
    """Red from the left eye, green and blue from the right: the
    reference's two glColorMask passes (kinect_client.cpp:626-649)."""
    return torch.cat([left_rgb[..., :1], right_rgb[..., 1:3]], dim=-1)


def compose_side_by_side(left_rgb: torch.Tensor,
                         right_rgb: torch.Tensor) -> torch.Tensor:
    """Left|right viewport split (kinect_client.cpp:651-673)."""
    return torch.cat([left_rgb, right_rgb], dim=1)


def make_stereo_renderer(make_renderer: Callable[[ViewCamera], Callable],
                         camera: StereoCamera, mode: str = "anaglyph"):
    """Wrap a per-camera renderer factory (camera -> render(*state) ->
    RenderOutput, or a tuple whose first element is the image; e.g.
    TsdfPipeline.make_renderer) into render(*state) -> (H, W or 2W, 3)
    image. ``mode``: 'mono' | 'anaglyph' | 'side-by-side'."""
    if mode == "mono":
        render = make_renderer(camera.cyclops)

        def mono(*state):
            return _image_of(render(*state))

        return mono
    if mode not in ("anaglyph", "side-by-side"):
        raise ValueError(f"unknown stereo mode {mode!r}")
    render_l = make_renderer(camera.left)
    render_r = make_renderer(camera.right)
    compose = compose_anaglyph if mode == "anaglyph" else compose_side_by_side

    def stereo(*state):
        return compose(_image_of(render_l(*state)),
                       _image_of(render_r(*state)))

    return stereo


def _image_of(out) -> torch.Tensor:
    if hasattr(out, "color"):
        return out.color
    if isinstance(out, tuple):
        return out[0]
    return out
