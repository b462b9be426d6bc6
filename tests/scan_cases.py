"""Crafted inputs of the render's interval scan (ops/render_stages.py
scan), for its tests on the CPU (test_torch_scan_shade.py) and on the card
(test_torch_kernels.py): changes of a recorded scan call's brick grid and
camera that reach the edges of the kernel's fold and slab test."""

from types import SimpleNamespace

import torch

from rgbd_recon_tpu_torch.ops import render_stages

# the recorded call; no surface brick (the box lo = n, hi = -1); every
# brick a surface brick; an eye inside the surface bricks' box (the slab
# test's entry clamped to 0); directions without an x component (1 / d =
# +-inf), with the eye inside the x slab and on its face (inf * 0: NaN)
SCAN_CASES = ("recorded", "no_surface_brick", "every_brick_surface",
              "eye_inside_box", "axis_parallel", "axis_parallel_on_face")


def scan_case(g, occ, bsafe, cam, name):
    """(g, occ, bsafe, cam) of the case ``name`` of SCAN_CASES, made from a
    recorded scan call's first four arguments (the camera as a namespace of
    fresh eye_vol and rot tensors)."""
    cam = SimpleNamespace(eye_vol=cam.eye_vol.clone(), rot=cam.rot.clone())
    box_min, box_max = render_stages.surface_aabb(g, occ)
    if name == "no_surface_brick":
        occ = torch.zeros_like(occ)
    elif name == "every_brick_surface":
        occ = torch.ones_like(occ)
    elif name == "eye_inside_box":
        # off the sphere, inside the surface bricks' box
        cam.eye_vol = box_min + 0.1 * (box_max - box_min)
    elif name.startswith("axis_parallel"):
        cam.rot[0] = 0.0
        if name == "axis_parallel_on_face":
            cam.eye_vol[0] = box_min[0]
    else:
        assert name == "recorded", name
    return g, occ, bsafe, cam
