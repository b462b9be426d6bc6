"""The render's per-hit stage (counterpart of the hit path of
rgbd_recon_tpu/recon/tsdf_pipeline.py:1486-1505, and of its _shade_hits at
:695): the secant refine of each hit's crossing bracket, then the normal,
the colour blend over the sensors, the shading and the window depth.

``refine_hits`` and ``shade_hits`` are the dispatch: CUDA tensors go to
csrc/hits.cu (kernels/hits.py: one ``hit_refine`` launch, one ``hit_shade``
launch), CPU tensors to the plain twins ``refine_hits_plain`` (the refines
of ops/raymarch.py) and ``shade_hits_plain``. The kernel shades the
configurations ``kernel_shades`` accepts; under the others (the
camera-influence view, the normal-weighted blends, the profiling switches
"grad" and "blend") ``shade_hits`` runs ``shade_hits_plain`` on any
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import raymarch
from .raymarch import _norm

# the shade modes the kernel draws: textured, Blinn-Phong, normals
KERNEL_SHADE_MODES = (0, 1, 2)


def refine_hits_plain(pos0, dn, lo_t, hi_t, hit, hit_pos, limit: float,
                      oct: Optional[raymarch.OctVolume] = None,
                      table: Optional[torch.Tensor] = None, clamp_floor=None,
                      widen_steps: float = 0.0, widen_samples: int = 6
                      ) -> torch.Tensor:
    """The secant refine of the march's crossing bracket [lo_t, hi_t]: from
    the oct table (``raymarch.oct_refine_crossing``, widened by
    ``widen_steps`` march steps each side when > 0) when one is given, else
    from the march ``table`` (``raymarch.refine_crossing`` with
    ``clamp_floor``). ``pos0`` and ``dn`` are planar (x, y, z) tuples,
    ``hit`` the live mask; hits whose bracket does not confirm the crossing
    keep ``hit_pos``. Returns (..., 3)."""
    if oct is not None:
        return raymarch.oct_refine_crossing(
            oct, pos0, dn, lo_t, hi_t, hit, hit_pos, limit,
            widen_steps=widen_steps, widen_samples=widen_samples)
    return raymarch.refine_crossing(table, pos0, dn, lo_t, hi_t, hit,
                                    hit_pos, clamp_floor=clamp_floor)


def refine_hits(pos0, dn, lo_t, hi_t, hit, hit_pos, limit: float,
                oct: Optional[raymarch.OctVolume] = None,
                table: Optional[torch.Tensor] = None, clamp_floor=None,
                widen_steps: float = 0.0, widen_samples: int = 6
                ) -> torch.Tensor:
    """:func:`refine_hits_plain`: one launch of csrc/hits.cu's refine on
    CUDA tensors, the plain version on CPU tensors. Same arguments and
    result."""
    if hit_pos.device.type == "cpu":
        return refine_hits_plain(pos0, dn, lo_t, hi_t, hit, hit_pos, limit,
                                 oct, table, clamp_floor, widen_steps,
                                 widen_samples)
    from ..kernels.hits import refine_cuda

    return refine_cuda(pos0, dn, lo_t, hi_t, hit, hit_pos, limit, oct, table,
                       clamp_floor, widen_steps, widen_samples)


def kernel_shades(config) -> bool:
    """Whether csrc/hits.cu shades under ``config``: shade modes 0-2, the
    quality blend, neither "grad" nor "blend" in ``debug_skip``."""
    dbg = set(filter(None, config.debug_skip.split(",")))
    return (config.shade_mode in KERNEL_SHADE_MODES
            and config.blend_mode == "quality"
            and not dbg & {"grad", "blend"})


def shade_hits_plain(config, calib, bbox, hit, hit_pos, maps, proj_models,
                     cam, near: float, far: float, limit: float,
                     table: torch.Tensor, clamp_floor=None,
                     oct: Optional[raymarch.OctVolume] = None):
    """Normal, color blend and shading at the hit positions under
    ``config``, in the box ``bbox`` of the calibration ``calib``. The normal
    is the analytic oct-cell gradient with an oct table, else the
    central-difference gradient of the march table; the blend goes through
    the projection models when they fit, else through the calibration
    volumes. ``shade_mode=3`` colors by camera influence, unshaded;
    ``blend_mode`` "normal_deviation" / "best_two" weight the sensors by
    normal agreement. The profiling switches of ``debug_skip``: "grad" a
    fixed +z normal, "blend" a constant 0.7 rgba, unshaded. Returns (rgba,
    window depth)."""
    c = config
    dbg = set(filter(None, c.debug_skip.split(",")))
    bbox_sz = torch.from_numpy(np.asarray(bbox.size, np.float32)
                               ).to(hit_pos.device)
    if "grad" in dbg:
        grad = torch.zeros_like(hit_pos)
        grad[..., 2] = 1.0
    elif oct is not None:
        g, gvalid = oct.gradient_p(hit_pos[..., 0], hit_pos[..., 1],
                                   hit_pos[..., 2])
        grad = -g / torch.clamp_min(_norm(g), 1e-20)
        # hits anchored off the oct table shade with a toward-camera
        # normal
        w = cam.eye_w - (hit_pos * bbox_sz + calib.bbox_min)
        fb = w * bbox_sz
        fb = fb / torch.clamp_min(_norm(fb), 1e-20)
        grad = torch.where(gvalid[..., None], grad, fb)
    else:
        grad = raymarch.gradient_normal(table, hit_pos, limit,
                                        mode=c.march_mode,
                                        clamp_floor=clamp_floor)
    n_world = grad / bbox_sz
    n_world = n_world / torch.clamp_min(_norm(n_world), 1e-20)

    world_pos = hit_pos * bbox_sz + calib.bbox_min
    view_pos = (world_pos - cam.eye_w) @ cam.rot
    view_normal = n_world @ cam.rot
    if "blend" in dbg:
        rgba = torch.full(hit_pos.shape[:-1] + (4,), 0.7,
                          dtype=torch.float32, device=hit_pos.device)
    elif c.shade_mode == 3:
        rgb = raymarch.blend_cameras(hit_pos, calib.cv_xyz_inv,
                                     maps.depth[..., 0], maps.quality,
                                     limit)
        rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    else:
        if c.blend_mode in ("normal_deviation", "best_two"):
            rgba = raymarch.blend_colors_normal(
                hit_pos, world_pos, grad, proj_models, calib.cv_xyz_inv,
                calib.cv_uv, maps.color, maps.depth[..., 0], maps.normal,
                limit, variant=("best_two" if c.blend_mode == "best_two"
                                else "deviation"))
        elif proj_models is not None:
            rgba = raymarch.blend_colors_analytic(
                world_pos, proj_models, maps.color, maps.depth[..., 0],
                maps.quality, limit, dq_taps=c.integrate_taps)
        else:
            blend = (raymarch.blend_colors_fast
                     if c.march_mode == "nearest"
                     else raymarch.blend_colors)
            rgba = blend(hit_pos, calib.cv_xyz_inv, calib.cv_uv,
                         maps.color, maps.depth[..., 0], maps.quality,
                         limit)
        shaded = raymarch.shade(view_pos, view_normal, rgba[..., :3],
                                shade_mode=c.shade_mode,
                                world_normal=n_world)
        rgba = torch.cat([shaded, rgba[..., 3:]], dim=-1)
    view_z = torch.clamp_min(-view_pos[..., 2], near * 1.001)
    depth_win = torch.clamp(
        (1.0 / near - 1.0 / view_z) / (1.0 / near - 1.0 / far), 0.0, 1.0)
    depth_win = torch.where(hit, depth_win, 1.0)
    rgba = torch.where(hit[..., None], rgba, 0.0)
    return rgba, depth_win


def shade_kernel_args(config, calib, bbox, hit, hit_pos, maps, proj_models,
                      cam, near: float, far: float, limit: float,
                      table: torch.Tensor, clamp_floor=None,
                      oct: Optional[raymarch.OctVolume] = None) -> dict:
    """The arguments of ``kernels.hits.shade_cuda`` that draw
    :func:`shade_hits_plain` (same arguments) under a config that
    :func:`kernel_shades` accepts: the normal, blend and shade mode it
    takes, its tables, maps and scalars."""
    c = config
    normal = ("oct" if oct is not None
              else "nearest" if c.march_mode == "nearest" else "trilinear")
    blend = ("analytic" if proj_models is not None
             else "volume_fast" if c.march_mode == "nearest" else "volume")
    return dict(
        hit=hit, hit_pos=hit_pos, color=maps.color,
        depth=maps.depth[..., 0], quality=maps.quality, normal=normal,
        blend=blend, shade_mode=c.shade_mode, limit=limit, eye=cam.eye_w,
        rot=cam.rot, bbox_min=calib.bbox_min, bbox_size=tuple(bbox.size),
        near=near, far=far, table=None if oct is not None else table,
        oct=oct, clamp_floor=clamp_floor,
        dq_bilinear=c.integrate_taps != "nearest", proj_models=proj_models,
        cv_xyz_inv=calib.cv_xyz_inv, cv_uv=calib.cv_uv)


def shade_hits(config, calib, bbox, hit, hit_pos, maps, proj_models, cam,
               near: float, far: float, limit: float, table: torch.Tensor,
               clamp_floor=None, oct: Optional[raymarch.OctVolume] = None):
    """:func:`shade_hits_plain`: one launch of csrc/hits.cu's shade on CUDA
    tensors under a config that :func:`kernel_shades` accepts, the plain
    version on CPU tensors and under the other configs. Same arguments and
    results."""
    args = (config, calib, bbox, hit, hit_pos, maps, proj_models, cam, near,
            far, limit, table, clamp_floor, oct)
    if hit_pos.device.type == "cpu" or not kernel_shades(config):
        return shade_hits_plain(*args)
    from ..kernels.hits import shade_cuda

    return shade_cuda(**shade_kernel_args(*args))
