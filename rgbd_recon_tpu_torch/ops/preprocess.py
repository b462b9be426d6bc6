"""Per-sensor depth preprocessing chain (counterpart of
rgbd_recon_tpu/ops/preprocess.py), batched over the sensor axis.

The reference's 5-pass chain (NetKinectArray::processTextures): morph
dilate, 13x13 bilateral + bbox cull + LAB color, silhouette + boundary
refinement, central-difference normals, quality census. Stencils read
edge-padded maps at integer offsets, which is what GL texture lookups with
clamp-to-edge resolve to. The two 13x13 window reductions come from
``ops/stencil13.py`` (CUDA kernels on the card, plain folds on the CPU).

Each pass (``morph_dilate``, ``lab_colors``, ``bilateral_lab``,
``boundary``, ``normals``, ``quality``) runs its plain PyTorch twin
(``<name>_plain``) on CPU tensors and one launch of its kernel in
csrc/preprocess.cu on CUDA tensors. The four passes that read the
calibration (``lab_colors``, ``bilateral_lab``, ``normals``, ``quality``)
launch only with the pixel models (:func:`kernel_passes`); through the
calibration volumes they run the twin on the card too.

Maps: raw/morphed depth in meters (0 = invalid); processed depth (N, H, W, 2)
holds normalized depth (0 culled, -1 invalidated) and a reliability flag.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import stencil13
from .color import rgb_to_lab
from .sampling import pair_bilinear, trilinear_3d

_MIN_DEPTH = 0.5   # Kinect v2 valid metric depth range (pre_morph.fs:32-33)
_MAX_DEPTH = 4.5
_NUM_SAMPLES = 169.0  # 13x13 window
_MAX_COLOR_DIST = 0.5  # pre_boundary.fs:19-30
_MIN_RANGE = 0.65


@dataclasses.dataclass(frozen=True)
class SensorMaps:
    """All per-sensor intermediate maps (the reference's texture units)."""

    depth: torch.Tensor       # (N, H, W, 2) processed normalized depth + flag
    lab: torch.Tensor         # (N, H, W, 3) LAB color at depth resolution
    silhouette: torch.Tensor  # (N, H, W)
    normal: torch.Tensor      # (N, H, W, 3) world-space normals
    quality: torch.Tensor     # (N, H, W) fusion weights
    raw_depth: torch.Tensor   # (N, H, W) morphed metric depth
    color: torch.Tensor       # (N, Hc, Wc, 3) raw rgb (pass-through)


def _pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W) -> (N, H+2k, W+2k), edge-replicated."""
    return F.pad(x, (k, k, k, k), mode="replicate")


def _shift(p: torch.Tensor, k: int, dy: int, dx: int, H: int, W: int):
    return p[:, k + dy: k + dy + H, k + dx: k + dx + W]


def _pow6(x):
    # the multiply order of XLA's integer_pow(x, 6)
    x2 = x * x
    return x2 * (x2 * x2)


def _far_plane(cv_uv) -> float:
    """Where the pixel models evaluate a degenerate depth: the last texel
    plane of the calibration volumes (their GL clamp of z = 1.0)."""
    return 1.0 - 0.5 / cv_uv.shape[1] if cv_uv is not None else 1.0


def _texcoords(H: int, W: int, device):
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    return (torch.from_numpy(uu).to(device), torch.from_numpy(vv).to(device))


def morph_dilate_plain(depth: torch.Tensor) -> torch.Tensor:
    """Morphological dilate (pre_morph.fs:73-112): invalid pixels take the
    two-pass outlier-rejecting mean of their valid 3x3 neighbors."""
    N, H, W = depth.shape
    pad = _pad(depth, 1)
    valid_c = (depth > _MIN_DEPTH) & (depth < _MAX_DEPTH)
    sum1 = torch.zeros_like(depth)
    cnt1 = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(pad, 1, dy, dx, H, W)
            v = (s > _MIN_DEPTH) & (s < _MAX_DEPTH)
            sum1 = sum1 + torch.where(v, s, 0.0)
            cnt1 = cnt1 + v.to(depth.dtype)
    any_valid = cnt1 > 0
    avg = sum1 / torch.clamp_min(cnt1, 1.0)
    sum2 = torch.zeros_like(depth)
    cnt2 = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(pad, 1, dy, dx, H, W)
            v = ((s > _MIN_DEPTH) & (s < _MAX_DEPTH)
                 & (torch.abs(avg - s) < 0.2))
            sum2 = sum2 + torch.where(v, s, 0.0)
            cnt2 = cnt2 + v.to(depth.dtype)
    filled = torch.where(cnt2 > 0, sum2 / torch.clamp_min(cnt2, 1.0), 0.0)
    filled = torch.where(any_valid, filled, 0.0)
    return torch.where(valid_c, depth, filled)


def bilateral_lab_plain(depth_m, bbox_min, bbox_max, depth_limits, bf_sums,
                        pixel_models=None, cv_xyz=None) -> torch.Tensor:
    """Bilateral depth filter + bbox cull (pre_depth.fs). The LAB half of the
    pass is :func:`lab_colors`. ``bf_sums`` are the 13x13 window sums of
    stencil13.bilateral13, or None for the unfiltered depth (filter off).
    Returns depth2 (N, H, W, 2): [normalized depth, range confidence]."""
    N, H, W = depth_m.shape
    near = depth_limits[:, 0].view(N, 1, 1)
    far = depth_limits[:, 1].view(N, 1, 1)

    def norm_d(d):
        return (d - near) / (far - near)     # pre_depth.fs:78-80

    depth_norm = norm_d(depth_m)
    if pixel_models is not None:
        in_box = torch.ones(depth_m.shape, dtype=torch.bool,
                            device=depth_m.device)
        for j in range(3):
            wj = (pixel_models.ray_a[..., j]
                  + pixel_models.ray_b[..., j] * depth_norm)
            in_box = in_box & (wj >= bbox_min[j]) & (wj <= bbox_max[j])
    else:
        uu, vv = _texcoords(H, W, depth_m.device)
        pos = torch.stack([
            trilinear_3d(cv_xyz[i],
                         torch.stack([uu, vv, depth_norm[i]], dim=-1))
            for i in range(N)
        ])
        in_box = ((pos >= bbox_min) & (pos <= bbox_max)).all(dim=-1)

    if bf_sums is None:
        depth2 = torch.stack([depth_norm, torch.ones_like(depth_norm)], -1)
        return torch.where(in_box[..., None], depth2, 0.0)

    depth_bf, w, w_range = bf_sums
    filtered = depth_bf / torch.clamp_min(w, 1e-20)
    depth2 = torch.stack([norm_d(filtered), w_range / _NUM_SAMPLES], dim=-1)
    return torch.where(in_box[..., None], depth2, 0.0)   # :143-146


def boundary_plain(depth2: torch.Tensor, lab: torch.Tensor,
                   refine: bool = True):
    """Silhouette extraction + color-consistent boundary refinement
    (pre_boundary.fs:86-118). Returns (depth2', silhouette). Flags in
    channel 1: 0 valid interior, 1 refine-kept boundary, 0.1 invalidated
    (depth -1), 0 outside the bbox."""
    N, H, W = depth2.shape[:3]
    ks = 2
    d0, q0 = depth2[..., 0], depth2[..., 1]
    L0, A0, B0 = lab[..., 0], lab[..., 1], lab[..., 2]
    pd, pq, pL, pA, pB = (_pad(p, ks) for p in (d0, q0, L0, A0, B0))

    # get_color_diff (:37-55): mean LAB distance over valid 5x5 neighbors
    total_dist = torch.zeros_like(d0)
    cnt = torch.zeros_like(d0)
    for dy in range(-ks, ks + 1):
        for dx in range(-ks, ks + 1):
            def sl(p):
                return _shift(p, ks, dy, dx, H, W)
            v = (sl(pd) > 0.0) & (sl(pq) > _MIN_RANGE)
            dl, da, db = L0 - sl(pL), A0 - sl(pA), B0 - sl(pB)
            dist = torch.sqrt(dl * dl + da * da + db * db)
            total_dist = total_dist + torch.where(v, dist, 0.0)
            cnt = cnt + v.to(d0.dtype)
    total_samples = float((2 * ks) * (2 * ks))  # :23 (16, not 25 — kept)
    color_diff = torch.where(cnt < total_samples * 0.5, 1.0,
                             total_dist / torch.clamp_min(cnt, 1.0))

    outside = d0 <= 0.0
    unreliable = (~outside) & (q0 <= _MIN_RANGE)
    kept = unreliable & (color_diff <= _MAX_COLOR_DIST) & bool(refine)
    invalidated = unreliable & ~kept
    new_d = torch.where(invalidated, -1.0, d0)
    new_q = torch.where(outside, 0.0, torch.where(
        invalidated, 0.1, torch.where(kept, 1.0, 0.0)))
    sil = torch.where(outside | unreliable, 0.0, 1.0)
    return torch.stack([new_d, new_q], dim=-1), sil


def normals_plain(depth2: torch.Tensor, pixel_models=None,
                  cv_xyz=None) -> torch.Tensor:
    """Central-difference world-space normals (pre_normal.fs:26-56); invalid
    neighbors are replaced by the center depth."""
    N, H, W = depth2.shape[:3]
    d = depth2[..., 0]
    valid = (d > 0.0) & (d < 1.0)
    pad = _pad(d, 1)

    if pixel_models is not None:
        a_pads = [_pad(pixel_models.ray_a[..., j], 1) for j in range(3)]
        b_pads = [_pad(pixel_models.ray_b[..., j], 1) for j in range(3)]

        def world_at(du, dv, dy, dx):
            ds = _shift(pad, 1, dy, dx, H, W)
            ds = torch.where((ds <= 0.0) | (ds >= 1.0), d, ds)
            return [_shift(a_pads[j], 1, dy, dx, H, W)
                    + _shift(b_pads[j], 1, dy, dx, H, W) * ds
                    for j in range(3)]
    else:
        uu, vv = _texcoords(H, W, d.device)

        def world_at(du, dv, dy, dx):
            ds = _shift(pad, 1, dy, dx, H, W)
            ds = torch.where((ds <= 0.0) | (ds >= 1.0), d, ds)
            w3 = torch.stack([
                trilinear_3d(cv_xyz[i], torch.stack(
                    [uu + du / W, vv + dv / H, ds[i]], dim=-1))
                for i in range(N)
            ])
            return [w3[..., j] for j in range(3)]

    world_t = world_at(0.0, 1.0, 1, 0)
    world_b = world_at(0.0, -1.0, -1, 0)
    world_l = world_at(-1.0, 0.0, 0, -1)
    world_r = world_at(1.0, 0.0, 0, 1)
    e1 = [world_b[j] - world_t[j] for j in range(3)]
    e2 = [world_l[j] - world_r[j] for j in range(3)]
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    inv_n = 1.0 / torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz),
                                  1e-20)
    return torch.stack([torch.where(valid, c * inv_n, 0.0)
                        for c in (nx, ny, nz)], dim=-1)


def quality_plain(depth2, normal, camera_positions, q_sums,
                  pixel_models=None, cv_xyz=None) -> torch.Tensor:
    """Per-pixel fusion weight (pre_quality.fs:65-119):
    (1 - border_frac)^6 * (mean range weight)^6 / (depth * 6.5)
    * cos(view angle)^2; ``q_sums`` are the 13x13 census sums of
    stencil13.quality13 on the normalized depth."""
    N, H, W = depth2.shape[:3]
    d = depth2[..., 0]
    inside = (d > 0.0) & (d < 1.0)
    border, w_range = q_sums
    lateral = 1.0 - border / _NUM_SAMPLES
    q = _pow6(lateral) * _pow6(w_range / _NUM_SAMPLES)
    q = q / torch.clamp_min(d * 6.5, 1e-20)

    if pixel_models is not None:
        world = pixel_models.ray_a + pixel_models.ray_b * d[..., None]
    else:
        uu, vv = _texcoords(H, W, d.device)
        world = torch.stack([
            trilinear_3d(cv_xyz[i], torch.stack([uu, vv, d[i]], dim=-1))
            for i in range(N)
        ])
    to_cam = camera_positions.view(N, 1, 1, 3) - world
    norm = torch.sqrt((to_cam * to_cam).sum(dim=-1, keepdim=True))
    to_cam = to_cam / torch.clamp_min(norm, 1e-20)
    angle = (to_cam * normal).sum(dim=-1)
    q = q * (angle * angle)
    return torch.where(inside, q, 0.0)


def lab_colors_plain(colors, depth_norm, pixel_models=None, cv_uv=None):
    """(N, H, W, 3) LAB color at depth resolution (pre_depth.fs:129-137).
    The color table is rounded to bf16 as the reference's fast path stores
    it. Degenerate-depth pixels sample at the far plane: z = 1.0 through the
    volumes, the last texel plane through the analytic models."""
    N, H, W = depth_norm.shape
    col = colors.to(torch.bfloat16)
    z_far = _far_plane(cv_uv)
    z = torch.where((depth_norm <= 0.0) | (depth_norm >= 1.0),
                    1.0 if pixel_models is None else z_far, depth_norm)
    if pixel_models is not None:
        ze = z[..., None]
        coords = ((pixel_models.uv_p + pixel_models.uv_q * ze)
                  / (1.0 + pixel_models.uv_r * ze))
    else:
        uu, vv = _texcoords(H, W, depth_norm.device)
        coords = torch.stack([
            trilinear_3d(cv_uv[i], torch.stack([uu, vv, z[i]], dim=-1))
            for i in range(N)
        ])
    return torch.stack([
        rgb_to_lab(pair_bilinear(col[i], coords[i, ..., 0], coords[i, ..., 1]))
        for i in range(N)
    ])


def kernel_passes(x: torch.Tensor, pixel_models) -> bool:
    """Whether a pass that reads the calibration launches its kernel: on a
    CUDA tensor with the pixel models. The calibration volumes' trilinear
    lookups (``pixel_models=None``) have no kernel: their twins run."""
    return x.device.type != "cpu" and pixel_models is not None


def morph_dilate(depth: torch.Tensor) -> torch.Tensor:
    """:func:`morph_dilate_plain`: one launch of csrc/preprocess.cu on a
    CUDA tensor, the twin on a CPU tensor."""
    if depth.device.type == "cpu":
        return morph_dilate_plain(depth)
    from ..kernels.preprocess import morph_cuda

    return morph_cuda(depth.contiguous())


def lab_colors(colors, depth_norm, pixel_models=None, cv_uv=None):
    """:func:`lab_colors_plain`: one launch of csrc/preprocess.cu on CUDA
    tensors with the pixel models (:func:`kernel_passes`), else the twin."""
    if not kernel_passes(depth_norm, pixel_models):
        return lab_colors_plain(colors, depth_norm, pixel_models, cv_uv)
    from ..kernels.preprocess import lab_cuda

    return lab_cuda(colors.contiguous(), depth_norm.contiguous(),
                    pixel_models, _far_plane(cv_uv))


def bilateral_lab(depth_m, bbox_min, bbox_max, depth_limits, bf_sums,
                  pixel_models=None, cv_xyz=None) -> torch.Tensor:
    """:func:`bilateral_lab_plain`: one launch of csrc/preprocess.cu on CUDA
    tensors with the pixel models (:func:`kernel_passes`), else the twin."""
    if not kernel_passes(depth_m, pixel_models):
        return bilateral_lab_plain(depth_m, bbox_min, bbox_max, depth_limits,
                                   bf_sums, pixel_models, cv_xyz)
    from ..kernels.preprocess import depth2_cuda

    dev = depth_m.device
    box = [torch.as_tensor(b, dtype=torch.float32, device=dev).contiguous()
           for b in (bbox_min, bbox_max)]
    return depth2_cuda(depth_m.contiguous(), *box, depth_limits.contiguous(),
                       bf_sums, pixel_models)


def boundary(depth2: torch.Tensor, lab: torch.Tensor, refine: bool = True):
    """:func:`boundary_plain`: one launch of csrc/preprocess.cu on CUDA
    tensors, the twin on CPU tensors."""
    if depth2.device.type == "cpu":
        return boundary_plain(depth2, lab, refine)
    from ..kernels.preprocess import boundary_cuda

    return boundary_cuda(depth2.contiguous(), lab.contiguous(), refine)


def normals(depth2: torch.Tensor, pixel_models=None,
            cv_xyz=None) -> torch.Tensor:
    """:func:`normals_plain`: one launch of csrc/preprocess.cu on CUDA
    tensors with the pixel models (:func:`kernel_passes`), else the twin."""
    if not kernel_passes(depth2, pixel_models):
        return normals_plain(depth2, pixel_models, cv_xyz)
    from ..kernels.preprocess import normals_cuda

    return normals_cuda(depth2.contiguous(), pixel_models)


def quality(depth2, normal, camera_positions, q_sums, pixel_models=None,
            cv_xyz=None) -> torch.Tensor:
    """:func:`quality_plain`: one launch of csrc/preprocess.cu on CUDA
    tensors with the pixel models (:func:`kernel_passes`), else the twin."""
    if not kernel_passes(depth2, pixel_models):
        return quality_plain(depth2, normal, camera_positions, q_sums,
                             pixel_models, cv_xyz)
    from ..kernels.preprocess import quality_cuda

    return quality_cuda(depth2.contiguous(), normal.contiguous(),
                        camera_positions.contiguous(), q_sums, pixel_models)


def preprocess_frames(depths, colors, cv_xyz, cv_uv, bbox_min, bbox_max,
                      depth_limits, camera_positions, morph: bool = True,
                      bilateral: bool = True, refine: bool = True,
                      pixel_models=None) -> SensorMaps:
    """The whole chain over all sensors. The two 13x13 window reductions
    run through stencil13 and every other pass through its dispatcher
    (CUDA kernels for CUDA tensors)."""
    N = depths.shape[0]
    d_m = morph_dilate(depths) if morph else depths
    d_m = d_m.contiguous()
    bf_sums = None
    if bilateral:
        bf_sums = stencil13.bilateral13(d_m, depth_limits.contiguous())
    near = depth_limits[:, 0].view(N, 1, 1)
    far = depth_limits[:, 1].view(N, 1, 1)
    labs = lab_colors(colors, (d_m - near) / (far - near), pixel_models,
                      cv_uv)
    depth2 = bilateral_lab(d_m, bbox_min, bbox_max, depth_limits, bf_sums,
                           pixel_models=pixel_models, cv_xyz=cv_xyz)
    depth2, sil = boundary(depth2, labs, refine)
    nrm = normals(depth2, pixel_models, cv_xyz)
    q_sums = stencil13.quality13(depth2[..., 0].contiguous())
    qual = quality(depth2, nrm, camera_positions, q_sums, pixel_models,
                   cv_xyz)
    return SensorMaps(depth=depth2, lab=labs, silhouette=sil, normal=nrm,
                      quality=qual, raw_depth=d_m, color=colors)
