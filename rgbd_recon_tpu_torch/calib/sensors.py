"""Runtime calibration containers and their setup fits (counterpart of
rgbd_recon_tpu/calib/sensors.py): frozen dataclasses of tensors with a
leading sensor axis."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.camera import SensorRig
from ..core.grid import BoundingBox
from ..device import DEFAULT, resolve
from ..ops.sampling import trilinear_3d
from .bake import bake_cv_uv, bake_cv_xyz, bake_cv_xyz_inv_analytic
from .frustum import frustum_from_cv_xyz


@dataclasses.dataclass(frozen=True)
class CalibrationSet:
    """All sensors' baked lookup volumes, stacked."""

    cv_xyz: torch.Tensor            # (N, D, H, W, 3)
    cv_uv: torch.Tensor             # (N, D, H, W, 2)
    cv_xyz_inv: torch.Tensor        # (N, Dz, Hy, Wx, 4)
    depth_limits: torch.Tensor      # (N, 2)
    camera_positions: torch.Tensor  # (N, 3)
    bbox_min: torch.Tensor          # (3,)
    bbox_max: torch.Tensor          # (3,)

    @property
    def num_sensors(self) -> int:
        return self.cv_xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cv_xyz.device

    @property
    def bbox(self) -> BoundingBox:
        return BoundingBox(min=tuple(self.bbox_min.tolist()),
                           max=tuple(self.bbox_max.tolist()))


def build_synthetic_calibration(
    rig: SensorRig,
    bbox: BoundingBox,
    cv_res: Tuple[int, int, int] = (32, 64, 32),
    inv_res: Tuple[int, int, int] = (64, 64, 64),
    device=DEFAULT,
) -> CalibrationSet:
    """Bake a full calibration set from analytic sensors in numpy and move it
    to ``device`` (the card unless the caller names another). cv_res is (W, H, D) of the sensor-space volumes; inv_res
    is (X, Y, Z) of the inverse volumes."""
    device = resolve(device)
    cv_xyz_list, cv_uv_list, inv_list, limits, campos = [], [], [], [], []
    for sensor in rig.sensors:
        cv_xyz = bake_cv_xyz(sensor, cv_res)
        cv_xyz_list.append(cv_xyz)
        cv_uv_list.append(bake_cv_uv(sensor, cv_res))
        inv_list.append(bake_cv_xyz_inv_analytic(sensor, bbox, inv_res))
        limits.append([sensor.depth.near, sensor.depth.far])
        campos.append(frustum_from_cv_xyz(cv_xyz).camera_position())

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CalibrationSet(
        cv_xyz=t(np.stack(cv_xyz_list)),
        cv_uv=t(np.stack(cv_uv_list)),
        cv_xyz_inv=t(np.stack(inv_list)),
        depth_limits=t(np.array(limits, np.float32)),
        camera_positions=t(np.stack(campos)),
        bbox_min=t(np.array(bbox.min, np.float32)),
        bbox_max=t(np.array(bbox.max, np.float32)),
    )


@dataclasses.dataclass(frozen=True)
class PixelModels:
    """Per-depth-pixel closed forms of the calibration volumes:
    world ~= ray_a + ray_b * d and color uv ~= (uv_p + uv_q d)/(1 + uv_r d)."""

    ray_a: torch.Tensor  # (N, H, W, 3)
    ray_b: torch.Tensor  # (N, H, W, 3)
    uv_p: torch.Tensor   # (N, H, W, 2)
    uv_q: torch.Tensor   # (N, H, W, 2)
    uv_r: torch.Tensor   # (N, H, W, 2)


@dataclasses.dataclass(frozen=True)
class ProjectionModels:
    """Analytic world -> sensor closed forms per sensor:
    (u, v) = (A p + b) / (c . p + 1), d = g . p + h, and the same projective
    form for the color texcoord."""

    uv_num: torch.Tensor   # (N, 2, 3) A
    uv_off: torch.Tensor   # (N, 2)    b
    uv_den: torch.Tensor   # (N, 3)    c
    d_lin: torch.Tensor    # (N, 3)    g
    d_off: torch.Tensor    # (N,)      h
    cuv_num: torch.Tensor  # (N, 2, 3) color-texcoord A
    cuv_off: torch.Tensor  # (N, 2)    b
    cuv_den: torch.Tensor  # (N, 3)    c

    @staticmethod
    def _projective(A, b, cden, px, py, pz):
        den = px * cden[0] + py * cden[1] + pz * cden[2] + 1.0
        den = torch.where(torch.abs(den) < 1e-8, 1e-8, den)
        inv = 1.0 / den
        u = (px * A[0, 0] + py * A[0, 1] + pz * A[0, 2] + b[0]) * inv
        v = (px * A[1, 0] + py * A[1, 1] + pz * A[1, 2] + b[1]) * inv
        return u, v

    def uvd_p(self, i: int, px, py, pz):
        """Planar world components -> (u, v, depth_norm) planes."""
        u, v = self._projective(self.uv_num[i], self.uv_off[i],
                                self.uv_den[i], px, py, pz)
        g, h = self.d_lin[i], self.d_off[i]
        d = px * g[0] + py * g[1] + pz * g[2] + h
        return u, v, d

    def color_uv_p(self, i: int, px, py, pz):
        """Planar world components -> (u, v) color texcoord planes."""
        return self._projective(self.cuv_num[i], self.cuv_off[i],
                                self.cuv_den[i], px, py, pz)


def derive_projection_models(cv_xyz: torch.Tensor, cv_uv: torch.Tensor
                             ) -> Tuple[ProjectionModels, float]:
    """Least-squares fit of ProjectionModels from the forward calibration
    volumes (float64 numpy, exactly as the JAX package fits them); returns
    (models, max held-out residual in normalized units)."""
    xyz = cv_xyz.detach().cpu().numpy().astype(np.float64)
    uvv = cv_uv.detach().cpu().numpy().astype(np.float64)
    N, D, Hv, Wv, _ = xyz.shape

    def grid(vol, nu, nv, nd):
        iw = np.linspace(0, Wv - 1, nu).round().astype(int)
        ih = np.linspace(0, Hv - 1, nv).round().astype(int)
        idd = np.linspace(0, D - 1, nd).round().astype(int)
        sub = vol[np.ix_(idd, ih, iw)]
        u = (iw + 0.5) / Wv
        v = (ih + 0.5) / Hv
        d = (idd + 0.5) / D
        dd, vv_, uu = np.meshgrid(d, v, u, indexing="ij")
        return sub.reshape(-1, vol.shape[-1]), np.stack(
            [uu.ravel(), vv_.ravel(), dd.ravel()], axis=-1
        )

    def fit_projective(p, target):
        """target = (A p + b) / (c.p + 1): linear system in (A, b, c)."""
        M = p.shape[0]
        rows = np.zeros((2 * M, 11))
        rhs = np.empty(2 * M)
        for ch in range(2):
            r = slice(ch * M, (ch + 1) * M)
            rows[r, ch * 4: ch * 4 + 3] = p
            rows[r, ch * 4 + 3] = 1.0
            rows[r, 8:11] = -target[:, ch: ch + 1] * p
            rhs[r] = target[:, ch]
        sol, *_ = np.linalg.lstsq(rows, rhs, rcond=None)
        A = np.stack([sol[0:3], sol[4:7]])
        b = np.array([sol[3], sol[7]])
        c = sol[8:11]
        return A, b, c

    out = {k: [] for k in ("uv_num", "uv_off", "uv_den", "d_lin", "d_off",
                           "cuv_num", "cuv_off", "cuv_den")}
    max_res = 0.0
    for i in range(N):
        world, uvd = grid(xyz[i], 9, 9, 7)
        A, b, c = fit_projective(world, uvd[:, :2])
        ph = np.concatenate([world, np.ones((world.shape[0], 1))], axis=-1)
        gh, *_ = np.linalg.lstsq(ph, uvd[:, 2], rcond=None)
        cuv_t, _ = grid(uvv[i], 9, 9, 7)
        A2, b2, c2 = fit_projective(world, cuv_t)

        world_h, uvd_h = grid(xyz[i], 13, 13, D if D <= 16 else 16)
        den = world_h @ c + 1.0
        uv_m = (world_h @ A.T + b) / den[:, None]
        d_m = world_h @ gh[:3] + gh[3]
        res = np.abs(np.concatenate(
            [uv_m - uvd_h[:, :2], (d_m - uvd_h[:, 2])[:, None]], axis=-1
        )).max()
        cuv_h, _ = grid(uvv[i], 13, 13, D if D <= 16 else 16)
        den2 = world_h @ c2 + 1.0
        cuv_m = (world_h @ A2.T + b2) / den2[:, None]
        res = max(res, np.abs(cuv_m - cuv_h).max())
        max_res = max(max_res, float(res))

        out["uv_num"].append(A)
        out["uv_off"].append(b)
        out["uv_den"].append(c)
        out["d_lin"].append(gh[:3])
        out["d_off"].append(gh[3])
        out["cuv_num"].append(A2)
        out["cuv_off"].append(b2)
        out["cuv_den"].append(c2)

    models = ProjectionModels(**{
        k: torch.from_numpy(np.stack(v).astype(np.float32)).to(cv_xyz.device)
        for k, v in out.items()
    })
    return models, max_res


def derive_pixel_models(cv_xyz: torch.Tensor, cv_uv: torch.Tensor,
                        depth_hw: Tuple[int, int]
                        ) -> Tuple[PixelModels, float]:
    """Fit PixelModels at depth-map pixel centers; returns (models,
    max |model - trilinear volume| over control depths)."""
    H, W = depth_hw
    dev = cv_xyz.device
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    base = torch.from_numpy(np.stack([uu, vv], axis=-1)).to(dev)

    def at_depth(vol, d):
        coords = torch.cat(
            [base, torch.full((H, W, 1), d, dtype=torch.float32, device=dev)],
            dim=-1)
        return trilinear_3d(vol, coords)

    fields = {k: [] for k in ("ray_a", "ray_b", "uv_p", "uv_q", "uv_r")}
    res = 0.0
    for vol_xyz, vol_uv in zip(cv_xyz, cv_uv):
        d0, d1 = 0.25, 0.75
        w0 = at_depth(vol_xyz, d0)
        w1 = at_depth(vol_xyz, d1)
        ray_b = (w1 - w0) / (d1 - d0)
        ray_a = w0 - ray_b * d0

        # rational fit (p + q d)/(1 + r d) per channel from 3 samples, closed
        # form; singular or pole-in-range pixels take the linear fit (r = 0)
        d1, d2, d3 = 0.2, 0.5, 0.8
        u1 = at_depth(vol_uv, d1)
        u2 = at_depth(vol_uv, d2)
        u3 = at_depth(vol_uv, d3)
        a11, a12, b1 = d2 - d1, -(u2 * d2 - u1 * d1), u2 - u1
        a21, a22, b2 = d3 - d1, -(u3 * d3 - u1 * d1), u3 - u1
        det = a11 * a22 - a12 * a21
        ok = torch.abs(det) > 1e-8
        det_safe = torch.where(ok, det, 1.0)
        uv_r = torch.where(ok, (a11 * b2 - a21 * b1) / det_safe, 0.0)
        ok = ok & (torch.minimum(1.0 + uv_r * 0.0, 1.0 + uv_r * 1.0) > 0.1)
        uv_r = torch.where(ok, uv_r, 0.0)
        uv_q = torch.where(ok, (b1 * a22 - b2 * a12) / det_safe,
                           (u3 - u1) / (d3 - d1))
        uv_p = u1 + (u1 * uv_r - uv_q) * d1

        z_far = 1.0 - 0.5 / vol_xyz.shape[0]
        for d in (0.05, 0.35, 0.65, 0.95, z_far):
            wm = ray_a + ray_b * d
            res = max(res, float((wm - at_depth(vol_xyz, d)).abs().max()))
            um = (uv_p + uv_q * d) / (1.0 + uv_r * d)
            res = max(res, float((um - at_depth(vol_uv, d)).abs().max()))
        for k, val in zip(fields, (ray_a, ray_b, uv_p, uv_q, uv_r)):
            fields[k].append(val)

    return PixelModels(**{k: torch.stack(v) for k, v in fields.items()}), res
