"""Sensor-pose refinement: Levenberg-Marquardt over depth-to-TSDF residuals
(counterpart of rgbd_recon_tpu/refine/pose_ba.py).

Each sensor gets a 6-DoF correction (rotation vector + translation), found
by minimizing the fused TSDF sampled at that sensor's observed surface
points:

  r_ij = TSDF( T_i . x_ij )          x_ij = cv_xyz_i(u_j, v_j, d_ij)
  E = sum_ij  w_ij . r_ij^2

The 6x6 normal equations per sensor are reductions over the points
(J^T W J, J^T W r); the (P, 6) Jacobian comes from forward-mode
differentiation (torch.func.jacfwd) through the trilinear TSDF sample.
Every product of points, rotations and the 6x6 systems is written out
elementwise, so it is full f32 whatever the process's TF32 settings; the
reductions over the points add in f64 and round once to f32, so that a
sum split over shards (the mesh form) gives what one device gives; the
LM step's eigh and solve (LAPACK on the CPU, cuSOLVER on the card) run in
f32, batched over the sensors on their device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..calib.sensors import CalibrationSet
from ..ops.sampling import trilinear_3d


def _matvec3(R: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """R (3, 3) applied to the points q (..., 3): sum_j q_j R[:, j]."""
    return (q[..., 0:1] * R[:, 0] + q[..., 1:2] * R[:, 1]
            + q[..., 2:3] * R[:, 2])


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3,) -> rotation matrix (3, 3). Small angles take
    the series of sin(t)/t and (1 - cos(t))/t^2 in theta^2, and the other
    branch sees theta^2 = 1 there (a double where), so the derivative at
    w = 0 is finite and equals the JAX package's."""
    theta2 = (w * w).sum()
    small = theta2 < 1e-12
    safe_t2 = torch.where(small, 1.0, theta2)
    safe_t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    z = torch.zeros_like(w[0])
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    KK = torch.stack([_matvec3(K, K[:, j]) for j in range(3)], dim=-1)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * KK


def apply_pose(params: torch.Tensor, points: torch.Tensor,
               center=0.0) -> torch.Tensor:
    """params (6,) = [rotation vector (3), translation (3)] applied to world
    points (..., 3): x' = R (x - center) + center + t. ``center`` should be
    the scene (bbox) center: about the world origin, rotation and
    translation couple over the scene's lever arm and the solver's
    zero-correction prior biases the estimate along that valley."""
    R = _rodrigues(params[:3])
    return _matvec3(R, points - center) + center + params[3:]


def _surface_points(calib, maps, sensor: int, stride: int = 1):
    """Observed world-space surface points of one sensor and their weights:
    the processed depth's valid pixels through cv_xyz, the lookup the
    integration uses."""
    depth2 = maps.depth[sensor]
    H, W = depth2.shape[:2]
    dev = depth2.device
    u = (torch.arange(0, W, stride, dtype=torch.float32, device=dev)
         + 0.5) / W
    v = (torch.arange(0, H, stride, dtype=torch.float32, device=dev)
         + 0.5) / H
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    d = depth2[::stride, ::stride, 0]
    q = maps.quality[sensor, ::stride, ::stride]
    valid = (d > 0.0) & (d < 1.0)
    pts = trilinear_3d(calib.cv_xyz[sensor], torch.stack([uu, vv, d], -1))
    w = torch.where(valid, torch.clamp_min(q, 1e-4), 0.0)
    return pts.reshape(-1, 3), w.reshape(-1)


def _tsdf_at(volume, bbox_min, bbox_size, world: torch.Tensor):
    norm = (world - bbox_min) / bbox_size
    return trilinear_3d(volume[..., None], norm)[..., 0]


def _obs_at(obs, bbox_min, bbox_size, world: torch.Tensor):
    """Nearest-voxel observer count (counts are piecewise constant;
    trilinear would blur hard coverage boundaries)."""
    Z, Y, X = obs.shape
    n = (world - bbox_min) / bbox_size
    xi = torch.clamp((n[..., 0] * X).to(torch.int32), 0, X - 1)
    yi = torch.clamp((n[..., 1] * Y).to(torch.int32), 0, Y - 1)
    zi = torch.clamp((n[..., 2] * Z).to(torch.int32), 0, Z - 1)
    return obs.reshape(-1)[((zi * Y + yi) * X + xi).to(torch.int64)]


def _obs_weight(obs, bbox_min, bbox_size, world, min_observers):
    """Soft contamination weight from the observer count at a point: 1 for
    a full multi-witness consensus, 0.3 for single-witness regions, 0 where
    no other sensor looked (hard masking starves the solver where coverage
    is thin)."""
    c = _obs_at(obs, bbox_min, bbox_size, world)
    full = (c >= min_observers - 0.5).to(torch.float32)
    single = ((c >= 0.5) & (c < min_observers - 0.5)).to(torch.float32)
    return full + 0.3 * single


def _gradient_trim(J, wm, sums, k: float = 2.0):
    """Zero the weight of points whose TSDF gradient magnitude exceeds k
    times the weighted mean, from ``sums``: the :func:`_trim_sums` of the
    whole point set, which the points may be a shard of. The translation
    block of J is the volume gradient; a clean truncated SDF has |grad| ~ 1
    band per band, while the transition zones around unknown (-limit)
    regions of a leave-one-out consensus jump by a whole band over one
    voxel, and bias the solve."""
    gsum, wsum = sums
    m = (gsum / torch.clamp_min(wsum, 1e-20)).to(torch.float32)
    return torch.where(_grad_norm(J) < k * m, wm, 0.0)


def _grad_norm(J):
    return torch.sqrt((J[:, 3:] * J[:, 3:]).sum(dim=1))


def _trim_sums(J, wm):
    """(sum |grad| w, sum w) of the gradient trim's mean, in f64."""
    wd = wm.to(torch.float64)
    return (_grad_norm(J).to(torch.float64) * wd).sum(), wd.sum()


def _normal_equations(params, pts, w, volume, bbox_min, bbox_size, limit,
                      center=0.0, mask_floor=None, observers=None,
                      min_observers: float = 2.0):
    """(J^T W J, J^T W r, mean |r| over the active set) for one sensor's
    points, on their device: :func:`_normal_equations_mesh` over one
    shard."""
    from ..dist.mesh import make_mesh

    return _normal_equations_mesh(
        params, pts, w, volume, bbox_min, bbox_size, limit,
        make_mesh(device=params.device), center, mask_floor, observers,
        min_observers)


def _normal_terms(params, pts, w, volume, bbox_min, bbox_size, limit,
                  center=0.0, mask_floor=None, observers=None,
                  min_observers: float = 2.0):
    """(J, r, wm): the (P, 6) Jacobian of the TSDF residuals r through
    apply_pose and the trilinear sample, and the weights of the active set
    before the gradient trim. The active set is asymmetric: residuals
    above ``mask_floor`` (default -0.999 limit) and below 0.999 limit;
    ``observers`` weighs each point by _obs_weight."""

    def resid(p):
        return _tsdf_at(volume, bbox_min, bbox_size,
                        apply_pose(p, pts, center))

    moved = apply_pose(params, pts, center)
    r = _tsdf_at(volume, bbox_min, bbox_size, moved)
    floor = -limit * 0.999 if mask_floor is None else mask_floor
    mask = (r > floor) & (r < limit * 0.999) & (w > 0.0)
    ow = 1.0
    if observers is not None:
        ow = _obs_weight(observers, bbox_min, bbox_size, moved,
                         min_observers)
    J = torch.func.jacfwd(resid)(params)                 # (P, 6)
    return J, r, torch.where(mask, w * ow, 0.0)


def _normal_sums(J, r, wm):
    """(J^T W J, J^T W r, sum |r| over the active points, their count), in
    f64: these sums reassociate only at f64 rounding when the points are
    split over shards."""
    Jd, wd = J.to(torch.float64), wm.to(torch.float64)
    rd = r.to(torch.float64)
    JtWJ = (Jd[:, :, None] * (Jd * wd[:, None])[:, None, :]).sum(dim=0)
    JtWr = (Jd * (rd * wd)[:, None]).sum(dim=0)
    active = (wm > 0.0).to(torch.float64)
    return JtWJ, JtWr, (torch.abs(rd) * active).sum(), active.sum()


def _normal_result(JtWJ, JtWr, num, den):
    """:func:`_normal_sums` rounded to f32: (J^T W J, J^T W r, mean |r|)."""
    f32 = torch.float32
    return (JtWJ.to(f32), JtWr.to(f32),
            (num / torch.clamp_min(den, 1.0)).to(f32))


def _normal_equations_mesh(params, pts, w, volume, bbox_min, bbox_size,
                           limit, mesh, center=0.0, mask_floor=None,
                           observers=None, min_observers: float = 2.0):
    """(J^T W J, J^T W r, mean |r| over the active set) for one sensor's
    points, split over the mesh's shards: each shard builds the Jacobian of
    its contiguous slice of the points on its device; the gradient trim's
    mean meets in a psum, then each shard reduces its points into J^T W J,
    J^T W r and the residual sums, and these meet in a psum (added in shard
    order on the first device). ``pts`` / ``w`` must divide evenly over the
    shards (pad with w = 0). The trim's mean is the whole point set's and
    every sum adds in f64 before one rounding to f32, so the result is one
    shard's but for f64 reassociation; the JAX package's mesh form takes
    each shard's own mean, sums in f32 and drops ``observers``."""
    from ..dist.collectives import broadcast, psum, scatter

    devs = mesh.devices
    n = pts.shape[0] // len(devs)
    center = torch.as_tensor(center, dtype=torch.float32,
                             device=params.device)
    shared = [broadcast(t, devs) for t in (params, volume, bbox_min,
                                           bbox_size, center)]
    obs = None if observers is None else broadcast(observers, devs)
    terms = []
    for s, dev in enumerate(devs):
        sl = slice(s * n, (s + 1) * n)
        p_d, vol_d, lo_d, size_d, c_d = (t[dev] for t in shared)
        terms.append(_normal_terms(
            p_d, scatter(pts[sl], s, dev), scatter(w[sl], s, dev), vol_d,
            lo_d, size_d, limit, c_d, mask_floor,
            None if obs is None else obs[dev], min_observers))
    trim = [_trim_sums(J, wm) for J, _, wm in terms]
    sums = [broadcast(psum([t[k] for t in trim], devs[0]), devs)
            for k in range(2)]
    parts = [_normal_sums(J, r, _gradient_trim(
        J, wm, tuple(t[J.device] for t in sums)))
        for J, r, wm in terms]
    return _normal_result(*(psum([q[k] for q in parts], devs[0])
                            for k in range(4)))


def leave_one_out_volumes(pipeline, maps, brick_counts, limit=None,
                          return_observers: bool = False):
    """(N, Z, Y, X) volumes, volume i fused without sensor i: a sensor is
    aligned against the consensus of the others, not against the doubled
    surface its own misaligned depth made. Sensor i is neutralised by a
    depth of -100 (beyond the band everywhere), a full silhouette (no
    carving) and zero quality. ``limit`` overrides the band; a band wider
    than 1.5 x the nominal limit on a brick-compact pipeline integrates
    densely (the compact volume holds only occupied bricks' voxels).
    ``return_observers`` also returns the (N, Z, Y, X) observer counts of
    the other sensors (dense integration)."""
    vols, obs = [], []
    N = maps.depth.shape[0]
    for i in range(N):
        sel = torch.arange(N, device=maps.depth.device) != i
        m = dataclasses.replace(
            maps,
            depth=torch.where(sel[:, None, None, None], maps.depth, -100.0),
            silhouette=torch.where(sel[:, None, None], maps.silhouette, 1.0),
            quality=torch.where(sel[:, None, None], maps.quality, 0.0),
        )
        wide = (limit is not None and pipeline.compact
                and limit > pipeline.config.tsdf_limit * 1.5)
        if return_observers:
            v, o = pipeline.integrate_dense(m, limit=limit,
                                            return_observers=True)
            vols.append(v)
            obs.append(o)
        elif wide:
            vols.append(pipeline.integrate_dense(m, limit=limit))
        else:
            vols.append(pipeline.integrate(m, brick_counts, limit=limit))
    if return_observers:
        return torch.stack(vols), torch.stack(obs)
    return torch.stack(vols)


def _lm_update(params, JtWJ, JtWr, lam):
    """One damped step for each sensor, batched on the sensors' device:
    params (N, 6), JtWJ (N, 6, 6), JtWr (N, 6), lam (N,) -> (N, 6).
    Marquardt scaling (damping relative to each parameter's curvature plus
    a floor at the mean), a zero-correction prior on the near-null
    directions only (full below 2% of the mean curvature, 1% of it
    elsewhere: the eigen-split of JtWJ), and a trust region of 0.01 rad /
    10 mm per step."""
    d = torch.diagonal(JtWJ, dim1=-2, dim2=-1)                 # (N, 6)
    mean_d = d.mean(dim=-1, keepdim=True)                      # (N, 1)
    evals, evecs = torch.linalg.eigh(JtWJ)
    mu_dir = 0.05 * mean_d * torch.where(evals < 0.02 * mean_d, 1.0, 0.01)
    # V diag(mu_dir) V^T and its product with params, elementwise
    Pmu = (evecs[:, :, None, :] * mu_dir[:, None, None, :]
           * evecs[:, None, :, :]).sum(dim=-1)
    eye = torch.eye(6, dtype=JtWJ.dtype, device=JtWJ.device)
    A = (JtWJ + lam[:, None, None] * (torch.diag_embed(d)
                                      + mean_d[..., None] * eye) + Pmu)
    # a sensor without active points has A = 0: like LAPACK's solve in the
    # JAX package this yields a non-finite step, whose cost the accept
    # test then rejects, instead of raising
    delta = torch.linalg.solve_ex(
        A, JtWr + (Pmu * params[:, None, :]).sum(dim=-1))[0]
    rot_n = torch.linalg.norm(delta[:, :3], dim=-1)
    tr_n = torch.linalg.norm(delta[:, 3:], dim=-1)
    scale = torch.clamp_max(torch.minimum(
        0.01 / torch.clamp_min(rot_n, 1e-12),
        0.010 / torch.clamp_min(tr_n, 1e-12)), 1.0)
    return params - delta * scale[:, None]


def refine_poses(calib, maps, volume, limit: float, iters: int = 5,
                 damping: float = 1e-4, stride: int = 2, volumes=None,
                 anchor: bool = False, mesh=None, axis_name: str = "z",
                 init=None, mask_floor: float = None, observers=None,
                 min_observers: float = 2.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sensor pose corrections against the fused TSDF: ``volumes``
    (N, Z, Y, X) from :func:`leave_one_out_volumes` aligns each sensor
    against the others' consensus (the well-posed form), ``volume`` alone
    against the joint volume.

    Levenberg-Marquardt per sensor: each iteration freezes the active set
    at the current poses (so a step cannot 'improve' by pushing points out
    of the band), builds a candidate from the normal equations, and keeps
    it when its cost over the frozen set, with residuals clamped at the
    band, is lower; the damping then falls by 0.3x, else rises by 10x,
    within [1e-6, 1e3]. ``init`` continues from an earlier estimate;
    ``anchor`` removes the rig-wide mean motion. ``mesh`` (a dist.Mesh
    whose first device holds the maps; by default one shard there) splits
    each sensor's points over its shards, padded with zero-weight points to
    a multiple of the shards: the normal equations reduce per shard and
    meet in a psum (:func:`_normal_equations_mesh`); the accept / reject
    costs run on the first device. The mesh must be of one process.

    Returns (poses (N, 6), per-iteration mean |r| at the iteration's start
    (iters, N))."""
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min
    center = bbox_min + 0.5 * bbox_size
    N = maps.depth.shape[0]
    dev = maps.depth.device
    pts, ws = zip(*(_surface_points(calib, maps, i, stride)
                    for i in range(N)))
    from ..dist.mesh import _no_spanning, _pad_to_multiple, make_mesh

    if mesh is None:
        mesh = make_mesh(device=dev)
    _no_spanning(mesh, "refine_poses(mesh=...)")
    # the point axis must divide over the shards: zero-weight padding
    pts_m = [_pad_to_multiple(p, 0, mesh.size)[0] for p in pts]
    ws_m = [_pad_to_multiple(w, 0, mesh.size)[0] for w in ws]
    vols = volumes if volumes is not None else volume.expand(
        (N,) + tuple(volume.shape))

    def active_mask(params, i):
        moved = apply_pose(params, pts[i], center)
        r = _tsdf_at(vols[i], bbox_min, bbox_size, moved)
        floor = -limit * 0.999 if mask_floor is None else mask_floor
        m = ((r > floor) & (r < limit * 0.999) & (ws[i] > 0.0)).to(
            torch.float32)
        if observers is not None:
            m = m * _obs_weight(observers[i], bbox_min, bbox_size, moved,
                                min_observers)
        return m

    def masked_cost(params, i, mask):
        r = _tsdf_at(vols[i], bbox_min, bbox_size,
                     apply_pose(params, pts[i], center))
        rc = torch.clamp_max(torch.abs(r), limit)
        wm = ws[i] * mask
        return (wm * rc * rc).sum() / torch.clamp_min(wm.sum(), 1e-20)

    poses = (torch.zeros((N, 6), dtype=torch.float32, device=dev)
             if init is None else torch.as_tensor(
                 init, dtype=torch.float32, device=dev).clone())
    lam = torch.full((N,), max(damping, 1e-2), dtype=torch.float32,
                     device=dev)
    history = []
    for _ in range(iters):
        masks = [active_mask(poses[i], i) for i in range(N)]
        JtWJ, JtWr, ress = (torch.stack(t) for t in zip(*(
            _normal_equations_mesh(
                poses[i], pts_m[i], ws_m[i], vols[i], bbox_min, bbox_size,
                limit, mesh, center, mask_floor,
                observers=None if observers is None else observers[i],
                min_observers=min_observers)
            for i in range(N))))
        cands = _lm_update(poses, JtWJ, JtWr, lam)
        better = torch.stack([masked_cost(cands[i], i, masks[i])
                              < masked_cost(poses[i], i, masks[i])
                              for i in range(N)])
        poses = torch.where(better[:, None], cands, poses)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 10.0),
                          1e-6, 1e3)
        history.append(ress)
    if anchor:
        poses = poses - poses.mean(dim=0, keepdim=True)
    return poses, torch.stack(history)


def apply_pose_corrections(calib, poses: torch.Tensor) -> CalibrationSet:
    """Compose per-sensor corrections into a new calibration (on the same
    device): the forward volumes cv_xyz and the camera positions transform
    directly (x' = R x + t, the center-relative pose folded into an
    origin-form affine), cv_uv is unchanged (sensor space), and the inverse
    volumes cv_xyz_inv are resampled at R^T (p - t), a trilinear warp of
    the (N, Z, Y, X, 4) grid. Feed the result to
    TsdfPipeline.update_calibration."""
    N = calib.cv_xyz.shape[0]
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min
    center = bbox_min + 0.5 * bbox_size
    dev = calib.cv_xyz.device
    Rs = [_rodrigues(poses[i, :3]) for i in range(N)]
    ts = [poses[i, 3:] + center - _matvec3(Rs[i], center) for i in range(N)]
    cv_xyz = torch.stack([_matvec3(Rs[i], calib.cv_xyz[i]) + ts[i]
                          for i in range(N)])
    campos = torch.stack([_matvec3(Rs[i], calib.camera_positions[i]) + ts[i]
                          for i in range(N)])

    Zi, Yi, Xi = calib.cv_xyz_inv.shape[1:4]
    zi = (torch.arange(Zi, dtype=torch.float32, device=dev) + 0.5) / Zi
    yi = (torch.arange(Yi, dtype=torch.float32, device=dev) + 0.5) / Yi
    xi = (torch.arange(Xi, dtype=torch.float32, device=dev) + 0.5) / Xi
    zz, yy, xx = torch.meshgrid(zi, yi, xi, indexing="ij")
    p_world = torch.stack([xx, yy, zz], dim=-1) * bbox_size + bbox_min
    inv = []
    for i in range(N):
        q = _matvec3(Rs[i].T, p_world - ts[i])          # R^T (p - t)
        inv.append(trilinear_3d(calib.cv_xyz_inv[i],
                                (q - bbox_min) / bbox_size))
    return CalibrationSet(
        cv_xyz=cv_xyz, cv_uv=calib.cv_uv, cv_xyz_inv=torch.stack(inv),
        depth_limits=calib.depth_limits, camera_positions=campos,
        bbox_min=calib.bbox_min, bbox_max=calib.bbox_max)


def pose_residual_stats(calib, maps, volume, limit, poses=None, stride=2,
                        volumes=None, observers=None,
                        min_observers: float = 2.0) -> torch.Tensor:
    """(N,) mean |TSDF| at each sensor's observed surface points, the
    alignment metric. Saturation-aware: points outside the band count at
    the band limit, so a bad pose cannot look good by losing its points.
    ``volumes`` scores each sensor against its leave-one-out consensus;
    ``observers`` restricts the mean to multi-observer voxels."""
    N = maps.depth.shape[0]
    if poses is None:
        poses = torch.zeros((N, 6), dtype=torch.float32,
                            device=maps.depth.device)
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min
    center = bbox_min + 0.5 * bbox_size
    out = []
    for i in range(N):
        vol = volumes[i] if volumes is not None else volume
        pts, w = _surface_points(calib, maps, i, stride)
        moved = apply_pose(poses[i], pts, center)
        r = _tsdf_at(vol, bbox_min, bbox_size, moved)
        mask = w > 0
        if observers is not None:
            mask = mask & (_obs_at(observers[i], bbox_min, bbox_size, moved)
                           >= min_observers - 0.5)
        m = mask.to(torch.float32)
        denom = torch.clamp_min(m.sum(), 1.0)
        out.append((torch.clamp_max(torch.abs(r), limit) * m).sum() / denom)
    return torch.stack(out)
