"""Scattered-data interpolation: the calibration-volume builder role (a
numpy copy of rgbd_recon_tpu/calib/scattered.py, whose package's __init__
imports jax).

The reference bundles a CGAL natural-neighbour interpolator
(framework/NaturalNeighbourInterpolator.{h,cpp}: 3D Delaunay + Sibson
coordinates over scattered (position -> position_offset, texture_offset)
calibration measurements). It is the upstream tool that generated the baked
cv_xyz / cv_uv volumes: it turns a sparse set of measured calibration
correspondences into dense lookup volumes.

  - `idw_interpolate`: k-NN inverse-distance weighting (Shepard), the
    combine rule of the reference's inverter (calibration_inverter.cpp:
    55-69);
  - `mls_interpolate`: moving least squares with a linear basis; like
    Sibson natural-neighbour interpolation it reproduces linear fields
    exactly, without a Delaunay triangulation;
  - `build_lookup_volume`: scattered measurements densified into a
    (D, H, W, C) volume (NaturalNeighbourInterpolator.cpp:34-92), a host
    precompute.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _knn(samples_pos: np.ndarray, queries: np.ndarray, k: int):
    """k nearest neighbors: scipy kd-tree when available (the CGAL role),
    brute force otherwise. Returns (dists (Q, k), idx (Q, k))."""
    try:
        from scipy.spatial import cKDTree

        tree = cKDTree(samples_pos)
        d, i = tree.query(queries, k=k)
        if k == 1:
            d, i = d[:, None], i[:, None]
        return d, i
    except ImportError:
        diff = queries[:, None, :] - samples_pos[None, :, :]
        d2 = np.einsum("qsc,qsc->qs", diff, diff)
        idx = np.argpartition(d2, min(k, d2.shape[1] - 1), axis=1)[:, :k]
        d = np.sqrt(np.take_along_axis(d2, idx, axis=1))
        return d, idx


def idw_interpolate(
    samples_pos: np.ndarray,   # (S, 3)
    samples_val: np.ndarray,   # (S, C)
    queries: np.ndarray,       # (Q, 3)
    k: int = 8,
    eps: float = 1e-12,
) -> np.ndarray:
    """Shepard inverse-distance weighting over the k nearest samples
    (the inverseDistance combine, calibration_inverter.cpp:55-69)."""
    d, idx = _knn(samples_pos, queries, k)
    w = 1.0 / np.maximum(d, eps)
    w /= w.sum(axis=1, keepdims=True)
    vals = samples_val[idx]  # (Q, k, C)
    return np.einsum("qk,qkc->qc", w, vals).astype(np.float32)


def mls_interpolate(
    samples_pos: np.ndarray,
    samples_val: np.ndarray,
    queries: np.ndarray,
    k: int = 16,
    eps: float = 1e-12,
) -> np.ndarray:
    """Moving least squares with linear basis [1, x, y, z] and inverse-
    distance weights: reproduces linear fields exactly (natural-neighbour's
    key property for calibration offset fields). Falls back to IDW where the
    local system is singular (coplanar/degenerate neighborhoods)."""
    Q = queries.shape[0]
    C = samples_val.shape[1]
    d, idx = _knn(samples_pos, queries, min(k, len(samples_pos)))
    kk = idx.shape[1]
    w = 1.0 / np.maximum(d * d, eps)  # (Q, k)

    nbr_pos = samples_pos[idx]                     # (Q, k, 3)
    nbr_val = samples_val[idx]                     # (Q, k, C)
    # local coordinates for conditioning
    local = nbr_pos - queries[:, None, :]
    basis = np.concatenate([np.ones((Q, kk, 1)), local], axis=2)  # (Q, k, 4)

    # weighted normal equations per query: (B^T W B) a = B^T W v
    bw = basis * w[..., None]
    ata = np.einsum("qki,qkj->qij", bw, basis)     # (Q, 4, 4)
    atv = np.einsum("qki,qkc->qic", bw, nbr_val)   # (Q, 4, C)
    ata += np.eye(4)[None] * 1e-9                  # Tikhonov for stability

    out = np.empty((Q, C), np.float32)
    try:
        sol = np.linalg.solve(ata, atv)            # (Q, 4, C)
        out[:] = sol[:, 0, :]                      # value at local origin
        bad = ~np.isfinite(out).all(axis=1)
    except np.linalg.LinAlgError:
        bad = np.ones(Q, bool)
    if bad.any():
        out[bad] = idw_interpolate(
            samples_pos, samples_val, queries[bad], k=min(8, kk)
        )
    return out


def build_lookup_volume(
    samples_pos: np.ndarray,    # (S, 3) measured positions (sensor space)
    samples_val: np.ndarray,    # (S, C) measured values (e.g. offsets)
    res: Tuple[int, int, int],  # (W, H, D) volume resolution
    space_min: np.ndarray,
    space_max: np.ndarray,
    method: str = "mls",
    k: int = 16,
) -> np.ndarray:
    """Densify scattered measurements into a (D, H, W, C) lookup volume over
    the axis-aligned box [space_min, space_max] with texel centers at
    (i + 0.5) / res — the NaturalNeighbourInterpolator::interpolate loop."""
    W, H, D = res
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W
    ys = (np.arange(H, dtype=np.float32) + 0.5) / H
    zs = (np.arange(D, dtype=np.float32) + 0.5) / D
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    q = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    q = q * (np.asarray(space_max) - np.asarray(space_min)) + np.asarray(space_min)

    fn = mls_interpolate if method == "mls" else idw_interpolate
    vals = fn(
        np.asarray(samples_pos, np.float64),
        np.asarray(samples_val, np.float64),
        q.astype(np.float64),
        k=k,
    )
    return vals.reshape(D, H, W, -1).astype(np.float32)
