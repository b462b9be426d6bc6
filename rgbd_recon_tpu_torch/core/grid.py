"""Spatial grids: world bounding box, TSDF voxel grid, brick partition.

Replicates the reference's domain decomposition (brand-new implementation):
  - the world-space reconstruction bounding box (reference: gloost BoundingBox,
    bound as UBO at framework/calibration/CalibVolumes.cpp:45-49),
  - the TSDF voxel grid derived from a metric voxel size
    (reference: ReconIntegration::setVoxelSize,
    framework/reconstruction/recon_integration.cpp:341-354), and
  - the brick partition used to gate computation to occupied space
    (reference: divideBox, recon_integration.cpp:361-407 and
    glsl/inc_bricks.glsl).

TPU-first design notes: the brick grid here is a *static dense* partition —
occupancy is a dense boolean/count array updated by scatter-add (instead of
the reference's SSBO atomics + CPU-compacted index list), and brick-gated
compute is dense masked compute.  Static shapes keep everything jittable and
make the brick grid the natural sharding unit across devices (dist/).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class BoundingBox:
    """Axis-aligned world-space box. Default matches the reference scene
    (source/kinect_client.cpp:208-209: -1.2..1.2 x 0..2.4 x -1.2..1.2 is the
    example; the shipped default .ks uses 2 x 2.2 x 2 m)."""

    min: Vec3
    max: Vec3

    @property
    def size(self) -> np.ndarray:
        return np.asarray(self.max, np.float32) - np.asarray(self.min, np.float32)

    @property
    def center(self) -> np.ndarray:
        return (np.asarray(self.max, np.float32) + np.asarray(self.min, np.float32)) * 0.5

    def contains(self, p) -> np.ndarray:
        """Vectorized point-in-box test (reference: glsl/inc_bbox_test.glsl)."""
        p = np.asarray(p)
        mn = np.asarray(self.min, p.dtype)
        mx = np.asarray(self.max, p.dtype)
        return np.all((p >= mn) & (p <= mx), axis=-1)

    def normalize(self, p) -> np.ndarray:
        """World position -> volume-normalized [0,1]^3 coordinates.

        This is the coordinate frame of cv_xyz_inv lookups and of the TSDF
        volume itself (reference: vol_to_world inverse,
        recon_integration.cpp:117-121)."""
        p = np.asarray(p)
        mn = np.asarray(self.min, p.dtype)
        return (p - mn) / self.size.astype(p.dtype)

    def denormalize(self, p) -> np.ndarray:
        p = np.asarray(p)
        mn = np.asarray(self.min, p.dtype)
        return p * self.size.astype(p.dtype) + mn


@dataclasses.dataclass(frozen=True)
class VolumeGrid:
    """TSDF voxel grid over a bounding box.

    Resolution derivation matches ReconIntegration::setVoxelSize
    (recon_integration.cpp:345-351): res = ceil(bbox_size / voxel_size) per
    axis. Voxel centers sit at (i + 0.5) / res in normalized coordinates
    (reference: volume_sampler.cpp:20 half-voxel offsets).

    Array layout convention: TSDF arrays are indexed [z, y, x] (C order,
    x fastest) so that the innermost (lane) dimension is x — matching both
    the reference's binary volume layout (calibration_volume.hpp:57-59) and
    TPU-friendly minor-most contiguity.
    """

    bbox: BoundingBox
    voxel_size: float

    @property
    def res(self) -> Tuple[int, int, int]:
        """(X, Y, Z) resolution."""
        size = self.bbox.size
        return tuple(int(np.ceil(s / self.voxel_size - 1e-4)) for s in size)

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Array shape (Z, Y, X)."""
        rx, ry, rz = self.res
        return (rz, ry, rx)

    @property
    def num_voxels(self) -> int:
        rx, ry, rz = self.res
        return rx * ry * rz

    def voxel_centers_normalized(self) -> np.ndarray:
        """(Z, Y, X, 3) array of voxel-center positions in [0,1]^3, ordered
        (x, y, z) in the last axis."""
        rx, ry, rz = self.res
        xs = (np.arange(rx, dtype=np.float32) + 0.5) / rx
        ys = (np.arange(ry, dtype=np.float32) + 0.5) / ry
        zs = (np.arange(rz, dtype=np.float32) + 0.5) / rz
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([xx, yy, zz], axis=-1)


@dataclasses.dataclass(frozen=True)
class BrickGrid:
    """Brick partition of a volume grid.

    Matches the reference's brick semantics:
      - brick grid resolution = ceil(bbox_size / brick_size)
        (divideBox, recon_integration.cpp:361-407),
      - brick id = z * ry*rx + y*rx + x (glsl/inc_bricks.glsl:26-28),
      - a brick is occupied when its counter exceeds ``min_voxels``
        (brick_occupied, inc_bricks.glsl:60-62; m_min_voxels_per_brick = 10,
        recon_integration.hpp).

    The occupancy *data* (counter array) lives outside this struct as a plain
    tensor of shape ``self.shape``.
    """

    bbox: BoundingBox
    brick_size: float
    min_voxels: int = 10

    @property
    def res(self) -> Tuple[int, int, int]:
        size = self.bbox.size
        return tuple(int(np.ceil(s / self.brick_size - 1e-4)) for s in size)

    @property
    def shape(self) -> Tuple[int, int, int]:
        rx, ry, rz = self.res
        return (rz, ry, rx)

    @property
    def num_bricks(self) -> int:
        rx, ry, rz = self.res
        return rx * ry * rz

    def brick_index_of(self, world_pos: np.ndarray) -> np.ndarray:
        """World position -> integer brick index (..., 3) as (ix, iy, iz).

        Matches mark_brick's floor((pos - bbox_min) / brick_size)
        (inc_bricks.glsl:41), clamped to the grid."""
        p = np.asarray(world_pos)
        mn = np.asarray(self.bbox.min, p.dtype)
        idx = np.floor((p - mn) / self.brick_size).astype(np.int32)
        res = np.asarray(self.res, np.int32)
        return np.clip(idx, 0, res - 1)

    def voxel_to_brick_map(self, volume: VolumeGrid) -> np.ndarray:
        """(Z, Y, X) int32 array mapping each voxel to its containing brick's
        flat id. Pure function of the two static grids — computed once."""
        centers = volume.voxel_centers_normalized()
        world = self.bbox.denormalize(centers)
        idx = self.brick_index_of(world)
        rx, ry, _ = self.res
        return (idx[..., 2] * ry * rx + idx[..., 1] * rx + idx[..., 0]).astype(np.int32)
