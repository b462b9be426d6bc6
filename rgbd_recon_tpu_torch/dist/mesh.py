"""Device-mesh distribution of the reconstruction pipeline (counterpart of
rgbd_recon_tpu/dist/mesh.py), in one process.

The JAX package runs one program over a ``Mesh`` of devices with
``shard_map``; here one process drives every shard. A :class:`Mesh` is an
ordered tuple of torch devices (a device may repeat: its shards run one
after another), each shard's work is launched on its device, and the
collectives are the explicit copies of ``collectives.py``. The sharded step
runs the brick-compact fast path of one device:

  - the per-voxel projection bake and the TSDF volume are split into brick
    z-slabs (each shard owns whole bricks; the slabs past the volume are
    padding that integrates to the clear value);
  - each shard compacts its own occupied bricks, with the full brick
    capacity, and integrates them: no communication;
  - the march-table bake runs per slab on the slab extended by the ghost
    rows the render asks for (dist.halo): ``surface_occ`` and, where the
    configuration gives it the kernel (brick_vox >= skip_fine_rounds),
    ``sentinel_bake`` on the slab grown by one brick on each side; ghosts
    beyond the global z faces hold the clear value, so every slab bakes
    exactly what the single-device bake gives its rows;
  - the brick clearance field runs on the gathered brick occupancy, and the
    oct hit table on the gathered raw volume;
  - the preprocess, the march, the refine, shading and fill run once, on
    the mesh's first device (the pipeline's), from the gathered tables.

Many-sensor rigs shard the preprocess over the sensor axis instead
(dist/preprocess.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve
from ..ops import tsdf
from .collectives import all_gather, broadcast, scatter
from .halo import halo_exchange_z


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the shards' devices in shard order, and the axis name."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "z"

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "z",
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them by
    default); raises when fewer are visible, and never falls back to the
    CPU. ``devices`` lists the shards' devices instead (a device may
    repeat, e.g. ``["cuda:0"] * 8`` on one card); ``device`` places
    ``n_devices`` shards (1 by default) on that one device, e.g.
    ``make_mesh(8, device="cpu")`` for tests on the CPU."""
    if devices is not None and device is not None:
        raise ValueError("pass devices or device, not both")
    if devices is not None:
        devs = tuple(_indexed(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices "
                             "listed")
    elif device is not None:
        devs = (_indexed(device),) * (1 if n_devices is None else n_devices)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass device='cpu' "
                               "to build a mesh of CPU shards")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(
                f"{n} CUDA devices asked for, {count} visible: pass "
                f"devices=[...] to place several shards on one device")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devs, axis_name)


def _pad_to_multiple(arr: torch.Tensor, axis: int, m: int):
    """Pad an axis with zeros to a multiple of m (shards split it evenly).
    Returns (padded, rows added)."""
    rem = (-arr.shape[axis]) % m
    if rem == 0:
        return arr, 0
    shape = list(arr.shape)
    shape[axis] = rem
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis), rem


@dataclasses.dataclass(frozen=True)
class ShardedVolume:
    """A (Z, Y, X) volume held as its z-slabs in order, each on its shard's
    device; the last slabs may hold padding rows past Z (the clear
    value)."""

    slabs: Tuple[torch.Tensor, ...]
    shape: Tuple[int, int, int]

    def gather(self) -> torch.Tensor:
        """The whole (Z, Y, X) volume on the first shard's device."""
        return all_gather(self.slabs, self.slabs[0].device)[: self.shape[0]]


def _first_device(pipeline, mesh: Mesh) -> torch.device:
    """The mesh's first device, which must hold the pipeline: the
    replicated stages run there."""
    dev0 = mesh.devices[0]
    if _indexed(pipeline.device) != dev0:
        raise ValueError(f"the mesh's first device {dev0} must be the "
                         f"pipeline's ({pipeline.device})")
    return dev0


def shard_pipeline_step(pipeline, camera, mesh: Mesh):
    """A sharded full step, frames -> (ShardedVolume, RenderOutput): the
    brick-compact step when the pipeline is compact, the dense z-sharded
    integration otherwise."""
    if pipeline.compact:
        return shard_compact_step(pipeline, camera, mesh)
    return _shard_dense_step(pipeline, camera, mesh)


def _grow_slabs(slabs, halo: int, fill: float, dev0):
    """Each slab grown by ``halo`` ghost rows on each side, ``fill`` beyond
    the global z faces: the halo exchange with the neighbours, or slices of
    the gathered volume where one hop of neighbours cannot supply them."""
    Zl = slabs[0].shape[0]
    if halo <= Zl:
        return halo_exchange_z(slabs, halo, fill=fill)
    full = all_gather(slabs, dev0)
    pad = full.new_full((halo,) + tuple(full.shape[1:]), fill)
    full = torch.cat([pad, full, pad])
    return tuple(scatter(full[s * Zl: (s + 1) * Zl + 2 * halo], s, t.device)
                 for s, t in enumerate(slabs))


def _bake_slabs(render, slabs, shape, brick_vox: int, limit: float, dev0):
    """The render's bake of the z-slabs of a volume: (march table, oct hit
    table or None, surface-brick mask, brick clearance), each on ``dev0``
    and bit-equal to the single-device bake of the whole volume. Each slab
    bakes on itself grown by the ghost rows the render asks for
    (``render.slab_halo``); the brick clearance and the oct hit table are
    built on the gathered brick mask and raw volume."""
    Z = shape[0]
    v = brick_vox
    n = len(slabs)
    Bzl = slabs[0].shape[0] // v
    Bz = -(-Z // v)
    ext = _grow_slabs(slabs, render.slab_halo, -limit, dev0)
    occ = all_gather([render.slab_occ(e) for e in ext], dev0)[:Bz]
    bsafe = render.brick_safe_field(occ)
    _, By, Bx = bsafe.shape
    # bsafe * brick_vox with one ghost brick row below the first slab and
    # above the last (the padding bricks past Bz too): zeros
    bs = bsafe * float(v)
    bs_pad = torch.cat([bs.new_zeros((1, By, Bx)), bs,
                        bs.new_zeros((n * Bzl - Bz + 1, By, Bx))])
    tables = [render.bake_slab(e, scatter(bs_pad[s * Bzl: (s + 1) * Bzl + 2],
                                          s, e.device))
              for s, e in enumerate(ext)]
    table = all_gather(tables, dev0)[:Z]
    oct = (render.build_oct(all_gather(slabs, dev0)[:Z], occ)
           if render.build_oct is not None else None)
    return table, oct, occ, bsafe


def shard_compact_step(pipeline, camera, mesh: Mesh):
    """The brick-compact sharded step (see the module docstring):
    ``step(frames) -> (ShardedVolume, RenderOutput)``. Each shard has the
    full brick capacity, so the step drops no brick that the single-device
    step keeps, and its volume, hit mask and depth are bit-equal to the
    single-device step's. ``step.diagnostics()`` reports each shard's
    occupied bricks and drops for the last frame."""
    cfg = pipeline.config
    v = pipeline.brick_vox
    devs = mesh.devices
    dev0 = _first_device(pipeline, mesh)
    Nd = mesh.size
    Z, Y, X = pipeline.volume_grid.shape
    (Bz, By, Bx), _ = tsdf.brick_layout((Z, Y, X), v)
    Bzl = -(-Bz // Nd)
    Zl = Bzl * v
    N = pipeline.calib.num_sensors

    # brick z-slabs of the projection bake; the padding bricks past Bz
    # carry valid = -1 and integrate to the clear value
    proj = pipeline.projections
    Vv = proj.shape[2]
    projz = proj.reshape(N, Bz, By * Bx, Vv, 4)
    proj_l = []
    for s, dev in enumerate(devs):
        lo, hi = min(s * Bzl, Bz), min((s + 1) * Bzl, Bz)
        part = projz[:, lo:hi]
        if hi - lo < Bzl:
            pad = proj.new_zeros((N, Bzl - (hi - lo), By * Bx, Vv, 4))
            pad[..., 3] = -1.0
            part = torch.cat([part, pad], dim=1)
        proj_l.append(scatter(part.reshape(N, Bzl * By * Bx, Vv, 4), s, dev))

    render, cam0 = pipeline.make_render_fn(camera)
    last = {}

    def step(frames):
        limit = pipeline._limit
        maps, counts = pipeline.preprocess(frames)
        counts_p = F.pad(counts, (0, 0, 0, 0, 0, Bzl * Nd - Bz))
        last["counts"] = counts_p
        depth, qual, sil = (broadcast(t, devs) for t in (
            maps.depth[..., 0], maps.quality, maps.silhouette))
        slabs = []
        for s, dev in enumerate(devs):
            ids = tsdf.occupied_brick_ids(
                scatter(counts_p[s * Bzl: (s + 1) * Bzl], s, dev),
                cfg.min_voxels_per_brick, cfg.brick_capacity)
            slab = tsdf.integrate_bricks(
                proj_l[s], ids, depth[dev], qual[dev], sil[dev], limit,
                (Zl, Y, X), v, carve_sil_threshold=cfg.carve_sil_threshold,
                phantom_hull=cfg.phantom_hull, taps=cfg.integrate_taps)
            # rows past Z (the last brick's padding) hold the clear value,
            # as outside the single-device volume
            if (s + 1) * Zl > Z:
                slab[max(Z - s * Zl, 0):] = -limit
            slabs.append(slab)
        volume = ShardedVolume(tuple(slabs), (Z, Y, X))
        pm = pipeline._get_projection_models()
        if render.bake_slab is None:
            return volume, render(volume.gather(), maps, counts, cam0,
                                  pm, limit)
        baked = _bake_slabs(render, slabs, (Z, Y, X), v, limit, dev0)
        return volume, render.render_from_baked(baked, maps, cam0, pm, limit)

    def diagnostics():
        """Per shard, for the last frame: occupied bricks, the capacity,
        the bricks dropped beyond it."""
        counts_p = last["counts"]
        out = []
        for s in range(Nd):
            n_occ = int((counts_p[s * Bzl: (s + 1) * Bzl]
                         > cfg.min_voxels_per_brick).sum())
            out.append({"occupied_bricks": n_occ,
                        "brick_capacity": cfg.brick_capacity,
                        "bricks_dropped": max(0, n_occ - cfg.brick_capacity)})
        return out

    step.diagnostics = diagnostics
    return step


def _shard_dense_step(pipeline, camera, mesh: Mesh):
    """Dense z-sharded integration (configurations that are not compact:
    fractional brick / voxel ratios, bricking off): each shard integrates
    its z-slab of the grid padded to a multiple of the shards, with voxel
    centres normalised by the true resolution (the padding rows are
    cropped), then the full render runs on the gathered volume on the
    first device. ``step(frames) -> (ShardedVolume, RenderOutput)``."""
    cfg = pipeline.config
    devs = mesh.devices
    dev0 = _first_device(pipeline, mesh)
    Nd = mesh.size
    Z, Y, X = pipeline.volume_grid.shape
    Zl = -(-Z // Nd)
    inv = broadcast(pipeline.calib.cv_xyz_inv, devs)
    proj_l = [tsdf.bake_projections(inv[dev], (Zl, Y, X), (Z, Y, X), s * Zl)
              if cfg.precompute_projections else None
              for s, dev in enumerate(devs)]
    render, cam0 = pipeline.make_render_fn(camera)

    def step(frames):
        limit = pipeline._limit
        maps, counts = pipeline.preprocess(frames)
        mask = pipeline._voxel_mask(counts)
        if mask is not None:
            mask = _pad_to_multiple(mask, 0, Nd)[0]
        depth, qual, sil = (broadcast(t, devs) for t in (
            maps.depth[..., 0], maps.quality, maps.silhouette))
        slabs = []
        for s, dev in enumerate(devs):
            slabs.append(tsdf.integrate(
                (Zl, Y, X), inv[dev], depth[dev], qual[dev], sil[dev], limit,
                voxel_mask=(None if mask is None else
                            scatter(mask[s * Zl: (s + 1) * Zl], s, dev)),
                projections=proj_l[s],
                carve_sil_threshold=cfg.carve_sil_threshold,
                phantom_hull=cfg.phantom_hull, true_shape=(Z, Y, X),
                z0=s * Zl))
        volume = ShardedVolume(tuple(slabs), (Z, Y, X))
        out = render(volume.gather(), maps, counts, cam0,
                     pipeline._get_projection_models(), limit)
        return volume, out

    return step
