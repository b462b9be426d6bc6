"""Device-mesh distribution of the reconstruction pipeline (counterpart of
rgbd_recon_tpu/dist/mesh.py).

The JAX package runs one program over a ``Mesh`` of devices with
``shard_map``. Here a :class:`Mesh` is an ordered tuple of torch devices (a
device may repeat: its shards run one after another), each shard's work is
launched on its device, and the collectives are the explicit copies of
``collectives.py``. One process drives every shard, or (``dist/process.py``,
``make_mesh(devices_per_process=...)``) the mesh spans several processes:
each runs the same step, launches only its own shards and computes the
replicated stages itself, as each JAX process does under
``jax.distributed``. The sharded step runs the brick-compact fast path of
one device:

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
    """A 1-D mesh: the shards' devices in shard order, and the axis name.
    A mesh over several processes also records each shard's process (a
    process holds a run of shards, in rank order) and this process's rank;
    each shard's device is named as its own process names it."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "z"
    processes: Tuple[int, ...] = ()
    process: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return len(set(self.processes)) > 1

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards of this process, in order."""
        if not self.multiprocess:
            return tuple(range(self.size))
        return tuple(s for s, p in enumerate(self.processes)
                     if p == self.process)


def local_shards(mesh: Mesh):
    """(shard, its position among this process's shards, its device) for
    each shard of this process."""
    return [(s, j, mesh.devices[s]) for j, s in enumerate(mesh.local)]


def _no_spanning(mesh: Mesh, what: str) -> None:
    if mesh.multiprocess:
        raise NotImplementedError(
            f"{what} runs over a mesh of one process; over several it waits "
            "on ROADMAP.md §1, 'The multi-process forms of shard_preprocess "
            "and refine_poses'")


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "z",
              devices: Optional[Sequence] = None, device=None,
              devices_per_process: Optional[int] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them by
    default); raises when fewer are visible, and never falls back to the
    CPU. ``devices`` lists the shards' devices instead (a device may
    repeat, e.g. ``["cuda:0"] * 8`` on one card); ``device`` places
    ``n_devices`` shards (1 by default) on that one device, e.g.
    ``make_mesh(8, device="cpu")`` for tests on the CPU.

    ``devices_per_process`` builds the mesh over every process of the
    group that ``dist.initialize`` joined (every process calls it): each
    process gives ``devices_per_process`` shards, on ``device`` or on the
    listed ``devices`` (one of the two is required); the shards follow in
    rank order, and ``n_devices``, when given, must be their total. Raises
    under NCCL when two processes would share a card."""
    if devices is not None and device is not None:
        raise ValueError("pass devices or device, not both")
    if devices_per_process is not None:
        return _process_mesh(n_devices, axis_name, devices, device,
                             devices_per_process)
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


def _process_mesh(n_devices, axis_name, devices, device, k: int) -> Mesh:
    """The mesh over every process of the group, ``k`` shards each."""
    import torch.distributed as tdist

    from . import process

    if devices is None and device is None:
        raise ValueError("devices_per_process needs device= or devices=: "
                         "the shards of this process")
    if not process.initialized():
        raise RuntimeError("devices_per_process needs the process group: "
                           "call dist.initialize first")
    rank, world = tdist.get_rank(), tdist.get_world_size()
    if k < 1:
        raise ValueError(f"devices_per_process must be >= 1, got {k}")
    if n_devices is not None and n_devices != k * world:
        raise ValueError(f"n_devices={n_devices} but {world} processes of "
                         f"{k} shards")
    local = make_mesh(k, axis_name, devices, device).devices
    backend = tdist.get_backend()
    # each process's shards: (device key, device name as it names it)
    shards = process.all_objects([(process.device_key(d), str(d))
                                  for d in local])
    process.check_backend(backend, [[key for key, _ in per]
                                    for per in shards])
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    return Mesh(tuple(torch.device(name) for per in shards
                      for _, name in per), axis_name,
                tuple(p for p, per in enumerate(shards) for _ in per), rank)


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
    mesh: Optional[Mesh] = None

    def gather(self) -> torch.Tensor:
        """The whole (Z, Y, X) volume on the first shard's device. Over a
        mesh of several processes the slabs are this process's own, and
        every process calls this to get the whole on its first shard's
        device."""
        return all_gather(self.slabs, self.slabs[0].device,
                          mesh=self.mesh)[: self.shape[0]]


def _first_device(pipeline, mesh: Mesh) -> torch.device:
    """The device of this process's first shard (the mesh's first device in
    one process), which must hold the pipeline: the replicated stages run
    there."""
    dev0 = mesh.devices[mesh.local[0]]
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


def _grow_slabs(slabs, halo: int, fill: float, dev0, mesh: Mesh):
    """Each slab grown by ``halo`` ghost rows on each side, ``fill`` beyond
    the global z faces: the halo exchange with the neighbours, or slices of
    the gathered volume where one hop of neighbours cannot supply them."""
    Zl = slabs[0].shape[0]
    if halo <= Zl:
        return halo_exchange_z(slabs, halo, fill=fill, mesh=mesh)
    full = all_gather(slabs, dev0, mesh=mesh)
    pad = full.new_full((halo,) + tuple(full.shape[1:]), fill)
    full = torch.cat([pad, full, pad])
    return tuple(scatter(full[s * Zl: (s + 1) * Zl + 2 * halo], j, dev)
                 for s, j, dev in local_shards(mesh))


def _bake_slabs(render, slabs, shape, brick_vox: int, limit: float, dev0,
                mesh=None):
    """The render's bake of the z-slabs of a volume: (march table, oct hit
    table or None, surface-brick mask, brick clearance), each on ``dev0``
    and bit-equal to the single-device bake of the whole volume. Each slab
    bakes on itself grown by the ghost rows the render asks for
    (``render.slab_halo``); the brick clearance and the oct hit table are
    built on the gathered brick mask and raw volume. Over a mesh of several
    processes ``slabs`` are this process's own; without a mesh, each slab
    is a shard on its own tensor's device."""
    if mesh is None:
        mesh = Mesh(tuple(t.device for t in slabs))
    Z = shape[0]
    v = brick_vox
    n = mesh.size
    Bzl = slabs[0].shape[0] // v
    Bz = -(-Z // v)
    ext = _grow_slabs(slabs, render.slab_halo, -limit, dev0, mesh)
    occ = all_gather([render.slab_occ(e) for e in ext], dev0,
                     mesh=mesh)[:Bz]
    bsafe = render.brick_safe_field(occ)
    _, By, Bx = bsafe.shape
    # bsafe * brick_vox with one ghost brick row below the first slab and
    # above the last (the padding bricks past Bz too): zeros
    bs = bsafe * float(v)
    bs_pad = torch.cat([bs.new_zeros((1, By, Bx)), bs,
                        bs.new_zeros((n * Bzl - Bz + 1, By, Bx))])
    tables = [render.bake_slab(e, scatter(bs_pad[s * Bzl: (s + 1) * Bzl + 2],
                                          j, e.device))
              for (s, j, _), e in zip(local_shards(mesh), ext)]
    table = all_gather(tables, dev0, mesh=mesh)[:Z]
    oct = (render.build_oct(all_gather(slabs, dev0, mesh=mesh)[:Z], occ)
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
    shards = local_shards(mesh)
    devs = [dev for _, _, dev in shards]
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
    for s, j, dev in shards:
        lo, hi = min(s * Bzl, Bz), min((s + 1) * Bzl, Bz)
        part = projz[:, lo:hi]
        if hi - lo < Bzl:
            pad = proj.new_zeros((N, Bzl - (hi - lo), By * Bx, Vv, 4))
            pad[..., 3] = -1.0
            part = torch.cat([part, pad], dim=1)
        proj_l.append(scatter(part.reshape(N, Bzl * By * Bx, Vv, 4), j, dev))

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
        for s, j, dev in shards:
            slab = tsdf.integrate_compact(
                proj_l[j], scatter(counts_p[s * Bzl: (s + 1) * Bzl], j, dev),
                cfg.min_voxels_per_brick, cfg.brick_capacity, depth[dev],
                qual[dev], sil[dev], limit, (Zl, Y, X), v,
                carve_sil_threshold=cfg.carve_sil_threshold,
                phantom_hull=cfg.phantom_hull, taps=cfg.integrate_taps)
            # rows past Z (the last brick's padding) hold the clear value,
            # as outside the single-device volume
            if (s + 1) * Zl > Z:
                slab[max(Z - s * Zl, 0):] = -limit
            slabs.append(slab)
        volume = ShardedVolume(tuple(slabs), (Z, Y, X), mesh)
        pm = pipeline._get_projection_models()
        if render.bake_slab is None:
            return volume, render(volume.gather(), maps, counts, cam0,
                                  pm, limit)
        baked = _bake_slabs(render, slabs, (Z, Y, X), v, limit, dev0, mesh)
        return volume, render.render_from_baked(baked, maps, cam0, pm, limit)

    def diagnostics():
        """Per shard (every shard of the mesh: the counts are replicated),
        for the last frame: occupied bricks, the capacity, the bricks
        dropped beyond it."""
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
    shards = local_shards(mesh)
    devs = [dev for _, _, dev in shards]
    dev0 = _first_device(pipeline, mesh)
    Nd = mesh.size
    Z, Y, X = pipeline.volume_grid.shape
    Zl = -(-Z // Nd)
    inv = broadcast(pipeline.calib.cv_xyz_inv, devs)
    proj_l = [tsdf.bake_projections(inv[dev], (Zl, Y, X), (Z, Y, X), s * Zl)
              if cfg.precompute_projections else None
              for s, _, dev in shards]
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
        for s, j, dev in shards:
            slabs.append(tsdf.integrate(
                (Zl, Y, X), inv[dev], depth[dev], qual[dev], sil[dev], limit,
                voxel_mask=(None if mask is None else
                            scatter(mask[s * Zl: (s + 1) * Zl], j, dev)),
                projections=proj_l[j],
                carve_sil_threshold=cfg.carve_sil_threshold,
                phantom_hull=cfg.phantom_hull, true_shape=(Z, Y, X),
                z0=s * Zl))
        volume = ShardedVolume(tuple(slabs), (Z, Y, X), mesh)
        out = render(volume.gather(), maps, counts, cam0,
                     pipeline._get_projection_models(), limit)
        return volume, out

    return step
