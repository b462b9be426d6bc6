"""Sensor-axis sharding of the preprocess chain (counterpart of
rgbd_recon_tpu/dist/preprocess.py).

Every preprocess pass (morph, bilateral, boundary, normals, quality) is
per sensor, so a rig with many sensors shards the chain over the SENSOR
axis: each shard runs the whole chain (the two 13x13 stencil kernels on the
card) and the brick marking of TsdfPipeline on its own sensors, then

  - the brick counts of the shards are added (psum): the distributed form
    of the reference's atomicAdd counters (glsl/inc_bricks.glsl:40-58);
  - the sensor maps are gathered in sensor order onto the first device,
    where the integration and the colour blend read every sensor's map.
"""

from __future__ import annotations

import dataclasses

from ..ops.preprocess import SensorMaps
from .collectives import all_gather, psum, scatter
from .mesh import Mesh, _first_device, _no_spanning


def _sensors(container, sl, shard, device, shared=()):
    """The sensors ``sl`` of a container of per-sensor tensors for shard
    ``shard`` on ``device``; the fields ``shared`` (no sensor axis) are
    handed whole."""
    return dataclasses.replace(container, **{
        f.name: scatter(getattr(container, f.name) if f.name in shared
                        else getattr(container, f.name)[sl], shard, device)
        for f in dataclasses.fields(container)})


def shard_preprocess(pipeline, mesh: Mesh):
    """A sensor-sharded preprocess, ``frames -> (SensorMaps, brick
    counts)``, equal to ``pipeline.preprocess`` (the same chain on sensor
    slices; the gather keeps the sensor order, the counts are integers).
    Requires num_sensors % mesh size == 0, and a mesh of one process."""
    _no_spanning(mesh, "shard_preprocess")
    calib = pipeline.calib
    N = calib.num_sensors
    Nd = mesh.size
    if N % Nd != 0:
        raise ValueError(f"the sensor axis ({N}) must divide over the mesh "
                         f"({Nd}): pad the rig or use pipeline.preprocess")
    dev0 = _first_device(pipeline, mesh)
    Ns = N // Nd
    slices = [slice(s * Ns, (s + 1) * Ns) for s in range(Nd)]
    calibs = [_sensors(calib, sl, s, dev, ("bbox_min", "bbox_max"))
              for s, (sl, dev) in enumerate(zip(slices, mesh.devices))]
    models = {}

    def run(frames):
        hw = tuple(frames.depths.shape[1:3])
        if hw not in models:
            pm = pipeline._get_pixel_models(hw)
            models[hw] = [None if pm is None else _sensors(pm, sl, s, dev)
                          for s, (sl, dev) in enumerate(zip(slices,
                                                            mesh.devices))]
        parts = []
        for s, (sl, dev) in enumerate(zip(slices, mesh.devices)):
            local = _sensors(frames, sl, s, dev, ("timestamp",))
            parts.append(pipeline._preprocess_impl(calibs[s], models[hw][s],
                                                   local))
        counts = psum([c for _, c in parts], dev0)
        maps = SensorMaps(**{
            f.name: all_gather([getattr(m, f.name) for m, _ in parts], dev0)
            for f in dataclasses.fields(SensorMaps)})
        return maps, counts

    return run
