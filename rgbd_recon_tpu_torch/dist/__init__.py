"""Port of rgbd_recon_tpu/dist: the z-slab sharded step, the halo exchange
and the sensor-sharded preprocess over a mesh of torch devices, driven by
one process or (the sharded steps) by several (``dist/process.py``; the
worker ``python -m rgbd_recon_tpu_torch.dist.worker``)."""

from .halo import crop_halo_z, halo_exchange_z
from .mesh import (
    Mesh,
    ShardedVolume,
    make_mesh,
    shard_compact_step,
    shard_pipeline_step,
)
from .preprocess import shard_preprocess
from .process import initialize, shutdown

__all__ = [
    "Mesh", "ShardedVolume", "make_mesh", "shard_pipeline_step",
    "shard_compact_step", "halo_exchange_z", "crop_halo_z",
    "shard_preprocess", "initialize", "shutdown",
]
