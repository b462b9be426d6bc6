"""Port of rgbd_recon_tpu/io: the device frame feed. The stream files,
wire codecs, network sources and checkpoints are the JAX package's host
modules (rgbd_recon_tpu.io.stream / .dxt / .native / .network /
.checkpoint), which import no jax."""

from .feed import FrameFeed

__all__ = ["FrameFeed"]
