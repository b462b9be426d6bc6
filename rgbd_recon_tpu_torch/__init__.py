"""rgbd_recon_tpu_torch — the PyTorch / CUDA port of rgbd_recon_tpu.

Mirrors the JAX package's layout module for module; the JAX package stays
the reference the port is tested against. The port imports torch and never
jax. Kernels written by hand for Hopper live in ``csrc/`` (CUDA C++), their
launch wrappers in ``kernels/``; ``core/`` (grids, config, cameras) is
imported from rgbd_recon_tpu, which needs no jax.

Layout:
  calib/    numpy calibration bake, frustum, .yml parser, volume files and
            k-NN inverter; torch calibration containers
  sensors/  frame container, numpy synthetic rig and renderer
  ops/      preprocess, bricks, integration, bake, raymarch, hole fill,
            splat
  recon/    TsdfPipeline (fuse + staged render) and the points, trigrid,
            MVT and calib-vis renderers
  viz/      PNG output, colorizations, stereo composition
  io/       frame feed onto the device
  app       the command line (python -m rgbd_recon_tpu_torch.app)
  kernels/  nvcc build + ctypes launch wrappers with launch counters
  csrc/     CUDA C++ sources (sm_90a)
  convert   JAX-package state (as numpy) -> torch twins on a device
"""

__version__ = "0.1.0"
