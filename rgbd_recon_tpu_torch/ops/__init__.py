"""Port of rgbd_recon_tpu/ops: tensor kernels of the pipeline."""
