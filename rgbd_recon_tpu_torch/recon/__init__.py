"""Port of rgbd_recon_tpu/recon: the flagship TSDF pipeline."""
