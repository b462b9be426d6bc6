"""Port of rgbd_recon_tpu/calib: numpy bake + frustum, torch containers."""
