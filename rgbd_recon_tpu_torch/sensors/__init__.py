"""Port of rgbd_recon_tpu/sensors: frame container and synthetic rig."""
