"""Sensor-pose refinement (counterpart of rgbd_recon_tpu/refine)."""

from .pose_ba import (
    apply_pose,
    leave_one_out_volumes,
    pose_residual_stats,
    refine_poses,
)

__all__ = [
    "refine_poses",
    "apply_pose",
    "pose_residual_stats",
    "leave_one_out_volumes",
]
