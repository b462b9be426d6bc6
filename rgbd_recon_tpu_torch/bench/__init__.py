"""The port's copy of the stage-timing harness (rgbd_recon_tpu/bench)."""

from .timing import StageTimer, TimerDatabase

__all__ = ["StageTimer", "TimerDatabase"]
