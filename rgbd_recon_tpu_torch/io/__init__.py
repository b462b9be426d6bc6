"""Port of rgbd_recon_tpu/io: .stream files and wire codecs, the native
replay pump, network sources, checkpoints and the device frame feed."""

from .stream import StreamReader, StreamWriter, frame_wire_size
from .feed import FrameFeed
from .network import ZmqFrameSource, FeedbackReceiver, FeedbackState
from .checkpoint import (
    CheckpointManager,
    ReconCheckpoint,
    config_to_json,
    save_volume_binary,
)
from . import dxt

__all__ = [
    "StreamReader",
    "StreamWriter",
    "frame_wire_size",
    "FrameFeed",
    "ZmqFrameSource",
    "FeedbackReceiver",
    "FeedbackState",
    "CheckpointManager",
    "ReconCheckpoint",
    "config_to_json",
    "save_volume_binary",
    "dxt",
]
