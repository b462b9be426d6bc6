"""Checkpoint / resume of reconstruction state.

The reference has no runtime checkpointing (SURVEY.md §5) — its only
persistent artifacts are baked calibration volumes, timing CSVs and debug
BMPs. This framework adds real checkpointing because it carries more state:
the fused TSDF volume, brick occupancy counters, refined sensor poses
(refine/pose_ba.py), and the frame cursor of a replay.

Format: a single .npz (portable, no extra deps) with a version tag, plus
`save_volume_binary` which writes the TSDF volume in the reference's
CalibrationVolume binary layout (header uvec3 res + fvec2 limits, then data;
framework/calibration/calibration_volume.hpp:30-39) so reference-ecosystem
tools can read it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class ReconCheckpoint:
    """Everything needed to resume a reconstruction run."""

    volume: np.ndarray                      # (Z, Y, X) float32 TSDF
    brick_counts: Optional[np.ndarray] = None   # (Bz, By, Bx) int32
    poses: Optional[np.ndarray] = None      # (N, 4, 4) refined sensor poses
    frame_index: int = 0
    timestamp: float = 0.0
    config_json: str = ""                   # PipelineConfig snapshot

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {
            "version": np.int32(FORMAT_VERSION),
            "volume": np.asarray(self.volume, np.float32),
            "frame_index": np.int64(self.frame_index),
            "timestamp": np.float64(self.timestamp),
            "config_json": np.frombuffer(
                self.config_json.encode(), dtype=np.uint8
            ),
        }
        if self.brick_counts is not None:
            arrays["brick_counts"] = np.asarray(self.brick_counts, np.int32)
        if self.poses is not None:
            arrays["poses"] = np.asarray(self.poses, np.float32)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        tmp.replace(path)  # atomic publish: no torn checkpoints on crash
        return path

    @classmethod
    def load(cls, path) -> "ReconCheckpoint":
        with np.load(Path(path), allow_pickle=False) as z:
            version = int(z["version"])
            if version > FORMAT_VERSION:
                raise ValueError(f"checkpoint version {version} > {FORMAT_VERSION}")
            return cls(
                volume=z["volume"],
                brick_counts=z["brick_counts"] if "brick_counts" in z else None,
                poses=z["poses"] if "poses" in z else None,
                frame_index=int(z["frame_index"]),
                timestamp=float(z["timestamp"]),
                config_json=bytes(z["config_json"].tobytes()).decode(),
            )


def config_to_json(config) -> str:
    """PipelineConfig -> json (dataclass snapshot for resume validation)."""
    return json.dumps(dataclasses.asdict(config), sort_keys=True)


def save_volume_binary(path, volume: np.ndarray, limits=(0.0, 1.0)) -> Path:
    """Write a TSDF volume in the reference's binary volume layout
    (calibration_volume.hpp:30-39: uint32 width,height,depth + float
    min,max + raw data, x fastest)."""
    path = Path(path)
    v = np.asarray(volume, np.float32)
    Z, Y, X = v.shape
    with open(path, "wb") as f:
        np.array([X, Y, Z], np.uint32).tofile(f)
        np.array(limits, np.float32).tofile(f)
        v.tofile(f)
    return path


class CheckpointManager:
    """Rotating checkpoint directory: keep the most recent `keep` files,
    `latest()` resolves the newest for resume."""

    def __init__(self, directory, keep: int = 3, prefix: str = "ckpt"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.prefix = prefix

    def path_for(self, frame_index: int) -> Path:
        return self.dir / f"{self.prefix}_{frame_index:08d}.npz"

    def save(self, ckpt: ReconCheckpoint) -> Path:
        p = ckpt.save(self.path_for(ckpt.frame_index))
        self._prune()
        return p

    def _prune(self):
        files = sorted(self.dir.glob(f"{self.prefix}_*.npz"))
        for old in files[: -self.keep]:
            old.unlink()

    def latest(self) -> Optional[ReconCheckpoint]:
        files = sorted(self.dir.glob(f"{self.prefix}_*.npz"))
        return ReconCheckpoint.load(files[-1]) if files else None
