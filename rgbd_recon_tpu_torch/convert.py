"""State carried across as numpy (from the JAX package, or from a
checkpoint) into the port's containers.

Each function takes a mapping from field name to array (for a dataclass
container ``c``: ``{f: np.asarray(getattr(c, f)) for f in fields}``) and
returns the port's frozen dataclass with the same fields as tensors on
``device``, the card unless the caller names another.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .calib.sensors import CalibrationSet, PixelModels, ProjectionModels
from .device import DEFAULT, resolve
from .ops.preprocess import SensorMaps
from .sensors.frames import FrameSet


def _twin(cls, arrays: Mapping[str, np.ndarray], device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    device = resolve(device)
    return cls(**{
        n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
        for n in names
    })


def field_arrays(container) -> dict:
    """{field: np.asarray(value)} of one of the port's dataclass
    containers (its tensors copied to the host)."""
    out = {}
    for f in dataclasses.fields(container):
        n = f.name
        val = getattr(container, n)
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu()
        out[n] = np.asarray(val)
    return out


def calibration_from_numpy(arrays, device=DEFAULT) -> CalibrationSet:
    return _twin(CalibrationSet, arrays, device)


def frames_from_numpy(arrays, device=DEFAULT) -> FrameSet:
    return _twin(FrameSet, arrays, device)


def pixel_models_from_numpy(arrays, device=DEFAULT) -> PixelModels:
    return _twin(PixelModels, arrays, device)


def projection_models_from_numpy(arrays, device=DEFAULT) -> ProjectionModels:
    return _twin(ProjectionModels, arrays, device)


def sensor_maps_from_numpy(arrays, device=DEFAULT) -> SensorMaps:
    return _twin(SensorMaps, arrays, device)
