"""Carry state from the JAX package into the port.

Turns the JAX side's state into the port's without importing jax: every
attribute is read with ``np.asarray`` (a ``jax.Array`` converts to numpy on
its own), and the configuration crosses as JSON (the two ``config.py``
files share one schema). Counterparts:
``vision_basedsensor_tpu/core/camera.py:CameraModel``,
``vision_basedsensor_tpu/track/rings.py:ReferenceMarkers`` and
``vision_basedsensor_tpu/config.py:to_json``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from vision_basedsensor_tpu_torch.config import (PipelineConfig, _to_jsonable,
                                                 from_json)
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers


def _t(v, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(v)), dtype=dtype, device=device)


def camera_from_numpy(cam, device=None) -> CameraModel:
    """A camera with the JAX ``CameraModel``'s fields, as float32 tensors."""
    return CameraModel(*(_t(getattr(cam, f), device=device)
                         for f in CameraModel._fields))


def reference_from_numpy(ref, device=None) -> ReferenceMarkers:
    """A frame-0 reference table with the JAX ``ReferenceMarkers``' fields."""
    return ReferenceMarkers(
        xy=_t(ref.xy, device=device), axes=_t(ref.axes, device=device),
        angle=_t(ref.angle, device=device),
        ring=_t(ref.ring, torch.int32, device),
        valid=_t(ref.valid, torch.bool, device),
        axis_scale=_t(ref.axis_scale, device=device))


def config_from_jax(cfg) -> PipelineConfig:
    """The port's ``PipelineConfig`` from the JAX package's (a frozen
    dataclass tree, serialized here exactly as its ``to_json`` does)."""
    return from_json(json.dumps(_to_jsonable(cfg)))
