"""Session checkpoint/resume.

Port of ``vision_basedsensor_tpu/io/session.py`` with the same on-disk
format (a directory holding ``state.npz`` + ``config.json``), so a session
saved by either package resumes in the other: the frame-0 reference table
(with the photometric axis scale), the pipeline config, the
displacement-scan carry, the sequential-association last-seen positions and
the global frame count, and the calibration artifact
(``calibration.json``, ``calibrate/artifact.py``) when the session has one.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact
from vision_basedsensor_tpu_torch.config import (PipelineConfig, from_json,
                                                 to_json)
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers


class SessionState(NamedTuple):
    ref: ReferenceMarkers
    config: PipelineConfig
    calibration: CalibrationArtifact | None
    scan_carry: dict                # displacement-scan carry ({} if fresh)
    assoc_xy: torch.Tensor | None   # sequential-mode last-seen (65, 2)
    frames_seen: int = 0            # global frame count (warm-up offset)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_session(path: str, ref: ReferenceMarkers, config: PipelineConfig,
                 calibration=None, scan_carry: dict | None = None,
                 assoc_xy=None, frames_seen: int = 0) -> None:
    """Write a session checkpoint (directory with npz + json)."""
    os.makedirs(path, exist_ok=True)
    arrays = {
        "ref_xy": _np(ref.xy),
        "ref_axes": _np(ref.axes),
        "ref_angle": _np(ref.angle),
        "ref_ring": _np(ref.ring),
        "ref_valid": _np(ref.valid),
        "ref_axis_scale": _np(ref.axis_scale),
        "frames_seen": np.asarray(frames_seen, np.int64),
    }
    for k, v in (scan_carry or {}).items():
        arrays[f"carry_{k}"] = _np(v)
    if assoc_xy is not None:
        arrays["assoc_xy"] = _np(assoc_xy)
    np.savez(os.path.join(path, "state.npz"), **arrays)
    to_json(config, os.path.join(path, "config.json"))
    if calibration is not None:
        calibration.save_json(os.path.join(path, "calibration.json"))


def load_session(path: str, device=CUDA) -> SessionState:
    """Read a session checkpoint onto ``device`` (the card by default)."""
    device = resolve(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    with np.load(os.path.join(path, "state.npz")) as z:
        ref = ReferenceMarkers(
            xy=t(z["ref_xy"]), axes=t(z["ref_axes"]),
            angle=t(z["ref_angle"]), ring=t(z["ref_ring"], torch.int32),
            valid=t(z["ref_valid"], torch.bool),
            axis_scale=(t(z["ref_axis_scale"])
                        if "ref_axis_scale" in z.files else 1.0))
        carry = {k[len("carry_"):]: t(z[k], torch.bool if z[k].dtype == bool
                                       else torch.float32)
                 for k in z.files if k.startswith("carry_")}
        assoc_xy = t(z["assoc_xy"]) if "assoc_xy" in z.files else None
        fseen = int(z["frames_seen"]) if "frames_seen" in z.files else 0
    config = from_json(os.path.join(path, "config.json"))
    calib = None
    cpath = os.path.join(path, "calibration.json")
    if os.path.exists(cpath):
        calib = CalibrationArtifact.load_json(cpath)
    return SessionState(ref=ref, config=config, calibration=calib,
                        scan_carry=carry, assoc_xy=assoc_xy,
                        frames_seen=fseen)
