"""The reference pipeline: frame-0 identities, then frames -> detections ->
frame-0 association -> depth and the last-sighting recurrence -> contact
tilt, the semantics of the port's ``initialize`` / ``process_frames``
(``apply_warmup=False``, no crop, no undistortion)."""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from vbs_bench.reference.associate import TrackedFrames, associate
from vbs_bench.reference.camera import CameraModel
from vbs_bench.reference.config import PipelineConfig
from vbs_bench.reference.detector import (Detections, detect_markers,
                                          detect_markers_and_scale)
from vbs_bench.reference.displacement import (Reconstruction,
                                              reconstruct_sequence)
from vbs_bench.reference.force import ContactState, contact_state_sequence
from vbs_bench.reference.rings import ReferenceMarkers, assign_identities


class Outputs(NamedTuple):
    detections: Detections
    tracked: TrackedFrames
    recon: Reconstruction
    contact: ContactState


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions in full float32 (``tf32=False``, what
    the configuration states) or in TF32 (the control); the previous
    settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]


def initialize(first_frame: torch.Tensor,
               cfg: PipelineConfig) -> ReferenceMarkers:
    """Frame-0 prologue: detect, assign canonical identities, measure the
    photometric axis scale."""
    det, scale = detect_markers_and_scale(first_frame, cfg.detect)
    ref = assign_identities(det, cfg.track)._replace(axis_scale=scale)
    if int(ref.valid.sum()) == 0:
        raise ValueError("reference: no markers detected in the first frame")
    return ref


def track(frames: torch.Tensor, ref: ReferenceMarkers, cfg: PipelineConfig,
          stats: list | None = None) -> tuple[Detections, TrackedFrames]:
    """Detections and frame-0 association of a batch ``(B, H, W)``."""
    det = detect_markers(frames, cfg.detect, axis_scale=ref.axis_scale,
                         stats=stats)
    return det, associate(ref, det, cfg.track.min_marker_distance_px)


def process_frames(frames: torch.Tensor, ref: ReferenceMarkers,
                   cam: CameraModel, cfg: PipelineConfig,
                   stats: list | None = None) -> Outputs:
    """The steady-state pipeline over a batch ``(B, H, W)``."""
    det, tracked = track(frames, ref, cfg, stats)
    recon = reconstruct_sequence(cam, tracked, cfg.reconstruct)
    return Outputs(det, tracked, recon,
                   contact_state_sequence(recon, cfg.analysis))
