"""The reference pipeline with detection on the branch the frames take
(``unfused.py``): the semantics of ``pipeline.py`` (the port's
``initialize`` / ``process_frames`` with ``apply_warmup=False``, no crop, no
undistortion), whose detector holds the fused branch only. Frames that take
the fused branch give what ``pipeline.py`` gives."""
from __future__ import annotations

import torch

from vbs_bench.reference.associate import TrackedFrames, associate
from vbs_bench.reference.camera import CameraModel
from vbs_bench.reference.config import PipelineConfig
from vbs_bench.reference.detector import Detections
from vbs_bench.reference.displacement import reconstruct_sequence
from vbs_bench.reference.force import contact_state_sequence
from vbs_bench.reference.pipeline import Outputs, precision  # noqa: F401
from vbs_bench.reference.rings import ReferenceMarkers, assign_identities
from vbs_bench.reference.unfused import (detect_markers,
                                         detect_markers_and_scale)


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
    """The steady-state pipeline over a batch ``(B, H, W)``; with ``stats``,
    the detector's window statistics are appended to it."""
    det, tracked = track(frames, ref, cfg, stats)
    recon = reconstruct_sequence(cam, tracked, cfg.reconstruct)
    return Outputs(det, tracked, recon,
                   contact_state_sequence(recon, cfg.analysis))
