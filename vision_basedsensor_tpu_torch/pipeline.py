"""End-to-end sensor pipeline: frames -> markers -> 3D field -> contact state.

Port of ``vision_basedsensor_tpu/pipeline.py`` (``initialize``,
``process_frames``, ``run_video``) for the default configuration:

    crop -> detect -> associate (frame 0) -> reconstruct
         -> displacement scan -> per-frame contact-plane tilt

with the one-frame identity-assignment prologue. Options that would reach
code the port does not have raise ``NotImplementedError`` naming the
option: ``association_mode="sequential"``, ``undistort_frames=True`` (and a
``rectify_map``), ``DetectConfig.fast_filters=True``, and the
``StreamingPipeline`` class.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.analysis.force import (ContactState,
                                                         contact_state_sequence)
from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.imaging import crop_frames
from vision_basedsensor_tpu_torch.detect.detector import (Detections,
                                                          detect_markers,
                                                          detect_markers_and_scale)
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    Reconstruction, reconstruct_sequence)
from vision_basedsensor_tpu_torch.track.associate import TrackedFrames, associate
from vision_basedsensor_tpu_torch.track.rings import (ReferenceMarkers,
                                                      assign_identities)


class PipelineOutputs(NamedTuple):
    detections: Detections
    tracked: TrackedFrames
    recon: Reconstruction
    contact: ContactState | None = None


def _check_supported(cfg: PipelineConfig, rectify_map=None) -> None:
    if cfg.undistort_frames or rectify_map is not None:
        raise NotImplementedError(
            "undistort_frames=True (rectify map + remap preprocess) is not "
            "ported to vision_basedsensor_tpu_torch")
    if cfg.track.association_mode != "frame0":
        raise NotImplementedError(
            f"association_mode={cfg.track.association_mode!r} is not ported "
            "to vision_basedsensor_tpu_torch; use 'frame0'")


def _preprocess(frames: torch.Tensor, cfg: PipelineConfig,
                crop: bool) -> torch.Tensor:
    return crop_frames(frames, crop_ratios=cfg.crop_ratios) if crop else frames


def initialize(first_frame: torch.Tensor, cfg: PipelineConfig,
               crop: bool = False, rectify_map=None) -> ReferenceMarkers:
    """Frame-0 prologue: detect markers, assign canonical identities, and
    measure the session's photometric axis-calibration scalar. Raises when
    the frame holds no marker."""
    _check_supported(cfg, rectify_map)
    frame = _preprocess(first_frame, cfg, crop)
    det, scale = detect_markers_and_scale(frame, cfg.detect)
    ref = assign_identities(det, cfg.track)._replace(axis_scale=scale)
    if int(ref.valid.sum()) == 0:
        raise ValueError("no markers detected in the first frame — check "
                         "the camera/lens, channel_order, and crop settings")
    return ref


def process_frames(frames: torch.Tensor, ref: ReferenceMarkers,
                   cam: CameraModel, cfg: PipelineConfig, crop: bool = False,
                   apply_warmup: bool = False,
                   rectify_map=None) -> PipelineOutputs:
    """Steady-state pipeline over a frame batch ``(B, H, W[, 3])``; the
    camera tensors must lie on the frames' device."""
    _check_supported(cfg, rectify_map)
    frames = _preprocess(frames, cfg, crop)
    det = detect_markers(frames, cfg.detect, axis_scale=ref.axis_scale)
    tracked = associate(ref, det, cfg.track.min_marker_distance_px)
    recon = reconstruct_sequence(cam, tracked, cfg.reconstruct,
                                 apply_warmup=apply_warmup)
    contact = contact_state_sequence(recon, cfg.analysis)
    return PipelineOutputs(detections=det, tracked=tracked, recon=recon,
                           contact=contact)


def run_video(frames: torch.Tensor, cam: CameraModel, cfg: PipelineConfig,
              crop: bool = False, apply_warmup: bool = True) -> PipelineOutputs:
    """Initialize on frame 0, then process the batch."""
    _check_supported(cfg)
    ref = initialize(frames[0], cfg, crop)
    return process_frames(frames, ref, cam, cfg, crop, apply_warmup)


class StreamingPipeline:
    """The reference's chunked, resumable pipeline
    (``vision_basedsensor_tpu/pipeline.py:157``) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StreamingPipeline is not ported to vision_basedsensor_tpu_torch; "
            "use process_frames on batches")
