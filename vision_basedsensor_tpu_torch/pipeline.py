"""End-to-end sensor pipeline: frames -> markers -> 3D field -> contact state.

Port of ``vision_basedsensor_tpu/pipeline.py``:

    crop -> [undistort] -> detect -> associate -> reconstruct
         -> displacement scan -> per-frame contact-plane tilt

with the one-frame identity-assignment prologue (``initialize``), the batch
entry points ``process_frames`` / ``run_video`` and the chunked, resumable
``StreamingPipeline`` (``run`` over a ``VideoSource`` through
``io/video.py:device_feed``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.analysis.force import (ContactState,
                                                         contact_state_sequence)
from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.core.imaging import crop_frames, to_grayscale
from vision_basedsensor_tpu_torch.core.undistort import (build_rectify_map,
                                                         optimal_new_camera,
                                                         remap_bilinear)
from vision_basedsensor_tpu_torch.detect.detector import (Detections,
                                                          detect_markers,
                                                          detect_markers_and_scale)
from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    Reconstruction, displacement_scan, initial_carry, reconstruct_sequence,
    warmup_mask)
from vision_basedsensor_tpu_torch.track.associate import (TrackedFrames,
                                                          associate,
                                                          associate_sequential)
from vision_basedsensor_tpu_torch.track.rings import (ReferenceMarkers,
                                                      assign_identities)
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


class PipelineOutputs(NamedTuple):
    detections: Detections
    tracked: TrackedFrames
    recon: Reconstruction
    contact: ContactState | None = None


def prepare_undistortion(cam: CameraModel, height: int, width: int,
                         cfg: PipelineConfig, crop: bool = False):
    """Rectify map + matching pinhole camera for the undistort preprocess
    (``marker_detection.py:88-109``). ``height``/``width`` are the raw frame
    dims; the map is built for the post-crop size. Detection then sees
    rectified pixels, so reconstruction uses the returned zero-distortion
    camera, which keeps the original extrinsics. Returns
    ``(src_map, new_cam)``."""
    with trace_annotation("vbs.undistort.prepare"):
        if crop:
            l, r, t, b = cfg.crop_ratios
            width = (width - int(width * r)) - int(width * l)
            height = (height - int(height * b)) - int(height * t)
        new_cam = optimal_new_camera(cam, height, width, alpha=0.0)
        src_map = build_rectify_map(cam, height, width, new_cam)
        return src_map, new_cam._replace(R_wc=cam.R_wc, T_wc=cam.T_wc)


def _preprocess(frames: torch.Tensor, cfg: PipelineConfig, crop: bool,
                rectify_map: torch.Tensor | None) -> torch.Tensor:
    """Crop, then (with a rectify map) grayscale and remap: the reference's
    order (``marker_detection.py:78-91``)."""
    with trace_annotation("vbs.pipeline.preprocess"):
        if crop:
            frames = crop_frames(frames, crop_ratios=cfg.crop_ratios)
        if rectify_map is not None:
            with trace_annotation("vbs.undistort.remap"):
                frames = remap_bilinear(
                    to_grayscale(frames, cfg.detect.channel_order),
                    rectify_map)
        return frames


def _associate(ref: ReferenceMarkers, det: Detections, cfg: PipelineConfig,
               carry_xy: torch.Tensor | None = None):
    """Association by ``cfg.track.association_mode``; returns the tracked
    frames and the last-seen positions (unchanged in frame-0 mode)."""
    with trace_annotation("vbs.track.associate"):
        gate = cfg.track.min_marker_distance_px
        if cfg.track.association_mode == "sequential":
            return associate_sequential(ref, det, gate, carry_xy=carry_xy,
                                        return_carry=True)
        return associate(ref, det, gate), carry_xy


def initialize(first_frame: torch.Tensor, cfg: PipelineConfig,
               crop: bool = False,
               rectify_map: torch.Tensor | None = None) -> ReferenceMarkers:
    """Frame-0 prologue: detect markers, assign canonical identities, and
    measure the session's photometric axis-calibration scalar. Raises when
    the frame holds no marker."""
    with trace_annotation("vbs.pipeline.initialize"):
        frame = _preprocess(first_frame, cfg, crop, rectify_map)
        det, scale = detect_markers_and_scale(frame, cfg.detect)
        ref = assign_identities(det, cfg.track)._replace(axis_scale=scale)
        if int(ref.valid.sum()) == 0:
            raise ValueError("no markers detected in the first frame — "
                             "check the camera/lens, channel_order, and "
                             "crop settings")
        return ref


def process_frames(frames: torch.Tensor, ref: ReferenceMarkers,
                   cam: CameraModel, cfg: PipelineConfig, crop: bool = False,
                   apply_warmup: bool = False,
                   rectify_map: torch.Tensor | None = None) -> PipelineOutputs:
    """Steady-state pipeline over a frame batch ``(B, H, W[, 3])``; the
    camera tensors must lie on the frames' device. With ``rectify_map``,
    ``cam`` is the rectified camera of :func:`prepare_undistortion`."""
    with trace_annotation("vbs.pipeline.process_frames"):
        frames = _preprocess(frames, cfg, crop, rectify_map)
        det = detect_markers(frames, cfg.detect, axis_scale=ref.axis_scale)
        tracked, _ = _associate(ref, det, cfg)
        recon = reconstruct_sequence(cam, tracked, cfg.reconstruct,
                                     apply_warmup=apply_warmup)
        contact = contact_state_sequence(recon, cfg.analysis)
        return PipelineOutputs(detections=det, tracked=tracked, recon=recon,
                               contact=contact)


def run_video(frames: torch.Tensor, cam: CameraModel, cfg: PipelineConfig,
              crop: bool = False, apply_warmup: bool = True) -> PipelineOutputs:
    """Initialize on frame 0, then process the batch; honours
    ``cfg.undistort_frames`` (rectify map built once per call)."""
    rectify_map = None
    if cfg.undistort_frames:
        h, w = frames.shape[1:3]
        rectify_map, cam = prepare_undistortion(cam, int(h), int(w), cfg, crop)
    ref = initialize(frames[0], cfg, crop, rectify_map)
    return process_frames(frames, ref, cam, cfg, crop, apply_warmup,
                          rectify_map)


def _to(x, device: torch.device):
    """A tensor, dict or tuple of tensors (or None) moved to ``device``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return type(x)(*(_to(v, device) if isinstance(v, torch.Tensor) else v
                     for v in x))


class StreamingPipeline:
    """Stateful chunked pipeline for live or arbitrarily long sources.

    Carries the frame-0 reference table (with the photometric axis scale),
    the displacement-scan state, the global frame count (for the warm-up
    mask) and, in sequential association mode, the last-seen positions
    across chunks, so that chunked results equal one batch and a session
    can be checkpointed and resumed (``io/session.py``). Honours
    ``crop=True`` and ``cfg.undistort_frames`` like the batch API. The
    state and every chunk live on ``device`` (the card by default).
    """

    def __init__(self, cam: CameraModel, cfg: PipelineConfig,
                 ref: ReferenceMarkers | None = None,
                 carry: dict | None = None, crop: bool = False,
                 assoc_xy: torch.Tensor | None = None,
                 apply_warmup: bool = False, frames_seen: int = 0,
                 device=CUDA):
        self.device = resolve(device)
        self.cam = _to(cam, self.device)
        self.cfg = cfg
        self.ref = _to(ref, self.device)
        self.carry = _to(carry, self.device)
        self.assoc_xy = _to(assoc_xy, self.device)
        self.apply_warmup = apply_warmup
        self.crop = crop
        self.frames_seen = frames_seen
        self._rectify_map = None
        self._recon_cam = None
        self._frame_hw = None   # (H, W) the session is built for

    def process(self, frames) -> PipelineOutputs:
        """Process one chunk ``(B, H, W[, 3])`` (a tensor or numpy array,
        moved to the pipeline's device); the state advances."""
        with trace_annotation("vbs.pipeline.chunk"):
            return self._process(frames)

    def _process(self, frames) -> PipelineOutputs:
        frames = (frames.to(self.device) if isinstance(frames, torch.Tensor)
                  else torch.tensor(np.asarray(frames), device=self.device))
        hw = tuple(int(d) for d in frames.shape[1:3])
        if self._frame_hw is None:
            self._frame_hw = hw
            self._recon_cam = self.cam
            if self.cfg.undistort_frames:
                self._rectify_map, self._recon_cam = prepare_undistortion(
                    self.cam, hw[0], hw[1], self.cfg, self.crop)
        elif hw != self._frame_hw:
            # The reference table's pixel coordinates and the rectify map
            # belong to the first geometry: fail rather than remap wrongly.
            raise ValueError(
                f"frame shape changed mid-session: {self._frame_hw} -> {hw}; "
                "the frame-0 reference markers and rectify map are tied to "
                "the original geometry — start a new StreamingPipeline (or "
                "a new session) for the new stream")
        cfg = self.cfg
        if self.ref is None:
            self.ref = initialize(frames[0], cfg, self.crop,
                                  self._rectify_map)
        if self.carry is None:
            self.carry = initial_carry(self.ref.xy.shape[0],
                                       device=self.device)
        if self.assoc_xy is None:
            self.assoc_xy = self.ref.xy

        x = _preprocess(frames, cfg, self.crop, self._rectify_map)
        det = detect_markers(x, cfg.detect, axis_scale=self.ref.axis_scale)
        tracked, self.assoc_xy = _associate(self.ref, det, cfg, self.assoc_xy)
        world, ok = reconstruct_positions(self._recon_cam, tracked.xy,
                                          tracked.axes, tracked.valid,
                                          cfg.reconstruct)
        if self.apply_warmup:
            world, ok = warmup_mask(world, ok, cfg.reconstruct.warmup_frames,
                                    self.frames_seen)
        recon, self.carry = displacement_scan(world, ok, cfg.reconstruct,
                                              carry=self.carry,
                                              return_carry=True)
        self.frames_seen += frames.shape[0]
        return PipelineOutputs(det, tracked, recon,
                               contact_state_sequence(recon, cfg.analysis))

    def run(self, source, batch_size: int = 64):
        """Iterate ``PipelineOutputs`` chunks over a ``VideoSource``, fed to
        the pipeline's device by ``io/video.py:device_feed`` (for
        ``MjpegAviCudaSource``: host entropy decode, device decode)."""
        from vision_basedsensor_tpu_torch.io.video import device_feed
        for batch in device_feed(source, batch_size, self.device):
            yield self.process(batch)
