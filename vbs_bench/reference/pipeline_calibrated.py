"""The reference pipeline of a calibrated camera: every frame rectified
through the lens's map before detection (``marker_detection.py:88-109``),
association against each marker's last sighting, and reconstruction with
the rectified pinhole. The semantics of the port's ``initialize`` /
``process_frames`` with a rectify map and ``association_mode="sequential"``
(``apply_warmup=False``, no crop), as ``pipeline_unfused.py`` sits beside
``pipeline.py``; detection on the branch the frames take."""
from __future__ import annotations

import torch

from vbs_bench.reference.associate_sequential import associate_sequential
from vbs_bench.reference.camera import CameraModel
from vbs_bench.reference.config import PipelineConfig
from vbs_bench.reference.displacement import reconstruct_sequence
from vbs_bench.reference.force import contact_state_sequence
from vbs_bench.reference.imaging import to_grayscale
from vbs_bench.reference.pipeline import Outputs, precision  # noqa: F401
from vbs_bench.reference.rings import ReferenceMarkers, assign_identities
from vbs_bench.reference.undistort import (build_rectify_map,
                                           optimal_new_camera,
                                           remap_bilinear)
from vbs_bench.reference.unfused import (detect_markers,
                                         detect_markers_and_scale)


def prepare(cam: CameraModel, h: int, w: int
            ) -> tuple[torch.Tensor, CameraModel]:
    """The rectify map of ``h`` x ``w`` frames and the rectified pinhole
    (no distortion, the lens camera's extrinsics) that reconstruction
    uses."""
    new_cam = optimal_new_camera(cam, h, w, alpha=0.0)
    src_map = build_rectify_map(cam, h, w, new_cam)
    return src_map, new_cam._replace(R_wc=cam.R_wc, T_wc=cam.T_wc)


def rectify(frames: torch.Tensor, cfg: PipelineConfig,
            src_map: torch.Tensor) -> torch.Tensor:
    """Gray frames remapped through ``src_map``: float32, not rounded."""
    return remap_bilinear(to_grayscale(frames, cfg.detect.channel_order),
                          src_map)


def initialize(first_frame: torch.Tensor, cfg: PipelineConfig,
               src_map: torch.Tensor) -> ReferenceMarkers:
    """Frame-0 prologue on the rectified frame: detect, assign canonical
    identities, measure the photometric axis scale."""
    det, scale = detect_markers_and_scale(rectify(first_frame, cfg, src_map),
                                          cfg.detect)
    ref = assign_identities(det, cfg.track)._replace(axis_scale=scale)
    if int(ref.valid.sum()) == 0:
        raise ValueError("reference: no markers detected in the first frame")
    return ref


def process_frames(frames: torch.Tensor, ref: ReferenceMarkers,
                   cam: CameraModel, cfg: PipelineConfig,
                   src_map: torch.Tensor, stats: list | None = None
                   ) -> Outputs:
    """The steady-state pipeline over a batch ``(B, H, W)`` from the
    session's start: ``cam`` is :func:`prepare`'s rectified pinhole."""
    det = detect_markers(rectify(frames, cfg, src_map), cfg.detect,
                         axis_scale=ref.axis_scale, stats=stats)
    tracked, _ = associate_sequential(ref, det,
                                      cfg.track.min_marker_distance_px)
    recon = reconstruct_sequence(cam, tracked, cfg.reconstruct)
    return Outputs(det, tracked, recon,
                   contact_state_sequence(recon, cfg.analysis))
