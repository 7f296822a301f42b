"""Frame-to-frame marker association (reference C7), batched over frames.

Port of ``vision_basedsensor_tpu/track/associate.py:associate`` (the
default ``association_mode="frame0"``): every frame-0 marker takes its
nearest valid detection within the gate, independently per frame, as one
batched ``(B, 65, K)`` distance computation. Like the reference, the match
is not one-to-one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.detect.detector import Detections
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers


class TrackedFrames(NamedTuple):
    """Per-frame state of the 65 canonical markers (leading frame axes)."""
    xy: torch.Tensor      # (..., 65, 2) current centers
    ref_xy: torch.Tensor  # (65, 2) frame-0 centers
    axes: torch.Tensor    # (..., 65, 2)
    angle: torch.Tensor   # (..., 65)
    ring: torch.Tensor    # (65,)
    valid: torch.Tensor   # (..., 65)


def associate(ref: ReferenceMarkers, det: Detections,
              gate_px: float) -> TrackedFrames:
    """Nearest-detection association with a distance gate; ``det`` may carry
    leading frame axes."""
    d = torch.linalg.vector_norm(ref.xy[:, None, :] - det.xy[..., None, :, :],
                                 dim=-1)
    d = torch.where(det.valid[..., None, :], d, torch.full_like(d, float("inf")))
    j = torch.argmin(d, dim=-1)         # first index among equal minima
    dmin = torch.amin(d, dim=-1)
    valid = ref.valid & (dmin <= gate_px)

    j2 = j[..., None].expand(*j.shape, 2)
    xy = torch.gather(det.xy, -2, j2)
    axes = torch.gather(det.axes, -2, j2)
    angle = torch.gather(det.angle, -1, j)

    vz = valid[..., None]
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    return TrackedFrames(
        xy=torch.where(vz, xy, zero),
        ref_xy=ref.xy,
        axes=torch.where(vz, axes, zero),
        angle=torch.where(valid, angle, zero),
        ring=ref.ring,
        valid=valid,
    )
