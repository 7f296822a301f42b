"""Frame-to-frame marker association (reference C7), batched over frames.

Port of ``vision_basedsensor_tpu/track/associate.py``. ``associate`` (the
default ``association_mode="frame0"``): every frame-0 marker takes its
nearest valid detection within the gate, independently per frame, as one
batched ``(B, 65, K)`` distance computation; like the reference, the match
is not one-to-one. ``associate_sequential`` gates against each marker's
last sighting, one-to-one; its ``lax.scan`` is a Python loop over frames.
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


def associate_sequential(ref: ReferenceMarkers, det: Detections,
                         gate_px: float, carry_xy: torch.Tensor | None = None,
                         return_carry: bool = False):
    """Association against each marker's last sighting instead of frame 0
    (``association_mode="sequential"``), one frame at a time over ``det``'s
    single leading frame axis. A detection belongs only to its closest
    claiming slot, so a marker that is hidden keeps its stale position
    instead of latching onto a neighbour. ``carry_xy`` ``(65, 2)`` resumes
    from a previous chunk (default: the frame-0 table); with
    ``return_carry`` the final last-seen positions are returned too."""
    last = ref.xy if carry_xy is None else carry_xy
    n = ref.xy.shape[0]
    slots = torch.arange(n, device=ref.xy.device)
    inf = torch.tensor(float("inf"), device=ref.xy.device)
    zero = torch.zeros((), dtype=ref.xy.dtype, device=ref.xy.device)
    outs = []
    for xy_t, axes_t, angle_t, valid_t in zip(det.xy, det.axes, det.angle,
                                              det.valid):
        d = torch.linalg.vector_norm(last[:, None, :] - xy_t[None, :, :],
                                     dim=-1)
        d = torch.where(valid_t[None, :] & ref.valid[:, None], d, inf)
        j = torch.argmin(d, dim=-1)
        dmin = torch.amin(d, dim=-1)
        same = j[None, :] == j[:, None]             # slots sharing my pick
        owner = torch.argmin(torch.where(same, dmin[None, :], inf), dim=-1)
        valid = ref.valid & (dmin <= gate_px) & (owner == slots)
        xy = xy_t[j]
        last = torch.where(valid[:, None], xy, last)
        outs.append((torch.where(valid[:, None], xy, zero),
                     torch.where(valid[:, None], axes_t[j], zero),
                     torch.where(valid, angle_t[j], zero), valid))
    xy, axes, angle, valid = (torch.stack(v) for v in zip(*outs))
    tracked = TrackedFrames(xy=xy, ref_xy=ref.xy, axes=axes, angle=angle,
                            ring=ref.ring, valid=valid)
    return (tracked, last) if return_carry else tracked
