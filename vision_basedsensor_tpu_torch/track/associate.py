"""Frame-to-frame marker association (reference C7), batched over frames.

Port of ``vision_basedsensor_tpu/track/associate.py``. ``associate`` (the
default ``association_mode="frame0"``): every frame-0 marker takes its
nearest valid detection within the gate, independently per frame, as one
batched ``(B, 65, K)`` distance computation; like the reference, the match
is not one-to-one. ``associate_sequential`` gates against each marker's
last sighting, one-to-one: the reference's ``lax.scan`` is one launch of
``csrc/associate.cu`` on the card, and a Python loop over frames in its
plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.detect.detector import Detections
from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
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


def associate_sequential_reference(ref: ReferenceMarkers, det: Detections,
                                   gate_px: float,
                                   carry_xy: torch.Tensor | None = None,
                                   return_carry: bool = False):
    """Plain version of :func:`associate_sequential`: a Python loop over the
    frames. ``B = 0`` gives empty outputs and the carry unchanged, as
    ``lax.scan`` does."""
    last = ref.xy if carry_xy is None else carry_xy
    n, (b, k) = ref.xy.shape[0], det.valid.shape
    dev = ref.xy.device
    slots = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), dtype=det.xy.dtype, device=dev)
    xy = torch.empty((b, n, 2), dtype=det.xy.dtype, device=dev)
    axes = torch.empty((b, n, 2), dtype=det.axes.dtype, device=dev)
    angle = torch.empty((b, n), dtype=det.angle.dtype, device=dev)
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    for t in range(b):
        xy_t = det.xy[t]
        dx = last[:, None, 0] - xy_t[None, :, 0]
        dy = last[:, None, 1] - xy_t[None, :, 1]
        d = torch.sqrt(dx * dx + dy * dy)   # the kernel's order
        d = torch.where(det.valid[t][None, :] & ref.valid[:, None], d, inf)
        j = torch.argmin(d, dim=-1)
        dmin = torch.amin(d, dim=-1)
        same = j[None, :] == j[:, None]             # slots sharing my pick
        owner = torch.argmin(torch.where(same, dmin[None, :], inf), dim=-1)
        ok = ref.valid & (dmin <= gate_px) & (owner == slots)
        xy_j = xy_t[j]
        last = torch.where(ok[:, None], xy_j, last)
        xy[t] = torch.where(ok[:, None], xy_j, zero)
        axes[t] = torch.where(ok[:, None], det.axes[t][j], zero)
        angle[t] = torch.where(ok, det.angle[t][j], zero)
        valid[t] = ok
    tracked = TrackedFrames(xy=xy, ref_xy=ref.xy, axes=axes, angle=angle,
                            ring=ref.ring, valid=valid)
    return (tracked, last) if return_carry else tracked


def associate_sequential(ref: ReferenceMarkers, det: Detections,
                         gate_px: float, carry_xy: torch.Tensor | None = None,
                         return_carry: bool = False):
    """Association against each marker's last sighting instead of frame 0
    (``association_mode="sequential"``), one frame at a time over ``det``'s
    single leading frame axis. A detection belongs only to its closest
    claiming slot, so a marker that is hidden keeps its stale position
    instead of latching onto a neighbour. ``carry_xy`` ``(65, 2)`` resumes
    from a previous chunk (default: the frame-0 table); with
    ``return_carry`` the final last-seen positions are returned too (the
    given carry is never changed in place). CPU tensors take :func:`associate_sequential_reference`; CUDA
    tensors one launch of the association kernel (``ops/cuda/scan.py``)."""
    if ref.xy.device.type == "cpu":
        return associate_sequential_reference(ref, det, gate_px, carry_xy,
                                              return_carry)
    det = det._replace(**{f: getattr(det, f).contiguous()
                          for f in ("xy", "axes", "angle", "valid")})
    (xy, axes, angle, valid), last = kscan.associate_sequential(
        ref, det, gate_px, carry_xy)
    tracked = TrackedFrames(xy=xy, ref_xy=ref.xy, axes=axes, angle=angle,
                            ring=ref.ring, valid=valid)
    return (tracked, last) if return_carry else tracked
