"""Association against each marker's last sighting, one frame at a time,
one-to-one (a frozen copy of the port's
``track/associate.py:associate_sequential_reference``, the Python loop over
frames that the association kernel replaces)."""
from __future__ import annotations

import torch

from vbs_bench.reference.associate import TrackedFrames
from vbs_bench.reference.detector import Detections
from vbs_bench.reference.rings import ReferenceMarkers


def associate_sequential(ref: ReferenceMarkers, det: Detections,
                         gate_px: float,
                         carry_xy: torch.Tensor | None = None
                         ) -> tuple[TrackedFrames, torch.Tensor]:
    """Each frame of ``det`` ``(B, K, ...)`` against the last-seen
    positions (``carry_xy``, default the frame-0 table): a marker takes its
    nearest valid detection within the gate, and a detection belongs only
    to its closest claiming marker. Returns the tracked frames and the
    last-seen positions after the last frame."""
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
        d = torch.sqrt(dx * dx + dy * dy)
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
    return TrackedFrames(xy=xy, ref_xy=ref.xy, axes=axes, angle=angle,
                         ring=ref.ring, valid=valid), last
