"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, as numbers each held to a limit of its own.

A gap is the largest absolute difference over the entries valid on both
sides. Entries valid on one side only, or a frame with detections on one
side only, read ``MISMATCH``, so that every fault shows as a number."""
from __future__ import annotations

import sys

import torch

MISMATCH = 1e6


def slot_gap(a: torch.Tensor, va: torch.Tensor, b: torch.Tensor,
             vb: torch.Tensor) -> float:
    """Largest |a - b| over the slots valid in both; ``MISMATCH`` where the
    shapes or the valid masks differ or a valid entry is not finite."""
    if a.shape != b.shape or va.shape != vb.shape or not torch.equal(
            va.to(b.device), vb):
        return MISMATCH
    if not bool(vb.any()):
        return 0.0
    d = (a.to(b.device).float() - b.float()).abs()
    while d.ndim > vb.ndim:
        d = d.amax(-1)
    d = torch.nan_to_num(d[vb], nan=MISMATCH, posinf=MISMATCH)
    return min(float(d.max()), MISMATCH)


def set_gap(xa: torch.Tensor, va: torch.Tensor, xb: torch.Tensor,
            vb: torch.Tensor) -> float:
    """Per frame, each valid point's distance to the nearest valid point of
    the other frame's set, both ways: the largest over all frames.
    Detection slots are candidates in score order, so they are compared as
    sets. ``(B, K, 2)`` points, ``(B, K)`` masks."""
    xa, va = xa.to(xb.device).float(), va.to(vb.device)
    if xa.shape[0] != xb.shape[0]:
        return MISMATCH
    d = torch.linalg.vector_norm(xa[:, :, None] - xb.float()[:, None],
                                 dim=-1)                 # (B, Ka, Kb)
    inf = torch.tensor(float("inf"), device=d.device)
    d = torch.where(va[:, :, None] & vb[:, None, :], d, inf)
    worst = torch.cat([d.amin(2)[va], d.amin(1)[vb]])
    if worst.numel() == 0:
        return 0.0
    return min(float(torch.nan_to_num(worst, nan=MISMATCH,
                                      posinf=MISMATCH).max()), MISMATCH)


def pipeline_numbers(got, want) -> dict:
    """The numbers of one batch's outputs (``process_frames``'s fields)
    against the reference's."""
    g, w = got, want
    tracked = max(slot_gap(g.tracked.xy, g.tracked.valid, w.tracked.xy,
                           w.tracked.valid),
                  slot_gap(g.tracked.ref_xy, g.tracked.ring >= 0,
                           w.tracked.ref_xy, w.tracked.ring >= 0),
                  0.0 if torch.equal(g.tracked.ring.to(w.tracked.ring.device)
                                     .int(), w.tracked.ring.int())
                  else MISMATCH)
    return {
        "det_px": set_gap(g.detections.xy, g.detections.valid,
                          w.detections.xy, w.detections.valid),
        "tracked_px": tracked,
        "axes_px": slot_gap(g.tracked.axes, g.tracked.valid, w.tracked.axes,
                            w.tracked.valid),
        "world_mm": slot_gap(g.recon.world, g.recon.seen, w.recon.world,
                             w.recon.seen),
        "from_first_mm": slot_gap(g.recon.from_first, g.recon.seen,
                                  w.recon.from_first, w.recon.seen),
        "tilt_deg": slot_gap(g.contact.tilt_deg, g.contact.valid,
                             w.contact.tilt_deg, w.contact.valid),
    }


def worst(readings) -> dict:
    """Each number's largest value over ``readings`` (dicts)."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number named in ``limits`` is within its limit, and
    the table ``{name: {"value", "limit"}}`` (limits' order)."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(t["value"] <= t["limit"] for t in table.values()), table


def print_table(table: dict, file=sys.stderr) -> None:
    for k, t in table.items():
        print(f"check {k} {t['value']!r} limit {t['limit']!r}", file=file)
