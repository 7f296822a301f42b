"""First-frame marker identity assignment (reference C6), fixed-shape.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vbs_bench.reference import layout
from vbs_bench.reference.config import TrackConfig
from vbs_bench.reference.detector import Detections


class ReferenceMarkers(NamedTuple):
    """Frame-0 marker table in canonical id order (slot i <-> marker_id i+1)."""
    xy: torch.Tensor      # (65, 2) first-frame sub-pixel centers
    axes: torch.Tensor    # (65, 2)
    angle: torch.Tensor   # (65,)
    ring: torch.Tensor    # (65,) int32 ring index (0 = center)
    valid: torch.Tensor   # (65,) bool
    # Photometric axis calibration measured on frame 0 and pinned for the
    # session (ops/moments.finalize).
    axis_scale: torch.Tensor | float = 1.0


def kmeans_1d(values: torch.Tensor, mask: torch.Tensor, k: int, iters: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration 1-D KMeans with farthest-point init. Returns (sorted
    centroids (k,), labels (N,)) with label 0 the innermost cluster."""
    big = torch.tensor(1e12, dtype=values.dtype, device=values.device)
    vals = torch.where(mask, values, big)
    init = torch.min(vals)[None]
    for _ in range(k - 1):
        d = torch.amin(torch.abs(values[:, None] - init[None, :]), dim=1)
        d = torch.where(mask, d, torch.full_like(d, -1.0))
        init = torch.cat([init, values[torch.argmax(d)][None]])

    c = init
    ks = torch.arange(k, device=values.device)
    for _ in range(iters):
        d = torch.abs(values[:, None] - c[None, :])
        lab = torch.argmin(d, dim=1)
        onehot = (lab[:, None] == ks[None, :]) & mask[:, None]
        cnt = onehot.sum(0)
        s = (onehot * values[:, None]).sum(0)
        c = torch.where(cnt > 0, s / torch.clamp(cnt, min=1), c)

    # jnp.argsort is stable; torch.argsort is not unless asked.
    order_c = torch.argsort(c, stable=True)
    cents_sorted = c[order_c]
    inv = torch.argsort(order_c, stable=True)
    d = torch.abs(values[:, None] - c[None, :])
    labels = inv[torch.argmin(d, dim=1)]
    return cents_sorted, labels


def expected_ring_radii(cfg: TrackConfig) -> np.ndarray:
    """Expected image ring radii up to scale, normalized to the outer ring
    (perspective-corrected with the nominal camera distance)."""
    r = np.asarray(layout.RING_RADII_MM[1:])
    z = np.asarray(layout.RING_HEIGHTS_MM[1:])
    e = r / (cfg.camera_distance_hint_mm + z)
    return e / e[-1]


def assign_rings_layout_prior(radius: torch.Tensor, mask: torch.Tensor,
                              cfg: TrackConfig
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ring assignment by consensus scale against the known dome layout.
    Returns (ring labels 0..k-1, on_dome mask)."""
    e = torch.as_tensor(expected_ring_radii(cfg), dtype=radius.dtype,
                        device=radius.device)                   # (k,)
    cand = (radius[:, None] / e[None, :]).reshape(-1)           # (N*k,)
    cand_ok = torch.repeat_interleave(mask, e.shape[0])
    resid = torch.abs(radius[:, None, None] - cand[None, None, :] * e[None, :, None])
    best = torch.amin(resid, dim=1)                             # (N, N*k)
    support = torch.sum((best < cfg.ring_tolerance * cand[None, :])
                        & mask[:, None], dim=0)
    support = torch.where(cand_ok & (cand > 1e-6), support,
                          torch.full_like(support, -1))
    s = cand[torch.argmax(support)]
    d = torch.abs(radius[:, None] - s * e[None, :])
    ring = torch.argmin(d, dim=1)
    on_dome = torch.amin(d, dim=1) < cfg.ring_tolerance * s
    return ring, on_dome


def assign_identities(det: Detections, cfg: TrackConfig) -> ReferenceMarkers:
    """Map a first-frame detection set ``(K, ...)`` to canonical marker ids:
    center = detection nearest the centroid, polar coordinates around it,
    rings by layout prior (or KMeans), angle -> slot via the layout
    bijection, one winner per slot (highest score, ties to the lowest
    detection index)."""
    xy = det.xy
    dev = xy.device
    mask = det.valid
    n = xy.shape[0]
    idx = torch.arange(n, device=dev)
    m = mask[:, None].to(xy.dtype)
    centroid = (xy * m).sum(0) / torch.clamp(m.sum(), min=1e-9)
    d_cent = torch.where(mask, torch.linalg.vector_norm(xy - centroid, dim=1),
                         torch.full((n,), float("inf"), device=dev))
    ci = torch.argmin(d_cent)
    center_xy = xy[ci]

    rel = xy - center_xy
    radius = torch.linalg.vector_norm(rel, dim=1)
    theta_img = torch.atan2(rel[:, 1], rel[:, 0]) * (180.0 / math.pi)
    theta_world = cfg.angle_sign * theta_img + cfg.angle_offset_deg

    others = mask & (idx != ci)
    if cfg.ring_method == "layout_prior":
        ring0, on_dome = assign_rings_layout_prior(radius, others, cfg)
        mask = mask & (on_dome | (idx == ci))
    else:
        _, ring0 = kmeans_1d(radius, others, cfg.num_rings, cfg.kmeans_iters)
    ring = torch.where(idx == ci, torch.zeros_like(ring0), ring0 + 1)

    bases = torch.as_tensor(layout._ring_base_ids(), device=dev)
    counts = torch.as_tensor(layout.RING_COUNTS, device=dev)
    starts = torch.as_tensor(layout.RING_START_DEG, dtype=xy.dtype, device=dev)
    steps = torch.as_tensor(layout.RING_STEP_DEG, dtype=xy.dtype, device=dev)
    r = torch.clamp(ring, 0, layout.NUM_RINGS)
    stepd = torch.where(r == 0, torch.ones_like(steps[r]), steps[r])

    phase = torch.zeros_like(theta_world)
    if cfg.per_ring_phase:
        # Per-ring angular phase: circular mean of the slot residuals.
        for k in range(1, layout.NUM_RINGS + 1):
            in_ring = mask & (ring == k)
            step_k = float(layout.RING_STEP_DEG[k])
            resid = (theta_world - float(layout.RING_START_DEG[k])) / step_k
            frac = 2.0 * math.pi * (resid - torch.floor(resid))
            mk = in_ring.to(xy.dtype)
            s = torch.sum(mk * torch.sin(frac))
            c = torch.sum(mk * torch.cos(frac))
            off = torch.atan2(s, c) / (2.0 * math.pi) * step_k
            phase = torch.where(in_ring, off, phase)

    slot = torch.round((theta_world - phase - starts[r]) / stepd).int()
    slot = torch.remainder(slot, counts[r])
    marker_id = torch.where(r == 0, torch.ones_like(slot), bases[r] + slot)

    slots = marker_id - 1                                       # (K,)
    match = (torch.arange(layout.NUM_MARKERS, device=dev)[:, None]
             == slots[None, :]) & mask[None, :]
    score_m = torch.where(match, det.score[None, :],
                          torch.full_like(match, float("-inf"), dtype=xy.dtype))
    winner = torch.argmax(score_m, dim=1)                       # (65,)
    occupied = torch.any(match, dim=1)

    def take(src):
        v = src[winner]
        keep = occupied.reshape((-1,) + (1,) * (v.ndim - 1))
        return torch.where(keep, v, torch.zeros_like(v))

    return ReferenceMarkers(xy=take(xy), axes=take(det.axes),
                            angle=take(det.angle),
                            ring=torch.where(occupied, ring[winner],
                                             torch.zeros_like(ring[winner])).int(),
                            valid=occupied)
