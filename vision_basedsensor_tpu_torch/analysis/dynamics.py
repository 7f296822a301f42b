"""Dynamic contact monitoring: aggregate displacement signal + force indicator.

Port of ``vision_basedsensor_tpu/analysis/dynamics.py``: the reference's
polishing-process demo (README.md:153-177) plots the filtered total marker
Z-displacement of a rotating bonnet against a force sensor's FZ channel.
Here that signal path is per-frame aggregate displacement over the tracked
markers (masked, robust to dropouts), a zero-phase moving average
(forward + backward box) and a linear force indicator
``F = stiffness * displacement``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vision_basedsensor_tpu_torch.core.fit import masked_mean
from vision_basedsensor_tpu_torch.reconstruct.displacement import Reconstruction

# README.md:153-161: ~-3.8 N at ~-9.8 mm total Z displacement.
DEFAULT_STIFFNESS_N_PER_MM = 3.8 / 9.8


class ContactSignal(NamedTuple):
    raw: torch.Tensor          # (B,) per-frame aggregate displacement
    filtered: torch.Tensor     # (B,) zero-phase smoothed
    force_n: torch.Tensor      # (B,) linear force indicator
    num_tracked: torch.Tensor  # (B,) markers contributing per frame


def _box_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """``jnp.convolve(x, ones(window), mode="same")`` of a 1-D ``x``: the
    middle ``max(len(x), window)`` samples of the full convolution, from
    ``(min(len(x), window) - 1) // 2`` on (numpy's centring). For a window
    no longer than ``x`` the box reaches ``window // 2`` samples back and
    ``(window - 1) // 2`` forward; a longer window gives a longer output,
    as in the reference."""
    n = x.shape[0]
    full = F.conv1d(F.pad(x[None, None], (window - 1, window - 1)),
                    torch.ones((1, 1, window), dtype=x.dtype,
                               device=x.device))[0, 0]
    start = (min(n, window) - 1) // 2
    return full[start:start + max(n, window)]


def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-phase (forward+backward) box filter with edge renormalization."""
    if window <= 1:
        return x
    den = _box_same(torch.ones_like(x), window)
    y = _box_same(x, window) / den
    num2 = _box_same(torch.flip(y, (0,)), window)
    # The backward pass's coverage at position j is den[j], not den
    # reversed: for an even window the 'same' centring makes den asymmetric.
    return torch.flip(num2 / den, (0,))


def contact_signal(recon: Reconstruction, component: str = "z",
                   window: int = 15,
                   stiffness_n_per_mm: float = DEFAULT_STIFFNESS_N_PER_MM
                   ) -> ContactSignal:
    """Aggregate displacement-from-start across markers, per frame.

    ``component``: 'z' (the reference's total-Z trace), or 'norm' for the
    Euclidean magnitude.
    """
    if component == "z":
        per_marker = recon.from_first[..., 2]
    else:
        per_marker = recon.from_first_norm
    raw = masked_mean(per_marker, recon.seen, axis=1)
    filt = moving_average(raw, window)
    return ContactSignal(
        raw=raw,
        filtered=filt,
        force_n=stiffness_n_per_mm * filt,
        num_tracked=recon.seen.sum(dim=1),
    )
