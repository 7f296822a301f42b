"""Window gather kernel of the PyTorch port vs the JAX Pallas gather.

The port's plain version (what a CPU tensor takes) must reproduce the
Pallas ``gather_windows`` (interpret mode) on every lane the moment stage
can gate in (in-image and inside the radial cutoff disk), with identical
patch origins, for pack=1 and pack=2, border peaks included. Lanes outside
the image are 0 in the port (the TPU kernel leaves other data there). On a
card the CUDA kernel is checked in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_, peaks_pair, to_torch

from vision_basedsensor_tpu.config import DetectConfig
from vision_basedsensor_tpu.ops.moments import cut_geometry as jcut
from vision_basedsensor_tpu.ops.pallas.moments import gather_windows as jgather

import jax

from vision_basedsensor_tpu_torch.config import DetectConfig as TDetectConfig
from vision_basedsensor_tpu_torch.ops.cuda import moments as tgather
from vision_basedsensor_tpu_torch.ops.moments import cut_geometry as tcut


def _gate(start, xy, patch_rows, pack, width, cutoff):
    """Lanes the moment stage can keep: in the image and in the disk."""
    b, k, _ = start.shape
    lanes = np.arange(128)
    j = lanes // 64 if pack == 2 else np.zeros_like(lanes)
    local = lanes - 64 * j
    kk = pack * np.arange(k // pack)[:, None] + j                    # (KO, 128)
    sx, sy = start[..., 0][:, kk], start[..., 1][:, kk]              # (B, KO, 128)
    px, py = xy[..., 0][:, kk], xy[..., 1][:, kk]
    dx = (sx + local - px)[:, :, None, :]
    dy = (sy - py)[:, :, None, :] + np.arange(patch_rows)[:, None]
    return ((dx * dx + dy * dy) <= cutoff ** 2) & ((sx + local) < width)[:, :, None, :]


@pytest.mark.parametrize("profile,pack", [("low_res", 1), ("low_res", 2),
                                          ("high_res", 1), ("high_res", 2)])
def test_plain_gather_matches_pallas_on_gated_lanes(profile, pack):
    h, w, b, k = 240, 384, 2, 12
    prof = getattr(DetectConfig(), profile)
    rng = np.random.default_rng(21)
    packed = rng.integers(0, 1024, (b, h, w)).astype(np.float32)
    jp, tp = peaks_pair(rng, b, k, h, w)
    jpatch, jstart = jgather(jnp.asarray(packed), jp, jax.vmap(jcut)(jp),
                             prof, interpret=True, pack=pack)
    tpatch, tstart = tgather.gather_windows(to_torch(packed), tp, tcut(tp),
                                            getattr(TDetectConfig(), profile),
                                            pack=pack)
    np.testing.assert_array_equal(np_(jstart), np_(tstart))
    assert tpatch.shape == (b, k // pack, prof.patch_size, 128)
    gate = _gate(np_(tstart), np_(tp.xy), prof.patch_size, pack, w,
                 prof.radial_cutoff_px)
    assert gate.sum() > 0
    np.testing.assert_array_equal(np_(jpatch)[gate], np_(tpatch)[gate])
    # Out-of-image lanes are written as 0 (a 64-px patch fills its paired
    # slot, so only the narrower or unpaired layouts reach past the image).
    lanes = np.arange(128)
    j = lanes // 64 if pack == 2 else np.zeros_like(lanes)
    kk = pack * np.arange(k // pack)[:, None] + j
    outside = (np_(tstart)[..., 0][:, kk] + lanes - 64 * j) >= w
    assert outside.any() == (pack == 1 or prof.patch_size < 64)
    assert (np_(tpatch).transpose(0, 1, 3, 2)[outside] == 0).all()


def test_gather_rejects_odd_pairs_and_wide_patches():
    rng = np.random.default_rng(0)
    _, tp = peaks_pair(rng, 1, 5, 64, 96, border=False)
    packed = torch.zeros((1, 64, 96))
    prof = TDetectConfig().low_res
    with pytest.raises(ValueError):
        tgather.gather_windows_paired(packed, tp, tcut(tp), prof)
    with pytest.raises(ValueError):
        tgather.gather_windows(packed, tp, tcut(tp), prof, pack=3)


@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("b,k", [(0, 6), (2, 0), (0, 0)])
def test_gather_empty_batch_or_peaks(b, k, pack):
    """B = 0 or K = 0 gives an empty ``(B, K // pack, P, 128)`` float32
    output and ``(B, K, 2)`` origins, as the card path returns them. JAX's
    interpret mode raises at B = 0, so the card path's contract is the
    reference here."""
    prof = TDetectConfig().low_res
    rng = np.random.default_rng(3)
    xy = torch.as_tensor(rng.uniform(0, 60, (b, k, 2)), dtype=torch.float32)
    peaks = tgather.Peaks(xy=xy, score=torch.ones((b, k)),
                          valid=torch.ones((b, k), dtype=torch.bool))
    packed = torch.as_tensor(rng.random((b, 64, 96)), dtype=torch.float32)
    before = tgather.gather_launches
    out, start = tgather.gather_windows(packed, peaks, tcut(peaks), prof,
                                        pack=pack)
    assert out.shape == (b, k // pack, prof.patch_size, 128)
    assert out.dtype == torch.float32 and start.shape == (b, k, 2)
    assert torch.equal(out, tgather.gather_windows_reference(
        packed, start, prof.patch_size, pack))
    assert tgather.gather_launches == before


def test_cpu_dispatch_does_not_launch():
    rng = np.random.default_rng(1)
    _, tp = peaks_pair(rng, 1, 6, 64, 96)
    before = tgather.gather_launches
    tgather.gather_windows_paired(torch.zeros((1, 64, 96)), tp, tcut(tp),
                                  TDetectConfig().low_res)
    assert tgather.gather_launches == before
