"""Peaks, cut geometry, moment sums and plane fits: PyTorch port vs JAX.

The tie-order traps of the port are pinned exactly: ``lax.top_k`` orders
equal values by lower index (cell selection, nearest neighbours), and
``jnp.nanmedian`` averages the two middle values of an even count. The
moment sums are compared on identical gathered windows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import np_, render_jax, staircase, to_torch

from vision_basedsensor_tpu.config import DetectConfig
from vision_basedsensor_tpu.core import fit as jfit
from vision_basedsensor_tpu.core.imaging import to_grayscale
from vision_basedsensor_tpu.ops import moments as jm
from vision_basedsensor_tpu.ops.dog import dog_area_mask
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian
from vision_basedsensor_tpu.ops.pallas.fields import fused_fields
from vision_basedsensor_tpu.ops.peaks import Peaks as JPeaks
from vision_basedsensor_tpu.ops.peaks import select_peaks_from_cells as jselect

from vision_basedsensor_tpu_torch.config import DetectConfig as TDetectConfig
from vision_basedsensor_tpu_torch.core import fit as tfit
from vision_basedsensor_tpu_torch.ops import moments as tm
from vision_basedsensor_tpu_torch.ops.cuda.moments import gather_windows
from vision_basedsensor_tpu_torch.ops.peaks import Peaks as TPeaks
from vision_basedsensor_tpu_torch.ops.peaks import select_peaks_from_cells as tselect


def test_select_peaks_ties_and_inf_cells_exact():
    """Most cells -inf, finite ones heavily tied: the port's stable sort
    must reproduce lax.top_k's order (ties to the lower cell index), hence
    the suppression result, exactly."""
    rng = np.random.default_rng(4)
    b, hc, wc, w = 3, 30, 48, 384
    cmax = np.round(rng.random((b, hc, wc)) * 4.0) / 4.0
    cmax[rng.random((b, hc, wc)) < 0.9] = -np.inf
    cmax = cmax.astype(np.float32)
    cy, cx = np.meshgrid(np.arange(hc), np.arange(wc), indexing="ij")
    flat = ((cy * 8 + rng.integers(0, 8, (b, hc, wc))) * w
            + cx * 8 + rng.integers(0, 8, (b, hc, wc))).astype(np.int32)
    jp = jselect(jnp.asarray(cmax), jnp.asarray(flat), w, 96, 9.0)
    tp = tselect(to_torch(cmax), torch.from_numpy(flat), w, 96, 9.0)
    for name in ("xy", "score", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      np_(getattr(tp, name)), err_msg=name)
    assert 0 < int(tp.valid.sum()) < b * 96


def test_cut_geometry_equal_distance_ties_exact():
    """Peaks on a square grid have many equidistant neighbours; invalid
    slots and a 3-slot frame (fewer than 3 neighbours) are included."""
    g = np.stack(np.meshgrid(np.arange(5) * 20.0, np.arange(4) * 20.0),
                 -1).reshape(-1, 2).astype(np.float32)
    xy = np.stack([g, g[::-1]])
    valid = np.ones((2, g.shape[0]), bool)
    valid[0, [3, 7, 8]] = False
    for xy_b, valid_b in ((xy, valid), (xy[:, :3], valid[:, :3])):
        jp = JPeaks(xy=jnp.asarray(xy_b), score=jnp.zeros(valid_b.shape),
                    valid=jnp.asarray(valid_b))
        tp = TPeaks(xy=torch.from_numpy(xy_b), score=torch.zeros(valid_b.shape),
                    valid=torch.from_numpy(valid_b))
        jg = jax.vmap(jm.cut_geometry)(jp)
        tg = tm.cut_geometry(tp)
        for name in ("ex", "ey", "rhs"):
            np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                          np_(getattr(tg, name)), err_msg=name)


@pytest.fixture(scope="module")
def windows():
    """Rendered frames -> JAX fields and peaks -> the port's gathered
    windows; both sides then reduce the identical float32 windows."""
    cfg = DetectConfig()
    prof = cfg.low_res
    frames, _ = render_jax(240, 384, staircase(2, 0.5))
    gray = to_grayscale(jnp.asarray(frames))
    area = dog_area_mask(gray, prof, cfg.dog_offset).astype(jnp.float32)
    ncc = normxcorr_gaussian(area, prof.template_size, prof.template_sigma,
                             binary_input=True)
    packed, cval, cidx = fused_fields(ncc, area, gray, cfg.ncc_threshold,
                                      cfg.open_ksize, prof, interpret=True)
    jp = jselect(cval, cidx, 384, cfg.max_candidates, float(prof.peak_window))
    jp = JPeaks(*(jnp.asarray(np.asarray(x)) for x in jp))
    tp = TPeaks(*(torch.from_numpy(np.array(np.asarray(x))) for x in jp))
    jg = jax.vmap(jm.cut_geometry)(jp)
    tg = tm.cut_geometry(tp)
    tpacked = torch.from_numpy(np.array(np.asarray(packed, np.float32)))
    tprof = TDetectConfig().low_res
    return cfg, prof, tprof, jp, tp, jg, tg, tpacked


def _sums_close(js, ts, valid, rel):
    """Each sum within ``rel`` x its channel's largest magnitude. Float32
    reductions in another order leave an error of a few eps x the largest
    term summed; the raw-moment (MXU) basis first sums v * rc^3 * lc^p
    terms up to ~1e7 and then shifts them binomially, so its third moments
    carry ~eps x 1e7 ~ 0.5 absolute (the JAX package's own MXU and fused
    backends differ by 0.35 on these windows)."""
    a, b = np.asarray(js)[valid], np_(ts)[valid]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    scale = np.abs(a).max(axis=0, keepdims=True)
    assert (np.abs(a - b) <= rel * scale + 1e-4).all(), \
        (np.abs(a - b) / np.maximum(scale, 1e-9)).max(axis=0)


@pytest.mark.parametrize("mxu", [True, False])
def test_paired_sums_match_jax_on_identical_windows(windows, mxu):
    cfg, prof, tprof, jp, tp, jg, tg, tpacked = windows
    patches, start = gather_windows(tpacked, tp, tg, tprof, pack=2)
    jfn = jm.moments_from_patches_paired_mxu if mxu else jm.moments_from_patches_paired
    tfn = tm.moments_from_patches_paired_mxu if mxu else tm.moments_from_patches_paired
    js = jfn(jnp.asarray(np_(patches)), jnp.asarray(np_(start)), jp, jg, prof, 384)
    ts = tfn(patches, start, tp, tg, tprof, 384)
    # Observed worst |diff| / channel scale: 2.2e-5 (MXU), 2.6e-7 (fused);
    # the bounds leave ~4x for another CPU's float32 GEMM rounding.
    _sums_close(js, ts, np_(tp.valid), 1e-4 if mxu else 1e-6)


def test_unpaired_sums_match_jax_on_identical_windows(windows):
    cfg, prof, tprof, jp, tp, jg, tg, tpacked = windows
    patches, start = gather_windows(tpacked, tp, tg, tprof, pack=1)
    js = jm.moments_from_patches(jnp.asarray(np_(patches)),
                                 jnp.asarray(np_(start)), jp, jg, prof, 384)
    ts = tm.moments_from_patches(patches, start, tp, tg, tprof, 384)
    _sums_close(js, ts, np_(tp.valid), 1e-6)


def test_finalize_and_occlusion_match_jax(windows):
    cfg, prof, tprof, jp, tp, jg, tg, tpacked = windows
    patches, start = gather_windows(tpacked, tp, tg, tprof, pack=2)
    sums = tm.moments_from_patches_paired_mxu(patches, start, tp, tg, tprof, 384)
    jf = jm.finalize(jnp.asarray(np_(sums)), jp.xy, jp.valid)
    tf = tm.finalize(sums, tp.xy, tp.valid)
    v = np_(tp.valid)
    np.testing.assert_allclose(float(jf.axis_scale), float(tf.axis_scale),
                               rtol=1e-6)
    for name in ("photo_center", "area_center", "band_center", "photo_axes",
                 "area_axes"):
        np.testing.assert_allclose(np.asarray(getattr(jf, name))[v],
                                   np_(getattr(tf, name))[v], atol=1e-4,
                                   err_msg=name)
    jo = jm.complete_occluded(jf, 1.45, 6.0, 0.08)
    to = tm.complete_occluded(tf, 1.45, 6.0, 0.08)
    np.testing.assert_array_equal(np.asarray(jo[2])[v], np_(to[2])[v])
    np.testing.assert_allclose(np.asarray(jo[0])[v], np_(to[0])[v], atol=1e-4)


@pytest.mark.parametrize("n_valid", [6, 7, 12])
def test_nanmedian_matches_jax(n_valid):
    """Even counts average the two middle values (torch.nanmedian would
    return the lower)."""
    rng = np.random.default_rng(n_valid)
    x = rng.random((4, 16)).astype(np.float32)
    x[:, n_valid:] = np.nan
    x[3] = np.nan
    np.testing.assert_array_equal(
        np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1)),
        np_(tm.nanmedian(torch.from_numpy(x), dim=-1)))


def test_fit_plane_robust_even_valid_count_matches_jax():
    """Even number of valid markers, with outliers, so the median of the
    absolute residuals is the mean of two middle values."""
    rng = np.random.default_rng(9)
    b, n = 3, 65
    xy = rng.uniform(-15, 15, (b, n, 2))
    z = 0.2 * xy[..., 0] - 0.1 * xy[..., 1] + 1.0 + rng.normal(0, 0.02, (b, n))
    z[:, :4] += 3.0                                     # gross outliers
    xyz = np.concatenate([xy, z[..., None]], -1).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[:, 60:] = False                                 # 60 valid: even
    mask[2, :] = False                                   # all-invalid frame
    jp = jfit.fit_plane_robust(jnp.asarray(xyz), jnp.asarray(mask))
    tp = tfit.fit_plane_robust(torch.from_numpy(xyz), torch.from_numpy(mask))
    # Float32 normal equations solved in another order: observed ~1e-6.
    for name in ("a", "b", "c", "tilt_deg"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)),
                                   np_(getattr(tp, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    jq = jfit.fit_plane(jnp.asarray(xyz), jnp.asarray(mask))
    tq = tfit.fit_plane(torch.from_numpy(xyz), torch.from_numpy(mask))
    np.testing.assert_allclose(np.asarray(jq.tilt_deg), np_(tq.tilt_deg),
                               rtol=1e-4, atol=1e-5)
