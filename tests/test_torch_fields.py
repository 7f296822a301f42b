"""Fused field kernel of the PyTorch port vs the JAX Pallas kernels.

The port's plain version (``ops/cuda/fields.py:fused_fields_reference``,
what a CPU tensor takes) must equal the Pallas kernels run in interpret mode
bit for bit: ``packed``, ``cval`` and ``cidx``, for both profiles, for the
row-tiled variant's semantics, and on plateau ties. On a card the CUDA
kernel is checked against the plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from torch_parity import np_, render_jax, staircase, to_torch

from vision_basedsensor_tpu.config import DetectConfig
from vision_basedsensor_tpu.core.imaging import to_grayscale
from vision_basedsensor_tpu.ops.dog import dog_area_mask
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian
from vision_basedsensor_tpu.ops.pallas.fields import (_fused_fields_tiled,
                                                      fused_fields)

from vision_basedsensor_tpu_torch.config import DetectConfig as TDetectConfig
from vision_basedsensor_tpu_torch.ops.cuda import fields as tfields


def _rendered_fields(h, w, prof):
    cfg = DetectConfig()
    frames, _ = render_jax(h, w, staircase(2, 0.6))
    gray = to_grayscale(jnp.asarray(frames))
    area = dog_area_mask(gray, prof, cfg.dog_offset)
    ncc = normxcorr_gaussian(area.astype(jnp.float32), prof.template_size,
                             prof.template_sigma, binary_input=True)
    return (np.asarray(ncc, np.float32), np.asarray(area, np.float32),
            np.asarray(gray, np.float32))


def _random_fields(rng, b, h, w):
    # Heavy quantization -> many exact ties within and across cells.
    ncc = (np.round(rng.random((b, h, w)) * 8.0) / 8.0).astype(np.float32)
    area = (rng.random((b, h, w)) > 0.6).astype(np.float32)
    gray = rng.integers(0, 256, (b, h, w)).astype(np.float32)
    return ncc, area, gray


def _port(ncc, area, gray, prof):
    cfg = TDetectConfig()
    return tfields.fused_fields(to_torch(ncc), to_torch(area), to_torch(gray),
                                cfg.ncc_threshold, cfg.open_ksize, prof)


def _assert_exact(jax_out, port_out):
    for a, b, name in zip(jax_out, port_out, ("packed", "cval", "cidx")):
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=name)


@pytest.mark.parametrize("profile", ["low_res", "high_res"])
def test_plain_fields_match_pallas_rendered(profile):
    """Both built-in profiles (band 8/14, peak 9/15) on rendered frames."""
    cfg = DetectConfig()
    prof = getattr(cfg, profile)
    ncc, area, gray = _rendered_fields(240, 384, prof)
    jax_out = fused_fields(jnp.asarray(ncc), jnp.asarray(area),
                           jnp.asarray(gray), cfg.ncc_threshold,
                           cfg.open_ksize, prof, interpret=True)
    _assert_exact(jax_out, _port(ncc, area, gray,
                                 getattr(TDetectConfig(), profile)))


def test_plain_fields_match_pallas_tiled_semantics():
    """The row-tiled kernel (K2, 1080p class) at a small shape: rows=64
    forces its H-padding path, whose padded rows must not leak."""
    cfg = DetectConfig()
    prof = cfg.high_res
    ncc, area, gray = _random_fields(np.random.default_rng(11), 2, 240, 384)
    jax_out = _fused_fields_tiled(jnp.asarray(ncc), jnp.asarray(area),
                                  jnp.asarray(gray), cfg.ncc_threshold,
                                  cfg.open_ksize, prof, interpret=True,
                                  rows=64)
    _assert_exact(jax_out, _port(ncc, area, gray, TDetectConfig().high_res))


def test_plain_fields_plateau_ties():
    """Quantized random scores make exact plateaus: the per-cell argmax
    must pick the same (row-major first) pixel."""
    cfg = DetectConfig()
    prof = cfg.low_res
    ncc, area, gray = _random_fields(np.random.default_rng(7), 3, 240, 384)
    jax_out = fused_fields(jnp.asarray(ncc), jnp.asarray(area),
                           jnp.asarray(gray), cfg.ncc_threshold,
                           cfg.open_ksize, prof, interpret=True)
    _assert_exact(jax_out, _port(ncc, area, gray, TDetectConfig().low_res))


def test_plain_fields_unaligned_shape_matches_xla_ops():
    """Shapes the Pallas kernels refuse (H % 8, W % 128): the port's ragged
    cells must match find_peaks' -inf padding and the XLA morphology."""
    from vision_basedsensor_tpu.core.imaging import min_filter, morph_open
    from vision_basedsensor_tpu.ops.peaks import find_peaks

    cfg = DetectConfig()
    prof = cfg.low_res
    ncc, area, gray = _random_fields(np.random.default_rng(3), 1, 61, 77)
    packed, cval, cidx = _port(ncc, area, gray, TDetectConfig().low_res)
    jn = jnp.asarray(ncc)
    m = (jn > cfg.ncc_threshold).astype(jnp.float32)
    band = m * (min_filter(m, prof.band_window) < 0.5)
    opened = morph_open(jnp.asarray(area), cfg.open_ksize)
    np.testing.assert_array_equal(
        np_(packed), np.asarray(jnp.asarray(gray) + 256.0 * band
                                + 512.0 * opened))
    assert cval.shape == (1, 8, 10)
    k = 8 * 10
    jp = find_peaks(jn, cfg.ncc_threshold, prof.peak_window, k, 0.0)
    order = np.argsort(-np_(cval).reshape(-1), kind="stable")
    flat = np_(cidx).reshape(-1)[order]
    fin = np.isfinite(np_(cval).reshape(-1)[order])
    np.testing.assert_array_equal(fin, np.asarray(jp.valid)[0])
    np.testing.assert_array_equal(flat[fin] % 77, np.asarray(jp.xy)[0, fin, 0])
    np.testing.assert_array_equal(flat[fin] // 77, np.asarray(jp.xy)[0, fin, 1])


def test_cpu_dispatch_does_not_launch():
    before = tfields.fields_launches
    ncc, area, gray = _random_fields(np.random.default_rng(5), 1, 32, 48)
    _port(ncc, area, gray, TDetectConfig().low_res)
    assert tfields.fields_launches == before
