"""The filter front end's host side on the CPU (``ops/cuda/filters.py``).

The stencil kernels run only on the card (``tests/test_torch_cuda.py``
holds them bit for bit against the GEMM path there). Here: the tap tables
the kernels read are the band matrices the GEMM path multiplies, entry for
entry, and a CPU tensor takes the plain path (``to_grayscale`` ->
``dog_area_mask`` -> ``normxcorr_gaussian``), which the JAX package's
functions hold on the same frames."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.core.imaging import to_grayscale as jgray
from vision_basedsensor_tpu.ops.dog import dog_area_mask as jdog
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian as jncc

from vision_basedsensor_tpu_torch.config import DetectConfig
from vision_basedsensor_tpu_torch.core.imaging import (_band_matrix_np,
                                                       gaussian_taps,
                                                       to_grayscale)
from vision_basedsensor_tpu_torch.ops.cuda import filters as kf
from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian

_CFG = DetectConfig()
_LOW, _HIGH = _CFG.low_res, _CFG.high_res
_JCFG = jcfg.DetectConfig()
# The NCC's largest gap to JAX's on these frames is 7.8e-6 (the two
# frameworks' float32 matrix products sum in other orders); gray and the
# area mask are equal.
NCC_ATOL = 2e-5

# The filter pairs of the two profiles, as the kernels take them:
# (name, taps a, taps b, mode).
_PAIRS = [
    (f"{p}.{what}", a, b, mode)
    for p, prof in (("low", _LOW), ("high", _HIGH))
    for what, a, b, mode in (
        ("dog", gaussian_taps(prof.blur_small_ksize, prof.blur_small_sigma),
         gaussian_taps(prof.blur_large_ksize, prof.blur_large_sigma),
         "reflect101"),
        ("ncc", gaussian_taps(prof.template_size, prof.template_sigma),
         np.ones(prof.template_size), "zero"))]


@pytest.mark.parametrize("name,taps_a,taps_b,mode", _PAIRS,
                         ids=[p[0] for p in _PAIRS])
@pytest.mark.parametrize("n", ["1", "2", "3", "k-1", "k", "k+1", "437",
                               "480"])
def test_pass_table_expands_to_the_band_matrices(name, taps_a, taps_b, mode,
                                                 n):
    """Each filter's entries in the table, expanded back to a dense matrix,
    are ``_band_matrix_np`` exactly (the groups' windows cover every
    nonzero entry and stay inside the samples); the interior rows are those
    whose span is the whole window at ``i - (k - 1) // 2``, with the entries
    the kernels compile in."""
    k = len(taps_b)
    n = {"k-1": k - 1, "k": k, "k+1": k + 1}.get(n) or int(n)
    keys = [tuple(float(t) for t in taps) for taps in (taps_a, taps_b)]
    j0, dense, ia, ib, (lo, hi) = kf.pass_table(*keys, n, mode)
    g, L = dense.shape[:2]
    assert g == -(-n // 4) and dense.dtype == np.float32 and L <= n
    assert j0.dtype == np.int32 and (j0 >= 0).all() and (j0 <= n - L).all()
    for f, key in enumerate(keys):
        T = np.zeros((4 * g, n), np.float32)
        for q in range(g):
            rows = dense[q, :, 4 * f:4 * f + 4].T
            T[4 * q:4 * q + 4, j0[q]:j0[q] + L] = rows
        assert np.array_equal(T[:n], _band_matrix_np(key, n, mode)), f
        assert not T[n:].any()
    if n >= k:
        half = [(len(t) - 1) // 2 for t in keys]
        assert (lo, hi) == (max(half), n - k // 2)
        for f, (key, taps) in enumerate(zip(keys, (ia, ib))):
            B = _band_matrix_np(key, n, mode)
            assert np.array_equal(taps, B[half[f], :len(key)])
            for i in range(lo, hi):
                assert np.array_equal(B[i, i - half[f]:i - half[f] + len(key)],
                                      taps)
                assert np.count_nonzero(B[i]) == np.count_nonzero(taps)
    else:
        assert lo == hi == 0


def _frames(b, h, w, seed, color=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((b, h, w), 150.0)
    for i in range(b):
        for _ in range(6):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
            img[i] -= 110 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                   / (2 * r * r))
    img = np.clip(img + rng.normal(0, 5, img.shape), 0, 255).round()
    if color:
        img = np.stack([img, np.roll(img, 1, -1), img[..., ::-1]], -1)
    return torch.from_numpy(img.astype(np.uint8))


def _plain(frames, prof, compute_dtype=None):
    """The plain path, composed of the functions the kernels replace."""
    gray = to_grayscale(frames).contiguous()
    area = dog_area_mask(gray, prof, 15, compute_dtype).float()
    return gray, area, normxcorr_gaussian(
        area, prof.template_size, prof.template_sigma, binary_input=True,
        compute_dtype=compute_dtype)


def _jax(frames, jprof, compute_dtype=None, area=None):
    """JAX's gray and area mask of ``frames``, and its NCC of ``area``
    (default: of its own mask), as float32 numpy."""
    gray = jgray(jnp.asarray(np_(frames)))
    mask = np.asarray(jdog(gray, jprof, 15, compute_dtype=compute_dtype),
                      np.float32)
    area = mask if area is None else np_(area)
    ncc = jncc(jnp.asarray(area), jprof.template_size, jprof.template_sigma,
               binary_input=True, compute_dtype=compute_dtype)
    return (np.asarray(gray, np.float32), mask, np.asarray(ncc, np.float32))


@pytest.mark.parametrize("case", ["low_res", "high_res", "odd", "color",
                                  "float", "bf16"])
def test_plain_path_on_the_cpu_matches_jax(case):
    """On a CPU tensor ``filter_fields`` is the plain path, bit for bit,
    and launches nothing; its gray and area mask are JAX's, its NCC JAX's
    within ``NCC_ATOL``."""
    high = case == "high_res"
    prof, jprof = ((_HIGH, _JCFG.high_res) if high
                   else (_LOW, _JCFG.low_res))
    hw = {"high_res": (96, 112), "odd": (43, 47)}.get(case, (48, 64))
    frames = _frames(2, *hw, seed=3, color=case == "color")
    if case == "float":
        frames = frames.float() + 0.25
    fdt, jdt = ((torch.bfloat16, jnp.bfloat16) if case == "bf16"
                else (None, None))
    before = kf.filters_launches
    got = kf.filter_fields(frames, prof, 15, "bgr", fdt)
    assert kf.filters_launches == before
    for name, g, w in zip(("gray", "area", "ncc"), got,
                          _plain(frames, prof, fdt)):
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        assert torch.equal(g, w), name
    gray, area, ncc = _jax(frames, jprof, jdt)
    np.testing.assert_array_equal(np_(got[0]), gray)
    np.testing.assert_array_equal(np_(got[1]), area)
    np.testing.assert_allclose(np_(got[2]), ncc, rtol=0, atol=NCC_ATOL)
    assert 0.0 < float(got[1].mean()) < 1.0
    assert float(got[2].max()) > 0.5


def test_plain_path_row_shard_mean():
    """A row shard on the CPU, as ``parallel/spatial.py`` runs it: rows
    24-87 of 112-row frames. ``dog_fields`` gives JAX's whole-frame gray
    and, where the large blur stays inside the block, its area mask;
    ``binary_ncc`` of the frame's mask rows with the frame's mean
    (``mean=``) gives JAX's whole-frame NCC where the template stays inside
    the block."""
    frames = _frames(2, 112, 80, seed=5)
    jprof = _JCFG.low_res
    gray, area, ncc = _jax(frames, jprof)
    top, rows = 24, 64
    block = frames[:, top:top + rows]
    bgray, barea, count = kf.dog_fields(block, _LOW, 15)
    assert count is None
    np.testing.assert_array_equal(np_(bgray), gray[:, top:top + rows])
    half = _LOW.blur_large_ksize // 2
    np.testing.assert_array_equal(np_(barea)[:, half:rows - half],
                                  area[:, top + half:top + rows - half])
    mean = torch.from_numpy(area.mean((-2, -1), keepdims=True))
    got = kf.binary_ncc(torch.from_numpy(area[:, top:top + rows]), _LOW,
                        mean=mean)
    half = _LOW.template_size // 2
    np.testing.assert_allclose(np_(got)[:, half:rows - half],
                               ncc[:, top + half:top + rows - half], rtol=0,
                               atol=NCC_ATOL)
    assert 0.0 < float(area.mean()) < 1.0


def test_detect_on_the_cpu_takes_the_plain_path():
    """``detect_markers`` on CPU frames launches no filter kernel, for a
    batch, one 2-D frame and color frames."""
    from vision_basedsensor_tpu_torch.detect.detector import detect_markers
    cfg = dataclasses.replace(DetectConfig(), max_candidates=8)
    frames = _frames(2, 48, 64, seed=9)
    before = kf.filters_launches
    batch = detect_markers(frames, cfg)
    one = detect_markers(frames[1], cfg)
    color = detect_markers(_frames(2, 48, 64, seed=9, color=True), cfg)
    assert kf.filters_launches == before
    assert batch.xy.shape == (2, 8, 2) and one.xy.shape == (8, 2)
    assert color.xy.shape == (2, 8, 2)
    for name in ("xy", "valid", "score"):
        assert torch.equal(getattr(batch, name)[1], getattr(one, name)), name
