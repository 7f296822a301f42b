"""``DetectConfig(fast_filters=True)`` in the port against the JAX package's
fast path, on the CPU: the DoG and NCC filter matmuls with bfloat16
operands, float32 accumulation, the H pass rounded back to bfloat16 and the
W pass giving float32 (``vision_basedsensor_tpu/core/imaging.py:112-125``).

On the CPU the port multiplies the bfloat16-rounded operands in float32 (a
product of two bfloat16 values is exact in float32); the sums run in
another order than XLA's, so a last-bit difference before the H pass's
rounding can become a whole bfloat16 step. Bounds, from the observed
agreement: DoG mask pixels differing from JAX's at most 4 (observed 0 of
4 x 240 x 384 and of 480 x 640), the NCC within 1e-4 (observed 3e-6),
matched detections within 0.01 px, the reference's own tolerance for the
flag (``tests/test_detect.py:144-155``; observed 3e-5 px).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_, render_jax, staircase, to_jax, to_torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.detect.detector import detect_markers as jdetect
from vision_basedsensor_tpu.ops.dog import dog_area_mask as jdog
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian as jncc

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch.core.imaging import (_band_matrix_np,
                                                       _sep_filter)
from vision_basedsensor_tpu_torch.detect.detector import \
    detect_markers as tdetect
from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask as tdog
from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian as tncc


@pytest.fixture(scope="module")
def small():
    frames, _ = render_jax(240, 384, staircase(4, 0.3))
    return frames


@pytest.fixture(scope="module")
def rest():
    frames, _ = render_jax(480, 640, staircase(1))
    return frames


def _configs(backend, fast=True):
    jc = jcfg.DetectConfig(backend=backend, fast_filters=fast)
    return jc, convert.config_from_jax(jcfg.PipelineConfig(detect=jc)).detect


def _matched(a_xy, a_valid, b_xy, b_valid):
    """Per frame: the two valid counts and the largest distance from a
    detection of ``a`` to its nearest in ``b`` (distinct nearest)."""
    out = []
    for b in range(a_xy.shape[0]):
        pa, pb = a_xy[b][a_valid[b]], b_xy[b][b_valid[b]]
        d = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
        assert len(set(d.argmin(1).tolist())) == len(pa)
        out.append((len(pa), len(pb), float(d.min(1).max())))
    return out


@pytest.mark.parametrize("case", ["240x384 fused", "480x640 unfused"])
def test_fast_filters_detections_match_jax(small, rest, case):
    """240x384 staircase frames on the fused branch (the JAX side's Pallas
    kernels in interpret mode); the 480x640 rest frame on the unfused
    branch."""
    frames, backend = ((small, "pallas") if case.startswith("240")
                       else (rest, "xla"))
    jc, tc = _configs(backend)
    jd = jdetect(to_jax(frames), jc)
    td = tdetect(to_torch(frames), tc)
    for n_j, n_t, dmax in _matched(np.asarray(jd.xy), np.asarray(jd.valid),
                                   np_(td.xy), np_(td.valid)):
        assert n_j == n_t >= 60
        assert dmax < 0.01


def test_fast_filters_rest_frame_matches_the_float32_path(rest):
    """The reference's test of the flag on the port: at 480x640 all 65
    markers, matched to the float32 path's within 0.01 px."""
    _, fast = _configs("pallas")
    _, f32 = _configs("pallas", fast=False)
    d16 = tdetect(to_torch(rest), fast)
    d32 = tdetect(to_torch(rest), f32)
    (n32, n16, dmax), = _matched(np_(d32.xy), np_(d32.valid), np_(d16.xy),
                                 np_(d16.valid))
    assert n32 == n16 == 65
    assert dmax < 0.01


@pytest.mark.parametrize("case", ["240x384", "480x640"])
def test_fast_filters_dog_mask_and_ncc_match_jax(small, rest, case):
    frames = small if case == "240x384" else rest
    jc, tc = _configs("pallas")
    mj = np.asarray(jdog(jnp.asarray(frames), jc.low_res, 15,
                         compute_dtype=jnp.bfloat16))
    mt = np_(tdog(to_torch(frames), tc.low_res, 15, torch.bfloat16))
    assert (mj != mt).sum() <= 4
    prof = tc.low_res
    area = mj.astype(np.float32)
    nj = np.asarray(jncc(jnp.asarray(area), prof.template_size,
                         prof.template_sigma, binary_input=True,
                         compute_dtype=jnp.bfloat16))
    nt = np_(tncc(torch.from_numpy(area), prof.template_size,
                  prof.template_sigma, binary_input=True,
                  compute_dtype=torch.bfloat16))
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-4)


def _bf16(x):
    return torch.as_tensor(x, dtype=torch.float32).bfloat16().double()


def test_sep_filter_bf16_rounds_where_the_reference_rounds():
    """The H pass's output is bfloat16 (accumulated in float32, rounded
    once); the W pass multiplies bfloat16 operands and gives float32; with
    both passes, the W pass runs on the H pass's bfloat16 output."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-40.0, 255.0, (3, 20, 28)).astype(np.float32)
    taps = np.array([0.1, 0.23, 0.33, 0.23, 0.11])
    t = torch.from_numpy(x)
    Th = _bf16(_band_matrix_np(tuple(taps), 20, "reflect101"))
    Tw = _bf16(_band_matrix_np(tuple(taps), 28, "reflect101"))

    h = _sep_filter(t, taps, None, "reflect101", torch.bfloat16)
    assert h.dtype == torch.float32
    assert torch.equal(h, h.bfloat16().float())
    want_h = (Th @ _bf16(x)).float().bfloat16().float()
    # float32 accumulation in another order than the float64 reference:
    # one bfloat16 step at most.
    step = torch.abs(want_h) * 2.0 ** -7
    assert bool((torch.abs(h - want_h) <= step).all())

    wo = _sep_filter(t, None, taps, "reflect101", torch.bfloat16)
    assert wo.dtype == torch.float32
    np.testing.assert_allclose(wo.numpy(), (_bf16(x) @ Tw.T).numpy(),
                               rtol=1e-6, atol=1e-4)
    assert not torch.equal(wo, wo.bfloat16().float())

    both = _sep_filter(t, taps, taps, "reflect101", torch.bfloat16)
    np.testing.assert_allclose(both.numpy(), (h.double() @ Tw.T).numpy(),
                               rtol=1e-6, atol=1e-4)
    # The float32 path is untouched by the flag's code.
    assert torch.equal(_sep_filter(t, taps, taps, "reflect101"),
                       _sep_filter(t, taps, taps, "reflect101",
                                   torch.float32))

