"""The port's library extras against the JAX package on the CPU:
analysis/dynamics.py (moving_average, contact_signal), core/fit.py
ellipse_from_moments, core/imaging.py box_sum, ops/ncc.py
normxcorr_gaussian(binary_input=False), and utils/profiling.py
(trace_annotation, profile_to).

Inputs are seeded numpy arrays, the same for both packages. Float32
results agree to a few ulps of their magnitude (the sums and filter matmuls
run in another order), so the tolerances below are stated per function.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_, to_jax, to_torch

from vision_basedsensor_tpu.analysis import dynamics as jdyn
from vision_basedsensor_tpu.config import ReconstructConfig as JReconCfg
from vision_basedsensor_tpu.core.fit import ellipse_from_moments as jellipse
from vision_basedsensor_tpu.core.imaging import box_sum as jbox
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian as jncc
from vision_basedsensor_tpu.reconstruct import displacement_scan as jscan

from vision_basedsensor_tpu_torch.analysis import dynamics as tdyn
from vision_basedsensor_tpu_torch.config import ReconstructConfig
from vision_basedsensor_tpu_torch.core.fit import ellipse_from_moments
from vision_basedsensor_tpu_torch.core.imaging import box_sum
from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
from vision_basedsensor_tpu_torch.reconstruct.displacement import \
    displacement_scan
from vision_basedsensor_tpu_torch.utils import trace_annotation
from vision_basedsensor_tpu_torch.utils.profiling import profile_to


@pytest.mark.parametrize("window", [1, 2, 4, 15])
@pytest.mark.parametrize("n", [200, 9])
def test_moving_average_matches_jax(window, n):
    """Even windows are where the backward pass's renormalization shows
    (den, not den reversed); a window longer than the signal gives a longer
    output, as numpy's 'same' convolution does."""
    rng = np.random.default_rng(window)
    x = (np.sin(np.arange(n) / 15.0) + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    got = np_(tdyn.moving_average(to_torch(x), window))
    want = np.asarray(jdyn.moving_average(to_jax(x), window))
    assert got.shape == want.shape == (max(n, window),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def recon_pair():
    """One reconstruction through both packages' displacement scans: a ramp
    to a -9.8 mm Z plateau with dropouts (tests/test_dynamics.py:25-44)."""
    rng = np.random.default_rng(0)
    b = 120
    z = np.concatenate([np.linspace(0, -9.8, 40), np.full(b - 40, -9.8)])
    world = np.zeros((b, 65, 3), np.float32)
    world[:, :, 2] = z[:, None] + rng.normal(0, 0.05, (b, 65))
    world[:, :, :2] = rng.normal(0, 0.02, (b, 65, 2))
    seen = rng.random((b, 65)) > 0.15
    seen[0] = True
    jr = jscan(jnp.asarray(world), jnp.asarray(seen),
               JReconCfg(warmup_frames=0))
    tr = displacement_scan(torch.from_numpy(world), torch.from_numpy(seen),
                           ReconstructConfig(warmup_frames=0))
    return jr, tr


@pytest.mark.parametrize("component,window", [("z", 15), ("norm", 8)])
def test_contact_signal_matches_jax(recon_pair, component, window):
    jr, tr = recon_pair
    want = jdyn.contact_signal(jr, component, window)
    got = tdyn.contact_signal(tr, component, window)
    for name in ("raw", "filtered", "force_n"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(np_(got.num_tracked),
                                  np.asarray(want.num_tracked))
    assert tdyn.DEFAULT_STIFFNESS_N_PER_MM == jdyn.DEFAULT_STIFFNESS_N_PER_MM
    if component == "z":   # the reference's plateau: ~-9.8 mm, ~-3.8 N
        np.testing.assert_allclose(np_(got.filtered)[60:].mean(), -9.8,
                                   atol=0.15)


def test_ellipse_from_moments_matches_jax():
    """Filled ellipses of known axes and angles (one degenerate, all-zero
    weights), plus noisy weights, on (2, 3, N) pixel sets."""
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[0:41, 0:41].astype(np.float32)
    x, y = xs.ravel(), ys.ravel()
    w = np.zeros((2, 3, x.size), np.float32)
    for i, (a, b, th) in enumerate([(14, 6, 0.3), (9, 9, 0.0), (16, 4, 2.6),
                                    (12, 7, -1.2), (5, 3, 1.4)]):
        c, s = np.cos(th), np.sin(th)
        u = (x - 20.3) * c + (y - 19.6) * s
        v = -(x - 20.3) * s + (y - 19.6) * c
        w.reshape(6, -1)[i] = ((u / a) ** 2 + (v / b) ** 2 <= 1.0)
    w[1, 2] = 0.0   # degenerate: total clamped to 1e-12
    w[1, 1] += rng.uniform(0, 0.05, w[1, 1].shape).astype(np.float32)
    got = ellipse_from_moments(*map(to_torch, (w, x, y)))
    want = jellipse(*map(to_jax, (w, x, y)))
    for name in ("center", "major", "minor", "area"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    # Angles where the axes differ (a circle's angle is ill-conditioned).
    ga, wa = np_(got.angle_deg), np.asarray(want.angle_deg)
    distinct = np.asarray(want.major) - np.asarray(want.minor) > 0.5
    d = np.abs(ga - wa)
    np.testing.assert_array_less(np.minimum(d, 180.0 - d)[distinct], 1e-3)
    assert ((ga >= 0) & (ga < 180)).all()
    # A filled ellipse of semi-axes (14, 6): full axes 28 and 12.
    np.testing.assert_allclose(np_(got.major)[0, 0], 28.0, atol=0.5)
    np.testing.assert_allclose(np_(got.minor)[0, 0], 12.0, atol=0.5)


@pytest.mark.parametrize("ksize", [5, 8])
def test_box_sum_matches_jax(ksize):
    x = np.random.default_rng(ksize).uniform(0, 255, (2, 37, 53)).astype(
        np.float32)
    got = np_(box_sum(to_torch(x), ksize))
    want = np.asarray(jbox(to_jax(x), ksize))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-2)
    # An interior window is the plain sum of its pixels.
    lo = ksize // 2 - (ksize % 2 == 0)
    np.testing.assert_allclose(got[0, 20, 20],
                               x[0, 20 - lo:20 - lo + ksize,
                                 20 - lo:20 - lo + ksize].sum(), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normxcorr_continuous_input_matches_jax(dtype):
    """binary_input=False: six filter passes on a continuous image
    (dark disks on a gray field, plus noise), with a small min_variance."""
    rng = np.random.default_rng(4)
    ys, xs = np.mgrid[0:48, 0:64]
    img = np.full((2, 48, 64), 190.0)
    for _ in range(8):
        cy, cx = rng.uniform(5, 43), rng.uniform(5, 59)
        img[:, (ys - cy) ** 2 + (xs - cx) ** 2 < 16] = 40.0
    img = (img + rng.normal(0, 4, img.shape)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    want = np.asarray(jncc(to_jax(img), 9, 2.0, min_variance=1e-3,
                           binary_input=False, compute_dtype=jdt))
    got = np_(normxcorr_gaussian(to_torch(img), 9, 2.0, min_variance=1e-3,
                                 binary_input=False, compute_dtype=tdt))
    assert np.abs(want).max() > 0.5
    # In bfloat16 the local variance box(m^2) - box(m)^2 / n cancels, so a
    # one-ulp difference in a rounded filter output (the float32 sums run
    # in another order) moves a score by up to about two bfloat16 epsilons
    # (2 x 2^-8): measured 0.0061 on 14 of 6,144 pixels.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 if dtype == "float32" else 2 ** -7)


def test_trace_annotation_and_profile_to(tmp_path):
    x = torch.ones(64, 64)
    # No profiler running: one shared null context, whatever the name.
    assert trace_annotation("vbs.detect") is trace_annotation("vbs.contact")
    with pytest.raises(ValueError, match="inside"):
        with trace_annotation("vbs.detect"):
            raise ValueError("raised inside the span")   # not swallowed
    with profile_to(str(tmp_path), device="cpu"):
        with trace_annotation("vbs.detect"):
            (x @ x).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "vbs.detect" in names
