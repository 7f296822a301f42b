"""The library extras on the card (``core/fit.py:ellipse_from_moments``,
``core/imaging.py:box_sum``, ``ops/ncc.py:normxcorr_gaussian`` on
continuous input, ``analysis/dynamics.py:contact_signal``) against the same
calls on the CPU, each within its stated tolerance and with no kernel
launched.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import counted, cuda, render_drift  # noqa: F401

from vision_basedsensor_tpu_torch.config import DetectConfig

pytestmark = pytest.mark.cuda_only

# A lens with barrel distortion (tests/test_undistort.py:88): a second
# input for the continuous NCC.
DIST = (-0.18, 0.05, 0.0, 0.0, 0.0)


def _extras(frames, frames_dist, recon):
    """name -> (function of a device, (rtol, atol))."""
    from vision_basedsensor_tpu_torch.analysis.dynamics import contact_signal
    from vision_basedsensor_tpu_torch.core.fit import ellipse_from_moments
    from vision_basedsensor_tpu_torch.core.imaging import box_sum
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    from vision_basedsensor_tpu_torch.pipeline import _to

    b, h, w = frames.shape
    ys, xs = torch.meshgrid(torch.arange(float(h), device=frames.device),
                            torch.arange(float(w), device=frames.device),
                            indexing="ij")
    # Dark marker pixels as weights over each frame's pixels.
    wts = ((frames < 115).float().reshape(b, -1), xs.reshape(-1),
           ys.reshape(-1))
    prof = DetectConfig().low_res

    def ncc(x):
        return lambda d: normxcorr_gaussian(x.to(d), prof.template_size,
                                            prof.template_sigma,
                                            binary_input=False)

    # The continuous NCC's local variance box(m^2) - box(m)^2 / n cancels:
    # box(m^2) reaches ~1e6 on 0..255 frames, so float32 filter sums in
    # another order (cuBLAS, the CPU's GEMM) move var_n by ~0.1 and a score
    # by up to ~0.1 / (2 var_n) above the 0.5 floor. The reference holds
    # this path to its FFT oracle within 2e-3 on 0/1 masks
    # (tests/test_ops.py:29-39).
    return {
        "ellipse_from_moments": (lambda d: ellipse_from_moments(
            *(t.to(d) for t in wts)), (1e-4, 1e-3)),
        "box_sum": (lambda d: box_sum(frames.to(d), 9), (1e-5, 1e-2)),
        "normxcorr_gaussian": (ncc(frames), (0.0, 1e-2)),
        "normxcorr_gaussian-distorted": (ncc(frames_dist), (0.0, 1e-2)),
        "contact_signal": (lambda d: contact_signal(_to(recon, d)),
                           (1e-5, 1e-5)),
    }


@pytest.fixture(scope="module")
def extras(cuda):
    """The extras' calls on 640x480 frames with a z drift, on the same
    frames through a distorted camera, and on their reconstruction."""
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     ReconstructConfig)
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)

    scene, frames = render_drift(cuda, 480, 640, 16)
    _, frames_dist = render_drift(cuda, 480, 640, 16, dist=np.asarray(DIST))
    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    recon = process_frames(frames, initialize(frames[0], cfg), scene.cam,
                           cfg).recon
    return _extras(frames, frames_dist, recon)


@pytest.mark.parametrize("name", ["ellipse_from_moments", "box_sum",
                                  "normxcorr_gaussian",
                                  "normxcorr_gaussian-distorted",
                                  "contact_signal"])
def test_extras_on_the_card_match_the_cpu(cuda, extras, name):
    fn, (rtol, atol) = extras[name]
    got, launches = counted(lambda: fn(cuda))
    assert launches == {}
    want = fn(torch.device("cpu"))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, w in zip(got, want, strict=True):
        a, w = a.cpu().double(), w.double()
        assert bool(((a - w).abs() <= atol + rtol * w.abs()).all())
