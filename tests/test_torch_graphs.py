"""The CUDA-graph helper (``vision_basedsensor_tpu_torch/utils/graphs.py``)
and the sync-free edits under it, on the CPU: CPU calls run eagerly and are
counted; the signature tells shapes, dtypes, strides and config values
apart; the plane fit's ``solve_ex`` gives ``torch.linalg.solve``'s bits;
the start points' cache gives the layout table. The card's side (capture,
replay, bit equality, eviction) is ``tests/test_torch_graphs_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from vision_basedsensor_tpu_torch import layout
from vision_basedsensor_tpu_torch.analysis import force
from vision_basedsensor_tpu_torch.config import (AnalysisConfig, DetectConfig,
                                                 ReconstructConfig)
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.fit import masked_lstsq
from vision_basedsensor_tpu_torch.ops.peaks import Peaks
from vision_basedsensor_tpu_torch.reconstruct.displacement import \
    Reconstruction
from vision_basedsensor_tpu_torch.utils import graphs


def _recon(batch=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)
    seen = torch.rand(batch, 65, generator=g) > 0.3
    return Reconstruction(world=f(batch, 65, 3), seen=seen,
                          step=f(batch, 65, 3), step_norm=f(batch, 65).abs(),
                          step_valid=seen, cum_path=f(batch, 65).abs(),
                          from_first=f(batch, 65, 3),
                          from_first_norm=f(batch, 65).abs())


def test_cpu_calls_run_eagerly_and_are_counted():
    """On the CPU ``replay`` calls the function itself with the caller's
    own arguments, every time, and counts each call ``eager``; the three
    chains count under their stages."""
    from vision_basedsensor_tpu_torch.reconstruct.depth import \
        reconstruct_positions

    seen = []

    def fn(a, cfg, b=None):
        seen.append((a, cfg, b))
        return a * 2

    graphs.reset_graph_counts()
    x = torch.arange(4.0)
    for _ in range(3):
        assert torch.equal(graphs.replay("test.cpu", fn, x, 1.5), x * 2)
    assert all(a is x and c == 1.5 and b is None for a, c, b in seen)
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device="cpu")
    uv = torch.rand(3, 65, 2) * 400
    axes = torch.full((3, 65, 2), 20.0)
    for _ in range(2):
        reconstruct_positions(cam, uv, axes, torch.ones(3, 65, dtype=bool),
                              ReconstructConfig())
        force.contact_state_sequence(_recon(), AnalysisConfig())
    counts = graphs.graph_counts()
    assert counts["test.cpu"] == {"captures": 0, "replays": 0, "eager": 3}
    for stage in ("reconstruct.positions", "contact"):
        assert counts[stage] == {"captures": 0, "replays": 0, "eager": 2}
    graphs.reset_graph_counts()
    assert graphs.graph_counts()["test.cpu"]["eager"] == 0


def _solve(A, b, mask):
    """The plane fit's normal equations as the parent solved them."""
    m = mask.to(A.dtype)[..., None]
    Am = A * m
    AtA = torch.einsum("...np,...nq->...pq", Am, A)
    Atb = torch.einsum("...np,...n->...p", Am, b)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-9 * eye, Atb[..., None])[..., 0]


@pytest.mark.parametrize("case", ["batched", "masked", "weights", "all_false",
                                  "float64"])
def test_masked_lstsq_equals_solve(case):
    """``solve_ex`` without its error check is ``solve``'s LU: the same bits
    on batched, masked, weighted and all-False-mask systems (the last one
    only the Tikhonov term, and it must not raise)."""
    g = torch.Generator().manual_seed(7)
    dtype = torch.float64 if case == "float64" else torch.float32
    A = torch.randn(48, 65, 3, generator=g, dtype=dtype)
    A[..., 2] = 1.0
    b = torch.randn(48, 65, generator=g, dtype=dtype)
    mask = {"masked": torch.rand(48, 65, generator=g) > 0.4,
            "weights": torch.rand(48, 65, generator=g, dtype=dtype),
            "all_false": torch.zeros(48, 65, dtype=torch.bool)
            }.get(case, torch.ones(48, 65, dtype=torch.bool))
    got = masked_lstsq(A, b, mask)
    assert torch.equal(got, _solve(A, b, mask))
    if case == "all_false":
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("mode", ["plane", "shell"])
def test_start_points_cache_holds_the_table(mode):
    """The cached start points are the layout table (Z = 0 in ``plane``
    mode) in the caller's dtype, one tensor a (device, dtype, mode), and a
    caller's arithmetic on them leaves the next call's values alone."""
    table = torch.as_tensor(layout.dome_layout()[:, 1:], dtype=torch.float32)
    if mode == "plane":
        table[:, 2] = 0.0
    like = torch.zeros(2, 65, 3)
    start = force._start_points(like, mode)
    assert torch.equal(start, table)
    moved = start + 1.0
    moved *= 3.0
    again = force._start_points(like, mode)
    assert again is start and torch.equal(again, table)
    f64 = force._start_points(like.double(), mode)
    assert f64.dtype == torch.float64
    np.testing.assert_array_equal(
        f64.numpy()[:, :2], layout.dome_layout()[:, 1:3])


def _args(batch=4, k=96, dtype=torch.float32, cfg=None, contiguous=True):
    sums = torch.zeros(batch, k, 28, dtype=dtype)
    xy = torch.zeros(batch, k, 2, dtype=dtype)
    if not contiguous:
        xy = torch.zeros(batch, 2, k, dtype=dtype).transpose(1, 2)
    peaks = Peaks(xy=xy, score=torch.zeros(batch, k, dtype=dtype),
                  valid=torch.zeros(batch, k, dtype=torch.bool))
    return (sums, peaks, cfg or DetectConfig(), None)


@pytest.mark.parametrize("other", [
    "batch", "candidates", "dtype", "stride", "config", "axis_scale", "stage"])
def test_signature_separates_inputs(other):
    """Equal layouts and values share a key whatever the tensors hold; a
    batch size, a K, a dtype, a stride, a config value, a non-tensor
    argument or the stage each give a key of its own."""
    base = graphs.signature("detect.finalize", _args())
    assert graphs.signature("detect.finalize", _args()) == base
    stage, args = "detect.finalize", {
        "batch": _args(batch=5),
        "candidates": _args(k=97),
        "dtype": _args(dtype=torch.float64),
        "stride": _args(contiguous=False),
        "config": _args(cfg=dataclasses.replace(DetectConfig(),
                                                min_minor_axis_px=4.0)),
        "axis_scale": _args()[:3] + (1.0,),
        "stage": _args()}[other]
    if other == "stage":
        stage = "contact"
    assert graphs.signature(stage, args) != base


def test_flatten_rebuilds_named_tuples():
    """The flattened inputs come back as the same named tuples, lists and
    constants, the tensors in order."""
    cam = CameraModel.create(500.0, 510.0, 320.0, 240.0, device="cpu")
    args = (cam, [torch.ones(2), None], Peaks(*torch.zeros(3, 2)), "plane")
    leaves: list = []
    spec = graphs._spec(args, leaves)
    assert len(leaves) == len(cam) + 1 + 3
    back = graphs._build(spec, iter(leaves))
    assert type(back[0]) is CameraModel and type(back[2]) is Peaks
    assert back[1][1] is None and back[3] == "plane"
    assert all(a is b for a, b in zip(back[0], cam))
