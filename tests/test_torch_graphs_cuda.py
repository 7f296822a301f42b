"""The three launch-bound chains as CUDA graphs on the card
(``vision_basedsensor_tpu_torch/utils/graphs.py``: detect's finalize,
reconstruct's positions, contact state's fit): the graphed main path equals
the eager one bit for bit at the benchmark cells' shapes, each call's
outputs stay its own, the counters show one capture and a replay a call, a
capture survives the profiler and another thread's CUDA work, and each
stage's cache keeps a bounded number of signatures.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``):

    python -m pytest --noconftest -m cuda_only tests/test_torch_graphs_cuda.py
"""
import contextlib
import threading

import pytest
import torch

from torch_parity import (_main_config, assert_same_outputs, cuda,  # noqa: F401
                          leaves, render_drift)

from vision_basedsensor_tpu_torch.analysis import force
from vision_basedsensor_tpu_torch.config import (AnalysisConfig,
                                                 ReconstructConfig)
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.detect import detector
from vision_basedsensor_tpu_torch.pipeline import initialize, process_frames
from vision_basedsensor_tpu_torch.reconstruct import depth
from vision_basedsensor_tpu_torch.reconstruct.displacement import \
    Reconstruction
from vision_basedsensor_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda_only

STAGES = ("detect.finalize", "reconstruct.positions", "contact")
# The benchmark cells' shapes: (rows, cols, batch, backend); 64 vga frames
# stand for vga_batch1024's 1,024 (the same code at a quicker size).
RUNS = {"1080x1920": (1080, 1920, 48, "auto"),
        "1080x1920-unfused": (1080, 1920, 48, "xla"),
        "640x480": (480, 640, 64, "auto")}
CALLS = 3


@pytest.fixture
def fresh():
    """No graph captured and every count 0 before the test, and after."""
    graphs._STAGES.clear()
    yield
    graphs._STAGES.clear()


@contextlib.contextmanager
def eager():
    """The three chains run eagerly (the path before the graphs)."""
    run = lambda stage, fn, *args: fn(*args)
    with pytest.MonkeyPatch.context() as mp:
        for module in (detector, depth, force):
            mp.setattr(module, "replay", run)
        yield


def _clone(x):
    return type(x)(*(_clone(v) if isinstance(v, tuple) else
                     v.clone() if isinstance(v, torch.Tensor) else v
                     for v in x))


def _batches(dev, run):
    h, w, b, backend = RUNS[run]
    cfg = _main_config(96, backend)
    scene, frames = render_drift(dev, h, w, CALLS * b, dz_mm=-0.02)
    return cfg, scene.cam, [frames[i * b:(i + 1) * b] for i in range(CALLS)]


@pytest.mark.parametrize("run", list(RUNS))
def test_graphed_main_path_equals_eager(cuda, fresh, run):
    """``process_frames`` on three different batches: after one eager call
    a stage captures on its second call and replays from then on; every
    output equals the eager path's bit for bit (the detections are
    finalize's, the positions reconstruct's, the tilt and plane contact
    state's); the first graphed call's outputs are unchanged after the
    later replays; each stage counts one capture and one replay a call."""
    cfg, cam, batches = _batches(cuda, run)
    ref = initialize(batches[0][0], cfg)
    with eager():
        want = [process_frames(x, ref, cam, cfg) for x in batches]
    process_frames(batches[-1], ref, cam, cfg)            # seen once: eager
    graphs.reset_graph_counts()
    got = [process_frames(batches[0], ref, cam, cfg)]
    first = _clone(got[0])
    got += [process_frames(x, ref, cam, cfg) for x in batches[1:]]
    torch.cuda.synchronize(cuda)
    for g, w in zip(got, want):
        assert_same_outputs(g, w)
    assert_same_outputs(got[0], first)
    counts = graphs.graph_counts()
    for stage in STAGES:
        assert counts[stage] == {"captures": 1, "replays": CALLS,
                                 "eager": 0}, (stage, counts)
    # The outputs are fresh tensors, none of them the graph's own buffers.
    pools = {t.data_ptr() for st in graphs._STAGES.values()
             for g in st.graphs.values() if g is not None
             for t in g.outputs}
    assert not pools & {t.data_ptr() for o in got for _, t in leaves(o)}


def _recon(dev, batch, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev)
    seen = torch.rand(batch, 65, generator=g, device=dev) > 0.2
    ff = f(batch, 65, 3)
    return Reconstruction(world=f(batch, 65, 3), seen=seen,
                          step=f(batch, 65, 3), step_norm=f(batch, 65).abs(),
                          step_valid=seen, cum_path=f(batch, 65).abs(),
                          from_first=ff, from_first_norm=ff.norm(dim=-1))


def _positions_args(dev, batch, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = CameraModel.create(1200.0, 1210.0, 960.0, 540.0,
                             dist=(-0.18, 0.05, 0.001, -0.002, 0.0),
                             device=dev)
    uv = torch.rand(batch, 65, 2, generator=g, device=dev) * 1000.0
    axes = 15.0 + torch.rand(batch, 65, 2, generator=g, device=dev) * 10.0
    valid = torch.rand(batch, 65, generator=g, device=dev) > 0.1
    return cam, uv, axes, valid, ReconstructConfig()


@pytest.mark.parametrize("where", ["profiler", "thread"])
def test_capture_under_profiler_and_beside_a_thread(cuda, fresh, where):
    """A capture under ``torch.profiler`` (as the benchmark's traced run
    may make it), or while another thread launches kernels, allocates and
    waits on its own stream (``device_feed``'s prefetch thread), gives the
    eager bits."""
    args = [_positions_args(cuda, 48, s) for s in range(CALLS)]
    recons = [_recon(cuda, 48, s) for s in range(CALLS)]
    with eager():
        want = [(depth.reconstruct_positions(*a),
                 force.contact_state_sequence(r, AnalysisConfig()))
                for a, r in zip(args, recons)]
    stop = threading.Event()

    def busy():
        s = torch.cuda.Stream(cuda)
        with torch.cuda.stream(s):
            # No random numbers: PyTorch ties the default generator to
            # every capture (utils/graphs.py).
            x = torch.full((512, 512), 0.01, device=cuda)
            while not stop.is_set():
                x = torch.tanh(x @ x)
                torch.empty(1 << 20, device=cuda)
                s.synchronize()

    ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if where == "profiler"
        else contextlib.nullcontext())
    t = threading.Thread(target=busy)
    if where == "thread":
        t.start()
    try:
        with ctx:
            got = [(depth.reconstruct_positions(*a),
                    force.contact_state_sequence(r, AnalysisConfig()))
                   for a, r in zip(args * 2, recons * 2)]
            torch.cuda.synchronize(cuda)
    finally:
        stop.set()
        if t.is_alive():
            t.join(60)
    assert not t.is_alive()
    for (gp, gc), (wp, wc) in zip(got, want * 2):
        for a, b in zip(gp, wp):
            assert torch.equal(a, b)
        assert_same_outputs(gc, wc)
    counts = graphs.graph_counts()
    for stage in ("reconstruct.positions", "contact"):
        assert counts[stage]["captures"] == 1, counts


def test_batch_sizes_key_apart_and_the_cache_evicts(cuda, fresh, monkeypatch):
    """Two batch sizes give two graphs, each equal to the eager path; with
    room for two signatures a third evicts the oldest, which then runs
    eagerly again (seen once more) before it is captured anew."""
    monkeypatch.setattr(graphs, "LRU", 2)
    cfg = AnalysisConfig()
    recons = {b: _recon(cuda, b, b) for b in (4, 8, 16)}
    with eager():
        want = {b: force.contact_state_sequence(r, cfg)
                for b, r in recons.items()}

    def call(b):
        out = force.contact_state_sequence(recons[b], cfg)
        assert_same_outputs(out, want[b])

    for b in (4, 8):
        for _ in range(3):
            call(b)
    cache = graphs._STAGES["contact"].graphs
    assert len(cache) == 2 and all(g is not None for g in cache.values())
    assert graphs.graph_counts()["contact"] == {"captures": 2, "replays": 4,
                                                "eager": 2}
    call(16)                        # evicts B = 4
    assert len(cache) == 2
    graphs.reset_graph_counts()
    call(4)                         # evicts B = 8; seen once more: eager
    call(4)                         # captured anew
    assert graphs.graph_counts()["contact"] == {"captures": 1, "replays": 1,
                                                "eager": 1}
