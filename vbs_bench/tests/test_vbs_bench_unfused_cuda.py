"""On the card, the unfused-branch cell ``fhd_unfused_batch48`` at its own
batch: the port is correct against the reference and the control (the
reference in the program's place, in TF32) is not, on three seeds; a traced
batch launches the window-sums kernel once and neither the fields kernel
nor the window gather. Each test decides inside itself whether there is a
card."""
import pytest
import torch

from vbs_bench import manifest
from vbs_bench.control_unfused import readings
from vbs_bench.loads import load
from vbs_bench.program import Program
from vbs_bench.run import run_cell
from vbs_bench.trace import WINDOW, Trace, export_events

CELL = "fhd_unfused_batch48"
SEEDS = (11, 2**31 + 5, 2**33 + 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda_only
def test_the_port_is_correct_on_the_card():
    r = run_cell(CELL, SEEDS[0], 1.0, False, _card())
    assert r["correct"], r["checks"]


@pytest.mark.cuda_only
def test_the_tf32_control_is_not_correct():
    for seed, r in readings(CELL, SEEDS, 0.5, _card(), tf32=True):
        assert not r["correct"], (seed, r["checks"])


@pytest.mark.cuda_only
def test_a_batch_runs_the_unfused_branch():
    import vision_basedsensor_tpu_torch.ops.cuda.window_sums as kw
    dev = _card()
    m = manifest.load()
    cell = manifest.cell(m, CELL)
    traffic = manifest.traffic(cell)
    program = Program(dev)
    program.build(ingest=False)
    drv = load(traffic["kind"])(program, manifest.config(m, cell), traffic,
                                SEEDS[1], dev)
    before = kw.fields_launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            drv.run(1)
            torch.cuda.synchronize(dev)
    assert kw.fields_launches - before == 1
    names = [n for _, _, n, _ in Trace(export_events(prof)).device]
    assert sum("window_sums_kernel" in n for n in names) == 1
    assert not any("fused_fields_kernel" in n or "gather_windows_kernel" in n
                   for n in names)
