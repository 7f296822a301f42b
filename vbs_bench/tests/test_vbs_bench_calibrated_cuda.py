"""On the card, the calibrated cell ``vga_calibrated_indent_chunk256`` at
its own size: the port is correct against the reference and the control
(the reference in the program's place, in TF32) is not, on three seeds; a
traced session builds one rectify map, remaps every frame (frame 0 once
more for its table) and launches the association kernel once a chunk. Each
test decides inside itself whether there is a card."""
import pytest
import torch

from vbs_bench import manifest
from vbs_bench.control_calibrated import readings
from vbs_bench.loads import load
from vbs_bench.program import Program
from vbs_bench.run import run_cell
from vbs_bench.trace import WINDOW, Trace, export_events

CELL = "vga_calibrated_indent_chunk256"
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
    for seed, r in readings(CELL, SEEDS, 1.0, _card(), tf32=True):
        assert not r["correct"], (seed, r["checks"])


@pytest.mark.cuda_only
def test_a_session_rectifies_and_associates_on_the_card():
    from vision_basedsensor_tpu_torch.core import undistort
    from vision_basedsensor_tpu_torch.ops.cuda import scan
    dev = _card()
    m = manifest.load()
    cell = manifest.cell(m, CELL)
    traffic = manifest.traffic(cell)
    program = Program(dev)
    program.build(ingest=False)
    drv = load(traffic["kind"])(program, manifest.config(m, cell), traffic,
                                SEEDS[1], dev)
    chunks = traffic["frames"] // traffic["chunk"]
    undistort.reset_undistort_counts()
    before = scan.assoc_launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            drv.run(1)
            torch.cuda.synchronize(dev)
    assert scan.assoc_launches - before == chunks
    assert undistort.undistort_counts() == {
        "maps": 1, "frames": traffic["frames"] + 1}
    names = [n for _, _, n, _ in Trace(export_events(prof)).device]
    assert sum("associate_kernel" in n for n in names) == chunks
