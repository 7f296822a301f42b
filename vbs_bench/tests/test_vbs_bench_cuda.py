"""On the card, at sizes a test run holds: the port is correct against the
reference, and the control (the reference in the program's place, in TF32)
is not, on three seeds. Each test decides inside itself whether there is a
card."""
import pytest
import torch

from vbs_bench.control import readings
from vbs_bench.run import run_cell

# The batch cells at their own batch: below it cuBLAS runs some of the
# filter GEMMs without TF32's tensor-core kernels, and the control's gaps
# shrink under the limits, which were set at the cells' own size.
SMALL = {"vga_batch1024": {},
         "fhd_batch48": {},
         "vga_replay_avi2048": {"period": 32, "periods": 2, "chunk": 32}}
SEEDS = (11, 2**31 + 5, 2**33 + 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda_only
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_port_is_correct_on_the_card(cell):
    r = run_cell(cell, SEEDS[0], 1.0, False, _card(),
                 traffic_overrides=SMALL[cell])
    assert r["correct"], r["checks"]


@pytest.mark.cuda_only
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_tf32_control_is_not_correct(cell):
    for seed, r in readings(cell, SEEDS, 0.5, _card(), tf32=True,
                            traffic_overrides=SMALL[cell]):
        assert not r["correct"], (seed, r["checks"])
