"""On the card, the streaming cell ``vga_stream_chunk64`` at its own size:
the port is correct against the reference, and the control (the reference
in the program's place, in TF32) is not, on three seeds. Each test decides
inside itself whether there is a card."""
import pytest
import torch

from vbs_bench.control import readings
from vbs_bench.run import run_cell

CELL = "vga_stream_chunk64"
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
    for seed, r in readings(CELL, SEEDS, 2.0, _card(), tf32=True):
        assert not r["correct"], (seed, r["checks"])
