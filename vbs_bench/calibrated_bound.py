"""The least times of the calibrated cell's two stages that no other cell
runs, frozen with the benchmark: the remap of uint8 frames to rectified
float32 gray (``core/undistort.py:remap_bilinear`` after
``to_grayscale``), and the sequential association kernel
(``csrc/associate.cu``)."""
from __future__ import annotations

from vbs_bench import roofline

# The association kernel's dependent chain a frame: 61 instructions of 4
# cycles each at the card's 1,980 MHz boost clock (``PERF.md`` §6's chain
# bound, 65 valid detections a frame).
CHAIN_INSTRUCTIONS = 61
CYCLES = 4
CLOCK_HZ = 1.98e9


def remap_bound_s(frames: int, calls: int, h: int, w: int) -> float:
    """Least seconds of ``calls`` remaps of ``frames`` ``h`` x ``w`` frames
    in all: each frame's uint8 pixels read once (1 B) and its float32
    rectified pixels written once (4 B), each call's ``(h, w, 2)`` float32
    map read once (8 B a pixel); a bilinear sample's few operations never
    outweigh its bytes."""
    return roofline.bound_s(frames * h * w * 5 + calls * h * w * 8, 0.0)


def associate_bound_s(frames: int) -> float:
    """Least seconds of one association launch over ``frames`` frames: the
    frames are a chain, each frame's matching waiting on the last-seen
    positions the previous frame left."""
    return frames * CHAIN_INSTRUCTIONS * CYCLES / CLOCK_HZ
