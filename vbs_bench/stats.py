"""The statistics the end-to-end metrics are made of, kept apart so that
the tests can hold them to their definitions."""
from __future__ import annotations


def window_rate(units_done: int, started: float, ended: float) -> float:
    """Work completed over the window's whole time: a stall anywhere inside
    ``[started, ended]`` lowers it."""
    if ended <= started:
        raise ValueError(f"empty window [{started}, {ended}]")
    return units_done / (ended - started)
