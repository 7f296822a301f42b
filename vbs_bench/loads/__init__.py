"""The general generators of load, one for each ``kind`` that a traffic
file under ``traffic/`` names, in ``loads/<kind>.py``: ``batch`` (closed
loop of batches), ``batch_unfused`` (the same, checked against the
reference that holds the unfused branch), ``replay`` (the replay command,
back to back) and ``stream`` (closed loop of streaming sessions fed in
chunks). A new kind is a new file here, with its control as a new file
beside ``control.py``. A load sets its cell up from the seed, runs units of
work and checks what they produced against the reference."""
from __future__ import annotations

import importlib


def load(kind: str):
    """The class of traffic ``kind`` (``loads/<kind>.py``)."""
    return importlib.import_module(f"{__name__}.{kind}").Load
