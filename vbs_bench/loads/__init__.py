"""The general generators of load, one for each ``kind`` that a traffic
file under ``traffic/`` names: ``batch`` (closed loop of batches) and
``replay`` (the replay command, back to back). A load sets its cell up from the seed, runs units
of work and checks what they produced against the reference."""
from __future__ import annotations

import importlib


def load(kind: str):
    """The class of traffic ``kind`` (``loads/<kind>.py``)."""
    return importlib.import_module(f"{__name__}.{kind}").Load
