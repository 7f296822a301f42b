"""The port's hand-written CUDA kernels and their launch counters.

Each wrapper adds one to its counter where it launches its kernel and
nowhere else; :func:`launch_counts` reads them all (``chip_smoke.py`` and
``parallel/mesh.py``'s per-shard evidence).
"""
from __future__ import annotations

import importlib

# name -> (module of this package, its counter)
COUNTERS = {"fields": ("fields", "fields_launches"),
            "gather": ("moments", "gather_launches"),
            "window_sums": ("window_sums", "fields_launches"),
            "window_sums_packed": ("window_sums", "packed_launches"),
            "expand_sorted": ("expand", "launches"),
            "scan": ("scan", "scan_launches"),
            "associate": ("scan", "assoc_launches"),
            "filters": ("filters", "filters_launches")}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """Every kernel's launches since its last reset, by name."""
    return {k: getattr(_module(m), a) for k, (m, a) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for m, a in COUNTERS.values():
        setattr(_module(m), a, 0)
