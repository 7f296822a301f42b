"""What the process that prints a result may not have loaded: JAX and the
JAX package. Names are compared whole, by the part before the first dot;
the port's name begins with the JAX package's, so a prefix test would be
wrong."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vision_basedsensor_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
