"""Sorted sparse-to-dense expansion, the scatter of every JPEG transport.

Plain version of the K8 kernel (``ops/cuda/expand.py`` +
``csrc/expand_sorted.cu``), which ports
``benchmarks/scatter_onehot_kernel.py:expand_sorted``. In the JAX package
the same function is each transport's ``.at[pos].set/add(mode="drop")``
(``vision_basedsensor_tpu/ops/jpeg.py``).
"""
from __future__ import annotations

import torch


def expand_sorted_reference(pos: torch.Tensor, val: torch.Tensor, total: int,
                            spill_pos: torch.Tensor | None = None,
                            spill_val: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Dense ``(total,)`` int16 with ``out[p] = sum(val[e] for pos[e] == p)``
    over the sorted int32 stream ``pos``/``val`` (int16), plus the optional
    second sorted stream ``spill_pos``/``spill_val`` on top.

    Entries outside ``[0, total)`` are dropped. JAX's ``mode="drop"``
    scatter drops only positions >= total and wraps negative ones (-1 adds
    to the last element); the transports' only negative positions are the
    -1s of an all-``(gap=0, delta=0)`` spill pad, whose values are 0, so
    dropping them gives the same tensor. Sums are taken in int32 and stored
    as int16, i.e. modulo 2^16 like the reference's int16 adds.

    One contract serves every transport: PACKED's unique positions (a set
    on zeros), SPLIT/TDELTA's payload bytes that repeat their starter's
    position with value 0, and the spill adds. On K8's own domain (strictly
    increasing, |val| <= 127) it equals K8's float32 output.
    """
    out = torch.zeros(total, dtype=torch.int32, device=pos.device)
    for p, v in ((pos, val), (spill_pos, spill_val)):
        if p is None:
            continue
        keep = (p >= 0) & (p < total)
        out.index_add_(0, p[keep].long(), v[keep].to(torch.int32))
    return out.to(torch.int16)
