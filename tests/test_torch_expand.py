"""K8, the sorted sparse-to-dense expansion of the JPEG transports: the
PyTorch port's plain version (``ops/expand.py``) and its CPU dispatch
(``ops/cuda/expand.py``) vs the reference's Pallas kernel
``benchmarks/scatter_onehot_kernel.py:expand_sorted`` in interpret mode
(loaded by path) and vs the XLA scatters of ``ops/jpeg.py``. On a card the
CUDA kernel is checked in tests/test_torch_cuda.py.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
from vision_basedsensor_tpu_torch.ops.expand import expand_sorted_reference

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def onehot():
    spec = importlib.util.spec_from_file_location(
        "scatter_onehot_kernel", ROOT / "benchmarks" / "scatter_onehot_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _onehot_case(mod, name):
    """The five cases of the benchmark's own ``_parity()``."""
    slots, w = mod.SLOTS, mod.W
    rng = np.random.default_rng(0)
    cases = {}
    for total, nnz, key in ((slots * 3, 500, "small sparse"),
                            (slots * 3 + 1000, 700, "ragged total"),
                            (slots * 2, slots // 4, "dense-ish"),
                            (slots, 40, "single tile")):
        pos = np.sort(rng.choice(total + 500, size=nnz,
                                 replace=False)).astype(np.int32)
        val = rng.integers(-127, 128, nnz).astype(np.int8)
        val[val == 0] = 3
        cases[key] = (pos, val, total)
    # One tile past the W-entry budget: the kernel's overflow fix-up.
    pos = np.arange(w + 200, dtype=np.int32) * 2
    cases["overflow tile"] = (pos, np.full(pos.size, 5, np.int8), slots * 2)
    return cases[name]


@pytest.mark.parametrize("name", ["small sparse", "ragged total", "dense-ish",
                                  "single tile", "overflow tile"])
def test_plain_matches_onehot_kernel(onehot, name):
    pos, val, total = _onehot_case(onehot, name)
    want = np.asarray(onehot.expand_sorted(jnp.asarray(pos), jnp.asarray(val),
                                           total, interpret=True))
    got = expand_sorted_reference(torch.from_numpy(pos),
                                  torch.from_numpy(val.astype(np.int16)), total)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def _jax_scatter(pos, val, total, spos=None, sval=None):
    """The transports' scatter: ``.at[pos].add(mode="drop")`` in int16."""
    out = jnp.zeros(total, jnp.int16).at[jnp.asarray(pos)].add(
        jnp.asarray(val), mode="drop", indices_are_sorted=True)
    if spos is not None:
        out = out.at[jnp.asarray(spos)].add(jnp.asarray(sval), mode="drop",
                                            indices_are_sorted=True)
    return np.asarray(out)


def _streams(kind, rng):
    total = 5000
    if kind == "empty":
        return (np.zeros(0, np.int32), np.zeros(0, np.int16), total,
                np.zeros(0, np.int32), np.zeros(0, np.int16))
    # A VLC-style stream: each start may be followed by payload bytes that
    # repeat its position with value 0; the tail overruns the tensor.
    step = rng.integers(1, 40, 600)
    step[rng.random(600) < 0.2] = 0          # zero-valued duplicates
    step[0] = 1
    pos = (np.cumsum(step) - 1).astype(np.int32)
    val = (rng.integers(1, 128, 600)
           * rng.choice([-1, 1], 600)).astype(np.int16)
    val[step == 0] = 0
    assert pos[-1] >= total                   # tail overrun drops
    if kind == "pads only":
        # No real spills: every (gap=0, delta=0) pad sits at -1, which JAX
        # wraps to the last element and the port drops; both add zero.
        spos = np.full(64, -1, np.int32)
        sval = np.zeros(64, np.int16)
    else:
        sgap = np.zeros(64, np.int64)
        sgap[:10] = rng.integers(1, 500, 10)
        spos = (np.cumsum(sgap) - 1).astype(np.int32)
        sval = np.zeros(64, np.int16)
        sval[:10] = rng.integers(-3000, 3000, 10)
    return pos, val, total, spos, sval


@pytest.mark.parametrize("kind", ["spills", "pads only", "empty"])
def test_plain_matches_xla_scatter(kind):
    pos, val, total, spos, sval = _streams(kind, np.random.default_rng(3))
    want = _jax_scatter(pos, val, total, spos, sval)
    t = [torch.from_numpy(a) for a in (pos, val, spos, sval)]
    got = expand_sorted_reference(t[0], t[1], total, t[2], t[3])
    np.testing.assert_array_equal(got.numpy(), want)
    before = kx.launches
    np.testing.assert_array_equal(
        kx.expand_sorted(t[0], t[1], total, t[2], t[3]).numpy(), want)
    assert kx.launches == before          # a CPU tensor launches nothing


def test_negative_positions_drop():
    """Where the port and JAX differ (see ``expand_sorted_reference``): JAX
    wraps -1 to the last element even with mode="drop", the port drops it.
    The transports put only zero values below 0, where both agree."""
    pos = torch.tensor([-1, 2], dtype=torch.int32)
    val = torch.tensor([5, 1], dtype=torch.int16)
    assert expand_sorted_reference(pos, val, 4).tolist() == [0, 0, 1, 0]
    assert _jax_scatter(pos.numpy(), val.numpy(), 4).tolist() == [0, 0, 1, 5]
    zero = torch.zeros(2, dtype=torch.int16)
    assert (expand_sorted_reference(pos, zero, 4).numpy()
            == _jax_scatter(pos.numpy(), zero.numpy(), 4)).all()


def test_sums_wrap_like_int16():
    pos = torch.tensor([0, 0], dtype=torch.int32)
    val = torch.tensor([30000, 30000], dtype=torch.int16)
    np.testing.assert_array_equal(
        expand_sorted_reference(pos, val, 1).numpy(),
        _jax_scatter(pos.numpy(), val.numpy(), 1))
