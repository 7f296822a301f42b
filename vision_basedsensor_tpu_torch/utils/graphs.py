"""CUDA-graph replay of the port's launch-bound chains.

A chain of a few hundred small operations (detect's finalize, reconstruct's
positions, contact state's plane fit) costs the host more to launch than the
card to run. :func:`replay` runs such a function as one CUDA graph: the
first call with an input signature runs eagerly, the second captures, and
every call from the second on replays. The card runs the same kernels in the
same order, so the bits are the eager path's.

* The signature (:func:`signature`) is the stage, the device, each tensor
  input's shape, dtype and stride, every other input by value (the config
  dataclasses: their Python numbers are baked into the graph) and the TF32
  matmul setting.
* A call copies its tensor inputs into the graph's own buffers and gets
  back copies of the outputs, which are its own: a later replay never
  overwrites an earlier call's result.
* A capture records the function on a side stream
  (``capture_error_mode="thread_local"``, so that another thread's CUDA
  work cannot break it); the signature's eager first call has set up what
  it needs, so the card runs no extra work for it. Every stage's graphs
  share one memory pool a device; each stage keeps its ``LRU`` most recent
  signatures.
* What the input shows decides the rest: tensors on the CPU (or on no card,
  or on two devices), or a stream that is already capturing, run the
  function eagerly. A capture that fails raises. (PyTorch ties the card's
  default random generator to every capture: another thread that draws
  from it while one runs raises.)

:func:`graph_counts` gives each stage's ``captures``, ``replays`` (the
capturing call replays too) and ``eager`` calls since
:func:`reset_graph_counts`.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch

# Signatures kept a stage; a stream whose batch size changes evicts.
LRU = 8

_TENSOR = object()          # a tensor's place in a flattened input


def _spec(x, leaves: list):
    """``x`` with every tensor appended to ``leaves`` and replaced by a
    marker; tuples (named ones too) and lists are walked."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_spec(v, leaves) for v in x))
    return x


def _build(spec, it):
    """:func:`_spec` undone, the tensors taken from ``it`` in order."""
    if spec is _TENSOR:
        return next(it)
    if isinstance(spec, tuple):
        kind, items = spec
        vals = [_build(v, it) for v in items]
        if kind is list:
            return vals
        return kind(vals) if kind is tuple else kind(*vals)
    return spec


def _key(stage: str, spec, leaves: list):
    layout = tuple((t.device, tuple(t.shape), t.dtype, t.stride())
                   for t in leaves)
    return (stage, spec, layout, torch.backends.cuda.matmul.allow_tf32)


def signature(stage: str, args: tuple):
    """The graph key of ``args`` for ``stage``: calls share a graph only
    where their keys are equal."""
    leaves: list = []
    return _key(stage, _spec(args, leaves), leaves)


def _device(leaves: list):
    """The one card every tensor lies on, or None."""
    devs = {t.device for t in leaves}
    if len(devs) != 1:
        return None
    dev = devs.pop()
    return dev if dev.type == "cuda" else None


def _copy(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])``, one ``_foreach_copy_`` a dtype."""
    groups = collections.defaultdict(lambda: ([], []))
    for d, s in zip(dst, src):
        g = groups[s.dtype]
        g[0].append(d)
        g[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list            # the graph's input buffers
    outputs: list           # its distinct output tensors (in its pool)
    out_spec: object        # the output structure, leaves by index
    out_index: list         # each output leaf's index in ``outputs``

    def run(self, leaves: list):
        _copy(self.inputs, leaves)
        self.graph.replay()
        fresh = [torch.empty_like(t) for t in self.outputs]
        _copy(fresh, self.outputs)
        return _build(self.out_spec, (fresh[i] for i in self.out_index))


class _Stage:
    def __init__(self):
        self.graphs = collections.OrderedDict()   # key -> _Graph or None
        self.counts = {"captures": 0, "replays": 0, "eager": 0}


_STAGES: dict[str, _Stage] = {}
_POOLS: dict[int, tuple] = {}      # device index -> (pool, its graphs)
_STREAMS: dict[int, torch.cuda.Stream] = {}   # device index -> capture stream


def _capture(fn, spec, leaves: list, dev: torch.device) -> _Graph:
    """Capture ``fn`` on inputs copied from ``leaves``."""
    inputs = [torch.empty_like(t) for t in leaves]
    _copy(inputs, leaves)
    i = dev.index
    if i not in _STREAMS:
        _STREAMS[i] = torch.cuda.Stream(dev)
    pool = _POOLS.get(i)
    if pool is None or not pool[1]:
        # PyTorch takes no capture into a pool whose graphs have all gone.
        pool = _POOLS[i] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    side, here = _STREAMS[i], torch.cuda.current_stream(dev)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(here)
    with torch.cuda.stream(side):
        # No eager warm-up here: the signature's first call ran eagerly.
        graph.capture_begin(pool=pool[0], capture_error_mode="thread_local")
        try:
            out = fn(*_build(spec, iter(inputs)))
        finally:
            graph.capture_end()
    here.wait_stream(side)
    pool[1].add(graph)
    out_leaves: list = []
    out_spec = _spec(out, out_leaves)
    # An output returned twice (a plane's tilt is also the state's) is
    # copied out once and returned twice, as the eager path does.
    index: dict = {}
    out_index = [index.setdefault(id(t), len(index)) for t in out_leaves]
    outputs = list({id(t): t for t in out_leaves}.values())
    return _Graph(graph, inputs, outputs, out_spec, out_index)


def replay(stage: str, fn, *args):
    """``fn(*args)``: eagerly on the first call with this signature, as a
    CUDA graph from the second (see the module's docstring)."""
    st = _STAGES.get(stage)
    if st is None:
        st = _STAGES[stage] = _Stage()
    leaves: list = []
    spec = _spec(args, leaves)
    dev = _device(leaves)
    if dev is None or torch.cuda.is_current_stream_capturing():
        st.counts["eager"] += 1
        return fn(*args)
    key = _key(stage, spec, leaves)
    graphs = st.graphs
    if key not in graphs:
        graphs[key] = None
        while len(graphs) > LRU:
            graphs.popitem(last=False)
        st.counts["eager"] += 1
        return fn(*args)
    graphs.move_to_end(key)
    with torch.cuda.device(dev):
        g = graphs[key]
        if g is None:
            g = graphs[key] = _capture(fn, spec, leaves, dev)
            st.counts["captures"] += 1
        st.counts["replays"] += 1
        return g.run(leaves)


def graph_counts() -> dict:
    """Each stage's ``captures``, ``replays`` and ``eager`` calls since the
    last reset."""
    return {k: dict(st.counts) for k, st in _STAGES.items()}


def reset_graph_counts() -> None:
    """Set every stage's counts to 0 (its graphs stay)."""
    for st in _STAGES.values():
        st.counts = dict.fromkeys(st.counts, 0)
