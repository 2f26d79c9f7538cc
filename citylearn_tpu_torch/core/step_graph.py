"""The district step as a CUDA graph: one replay in place of the step's
eager launches (~1500 a step on an LSTM-dynamics district, ~180 on a
battery+PV one), for callers that step the same district batch again and
again.

An owner (the per-step trainer, the Gym env, each mesh rank) holds its own
:class:`StepGraph` and engages it around its step::

    graph = StepGraph()
    with graph.engaged():
        state, out = district_step(cfg, params, state, actions)

Inside the block :func:`~citylearn_tpu_torch.core.step.district_step`
(and the Gym env's ``step_packed``) hands its work to :meth:`StepGraph.run`,
which replays the owner's graph of it; the call keeps its four arguments,
so a caller that wraps the function still sees one call a step. Outside
any block the step runs eagerly, as it always did.

:meth:`StepGraph.run` keys a graph on what the captured work reads: the
function, the ``StaticConfig`` and the ``DistrictParams`` (both by
identity), the action names, every state and action tensor's shape,
dtype and device, TF32 and inference mode. Strides are not in the key: a
state fresh from a reset and a stepped one map to the same key, and each
call copies its state and actions into the graph's static buffers (one
``torch._foreach_copy_`` per dtype). A key's first call runs eagerly on
the capture's side stream (PyTorch's warm-up); its second captures and
replays; every later call replays. A new key replaces the graph.

The step runs eagerly on any device but a CUDA card, with the physics
checks on (:mod:`citylearn_tpu_torch.core.debug`, which read back from the
card) and in the float64 parity mode.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict

import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.core import debug
from citylearn_tpu_torch.core.types import EnvState, map_tensors

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


class _Engaged(threading.local):
    graph = None                    # the StepGraph whose block is open on this thread


_engaged = _Engaged()


def engaged_graph():
    """The :class:`StepGraph` engaged on this thread, or None."""
    return _engaged.graph


class _Engage:
    __slots__ = ("graph", "outer")

    def __init__(self, graph):
        self.graph = graph

    def __enter__(self):
        self.outer, _engaged.graph = _engaged.graph, self.graph
        return self.graph

    def __exit__(self, *exc):
        _engaged.graph = self.outer
        return False


class _ById:
    """A key member compared by identity."""
    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _ById) and self.obj is other.obj

    def __hash__(self):
        return id(self.obj)


def _leaves(state: EnvState, actions: Dict[str, torch.Tensor], names):
    """The state's tensors in field order, then the actions' in ``names``'
    order, and the layout of the state's fields (a tuple's length, None
    for an absent field, -1 for a tensor)."""
    leaves, layout = [], []
    for f in _STATE_FIELDS:
        v = getattr(state, f)
        if isinstance(v, tuple):
            layout.append(len(v))
            leaves.extend(v)
        elif v is None:
            layout.append(None)
        else:
            layout.append(-1)
            leaves.append(v)
    leaves.extend(actions[k] for k in names)
    return leaves, layout


def key_of(fn: Callable, cfg, params, state: EnvState, actions: Dict[str, torch.Tensor]):
    """(the call's key, its tensors in the order the graph copies them)."""
    names = tuple(sorted(actions))
    leaves, layout = _leaves(state, actions, names)
    key = (_ById(fn), _ById(cfg), _ById(params), names, tuple(layout),
           tuple((x.shape, x.dtype, x.device) for x in leaves),
           torch.backends.cuda.matmul.allow_tf32, torch.is_inference_mode_enabled())
    return key, leaves


class StepGraph:
    """One owner's CUDA graph of its district step. The state and output
    that :meth:`run` returns on a replay are the graph's static outputs:
    they stay valid until this graph's next replay, so a caller consumes
    them, or passes the state straight back in, before its next step, and
    clones what it keeps longer."""

    def __init__(self):
        self.key = None
        self.graph = None           # torch.cuda.CUDAGraph once captured
        self._stream = None
        self._groups = ()           # ([static buffer], [leaf index]) per dtype, every
                                    # buffer the graph reads
        self._out = None

    def __reduce__(self):
        # a copy or a pickle starts without a graph: the captured one
        # reads this object's buffers
        return (StepGraph, ())

    def engaged(self) -> _Engage:
        """A block inside which ``district_step`` (and ``step_packed``)
        replay this graph."""
        return _Engage(self)

    def run(self, fn: Callable, cfg, params, state: EnvState, actions: Dict[str, torch.Tensor]):
        """``fn(cfg, params, state, actions)``: eagerly off the card, with
        the physics checks on or in the parity mode, else by this graph
        (eager at a key's first call, captured at its second, replayed)."""
        with _Engage(None):
            if cfg.parity_f64 or debug.checks_enabled() or state.t.device.type != "cuda":
                return fn(cfg, params, state, actions)
            key, leaves = key_of(fn, cfg, params, state, actions)
            if key != self.key:
                self._reset(key, state.t.device)
                return self._first(fn, cfg, params, state, actions)
            if self.graph is None:
                self._capture(fn, cfg, params, state, actions)
        with tracing.span("step.graph"):
            for statics, at in self._groups:
                # a leaf that is its buffer (a field the step passes
                # through, handed back) needs no copy
                pairs = [(x, leaves[i]) for x, i in zip(statics, at) if leaves[i] is not x]
                if pairs:
                    dst, src = zip(*pairs)
                    torch._foreach_copy_(list(dst), list(src))
            self.graph.replay()
        return self._out

    def _reset(self, key, device):
        self.key, self.graph, self._groups, self._out = key, None, (), None
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)

    def _first(self, fn, cfg, params, state, actions):
        current = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn(cfg, params, state, actions)
        current.wait_stream(self._stream)
        return out

    def _capture(self, fn, cfg, params, state, actions):
        # buffers of the capture's layout (a dense copy of an expanded
        # tensor), outside the graph's pool
        st = map_tensors(torch.empty_like, state)
        acts = {k: torch.empty_like(v) for k, v in actions.items()}
        graph = torch.cuda.CUDAGraph()
        with tracing.span("step.capture"), torch.cuda.graph(graph, stream=self._stream):
            self._out = fn(cfg, params, st, acts)
        statics, _ = _leaves(st, acts, tuple(sorted(acts)))
        groups = {}
        for i, x in enumerate(statics):
            if x.numel():
                bufs, at = groups.setdefault(x.dtype, ([], []))
                bufs.append(x)
                at.append(i)
        self._groups, self.graph = tuple(groups.values()), graph
