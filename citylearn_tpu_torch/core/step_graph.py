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

The graph is a :class:`citylearn_tpu_torch.graphs.Graph` of the step over
its state's and actions' tensors, keyed also on the function, the
``StaticConfig`` and the ``DistrictParams`` (all three by identity), the
action names and the state's field layout. Its key has no strides, so a
state fresh from a reset and a stepped one share it. The step runs
eagerly on any device but a CUDA card, with the physics checks on
(:mod:`citylearn_tpu_torch.core.debug`, which read back from the card)
and in the float64 parity mode.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict

import torch

from citylearn_tpu_torch import graphs
from citylearn_tpu_torch.core import debug
from citylearn_tpu_torch.core.types import EnvState

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
    return leaves, tuple(layout)


def _unleaves(leaves, layout, names):
    """The (state, actions) whose :func:`_leaves` are ``leaves``."""
    it = iter(leaves)

    def take(n):
        return None if n is None else next(it) if n < 0 else tuple(next(it) for _ in range(n))

    state = EnvState(**{f: take(n) for f, n in zip(_STATE_FIELDS, layout)})
    return state, {k: next(it) for k in names}


def _graphed(fn: Callable, cfg, params, state: EnvState, actions: Dict[str, torch.Tensor]):
    """The step as :meth:`citylearn_tpu_torch.graphs.Graph.run` takes it: a
    function of its tensors, the tensors, the key and the identity key."""
    names = tuple(sorted(actions))
    leaves, layout = _leaves(state, actions, names)
    return (lambda *xs: fn(cfg, params, *_unleaves(xs, layout, names)), leaves,
            (names, layout), (fn, cfg, params))


def key_of(fn: Callable, cfg, params, state: EnvState, actions: Dict[str, torch.Tensor]):
    """The graph key of the step ``fn(cfg, params, state, actions)``."""
    _, leaves, key, same = _graphed(fn, cfg, params, state, actions)
    return graphs.key_of(leaves, key, same)


class StepGraph:
    """One owner's CUDA graph of its district step (:attr:`graph`). The
    state and output that :meth:`run` returns on a replay are the graph's
    static outputs: they stay valid until this graph's next replay, so a
    caller consumes them, or passes the state straight back in, before its
    next step, and clones what it keeps longer."""

    def __init__(self):
        self.graph = graphs.Graph("step")

    def engaged(self) -> _Engage:
        """A block inside which ``district_step`` (and ``step_packed``)
        replay this graph."""
        return _Engage(self)

    def run(self, fn: Callable, cfg, params, state: EnvState, actions: Dict[str, torch.Tensor]):
        """``fn(cfg, params, state, actions)``: eagerly off the card, with
        the physics checks on or in the parity mode, else by this graph."""
        with _Engage(None):
            if cfg.parity_f64 or debug.checks_enabled() or state.t.device.type != "cuda":
                return fn(cfg, params, state, actions)
            return self.graph.run(*_graphed(fn, cfg, params, state, actions))
