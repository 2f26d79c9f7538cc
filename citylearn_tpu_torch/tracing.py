"""Spans inside the program, on the host's wall clock.

The trainer, the SAC update, the district step, the Gym env's step and
the kernel wrappers open a span at each layer boundary: ``train.call``,
``train.chunk`` (the chunked collect) or ``train.step`` (one step of the
per-step collect, its update included), ``train.policy``, ``train.update``
(``train.draws``, ``train.replay``, ``sac.target``, ``sac.critic``,
``sac.policy``, ``sac.polyak``; on a CUDA card ``sac.graph``, one replay
of the update's CUDA graph, in place of the four, and ``sac.capture``
around the graph's capture) and ``train.readback``; inside
``district_step`` on an LSTM-dynamics district ``step.partial_load``
(the partial-load demand) and ``step.dynamics`` (the LSTM's window and
its prediction); on a CUDA card, where the per-step trainer and the Gym
env replay a CUDA graph of their step (``core/step_graph.py``),
``step.graph`` (one replay, the copy of the state and actions into its
buffers included) and ``step.capture`` (the graph's capture), and then
``step.partial_load`` and ``step.dynamics`` appear only in a graph's
first, eager call and its capture, never in a replay; ``env.step``
(``env.actions``, ``env.district_step``, ``env.readback``,
``env.observe``); and one span per kernel wrapper, named
after it (``battery_episode``, ``battery_collect_chunk``,
``thermal_episode``, ``ev_episode``, ``lstm_episode``,
``neighborhood_episode``, ``postpass_kernel``). How often a layer ran is
the number of its spans. Tracing is off by default, and then a span is one
test of a module flag that returns a shared no-op: no clock is read,
nothing is allocated and ``torch.profiler`` is not touched.
:func:`recording` switches it on for a block::

    with tracing.recording() as rec:
        trainer.train(64, chunk=64)
    rec.durations("train.update")

A span records (id, parent id, root id, name, start, end), the times from
``time.time_ns()``, the clock onto which ``torch.profiler``'s events are
placed, so a device trace's idle gaps can be put down to the innermost
span open on the host. The parent is the span open on the same thread when
this one began; every span under one outermost span (a ``train`` call, an
``env.step``) carries that span's id as its root. A span never
synchronizes and never reads a device value.

Inside :class:`citylearn_tpu_torch.utilities.Profiler` every span also
opens ``torch.profiler.record_function(name)``, so the Chrome trace names
the program's layers.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import List, NamedTuple

import torch


class Span(NamedTuple):
    id: int
    parent: int          # 0 for a span opened with no other open on its thread
    root: int            # the outermost open span's id (its own at the top)
    name: str
    start_ns: int        # time.time_ns()
    end_ns: int


class Recording:
    """What a :func:`recording` block recorded: its spans in the order
    they ended."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate    # spans open record_function ranges too
        self._ended = []            # plain tuples in Span's order: the cheapest record

    @property
    def spans(self) -> List[Span]:
        """The spans that ended in the block, in that order (a new list on
        each read)."""
        return list(map(Span._make, self._ended))

    def durations(self, name: str) -> List[float]:
        """Seconds of every span named ``name``, in the order they ended."""
        return [(end - start) * 1e-9 for _, _, _, n, start, end in self._ended if n == name]


class _Off:
    """The shared no-op that :func:`span` returns with tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Thread(threading.local):
    def __init__(self):
        self.open = []              # the spans open on this thread, outermost first


_OFF = _Off()
_ids = itertools.count(1)
_thread = _Thread()
_active: Recording = None       # the recording() block's, or None: tracing off


class _Open:
    __slots__ = ("rec", "name", "id", "parent", "root", "start", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        open_ = _thread.open
        self.id = i = next(_ids)
        if open_:
            top = open_[-1]
            self.parent, self.root = top.id, top.root
        else:
            self.parent, self.root = 0, i
        open_.append(self)
        self.range = None
        if self.rec.annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _thread.open.pop()
        self.rec._ended.append((self.id, self.parent, self.root, self.name, self.start, end))
        return False


def span(name: str):
    """A context manager that records the block as a span named ``name``
    while a :func:`recording` block is active, and does nothing otherwise."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name)


def traced(name: str):
    """A decorator that makes every call of the function a span named
    ``name``; with tracing off, a call costs one flag test more."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            rec = _active
            if rec is None:
                return fn(*args, **kw)
            with _Open(rec, name):
                return fn(*args, **kw)
        return call
    return decorate


@contextlib.contextmanager
def recording(annotate: bool = False):
    """Switch tracing on for the block and yield its :class:`Recording`;
    tracing is off again on exit. With ``annotate``, each span also opens
    ``torch.profiler.record_function(name)``
    (:class:`citylearn_tpu_torch.utilities.Profiler` passes it). A block
    inside another yields the outer block's recording, which keeps every
    span, annotated for the inner block's length if it asks."""
    global _active
    rec = _active
    if rec is not None:
        outer = rec.annotate
        rec.annotate = outer or annotate
        try:
            yield rec
        finally:
            rec.annotate = outer
        return
    _active = rec = Recording(annotate)
    try:
        yield rec
    finally:
        _active = None
