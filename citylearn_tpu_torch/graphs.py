"""A call as a CUDA graph: one replay in place of the call's eager launches.

The port graphs two calls this way: ``sac_update``
(:mod:`citylearn_tpu_torch.agents.sac`) and the district step
(:mod:`citylearn_tpu_torch.core.step_graph`). Each owner of such a call
holds a :class:`Graph` and runs the call through it::

    out = graph.run(fn, tensors, key, same)

which returns ``fn(*tensors)``. The graph is keyed on what the captured
work reads: the caller's ``key`` (compared by value), its ``same`` (the
objects the work reads besides ``tensors``, compared by identity), each
tensor's shape, dtype and device, TF32 and inference mode. Strides are
not in the key: the caller's tensors are copied into buffers of the
capturing call's layout, dense where an input was expanded
(``torch.empty_like``), so that one capture serves a tensor whatever view
of its values the caller hands in (the step's state fresh from a reset
and a stepped one; the update's expanded ``done``).

A key's first call runs ``fn`` eagerly on the graph's side stream
(PyTorch's warm-up: what the call allocates once, such as Adam's state,
is made outside a capture); its second captures ``fn`` on the buffers and
replays; every later call copies its tensors into the buffers (one
``torch._foreach_copy_`` per dtype, none for a tensor that is its buffer,
as an output handed back in is) and replays. A new key replaces the graph.
A replay returns the capture's outputs, which are the graph's: they hold
until its next replay. Whether a call runs eagerly instead (off the card,
for one) is the owner's decision.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from citylearn_tpu_torch import tracing


def key_of(tensors: Sequence[torch.Tensor], key, same) -> tuple:
    """The graph key of a call of ``fn(*tensors)`` (see the module). It
    names ``same`` by ``id``: a holder of the key keeps ``same`` alive, so
    that no other object takes those ids."""
    return (key, tuple(map(id, same)), tuple((x.shape, x.dtype, x.device) for x in tensors),
            torch.backends.cuda.matmul.allow_tf32, torch.is_inference_mode_enabled())


class Graph:
    """One owner's CUDA graph of its call. Its spans are
    ``<prefix>.graph`` (a replay, the copy of the inputs included) and
    ``<prefix>.capture``. A copy or a pickle starts without a graph: the
    captured one reads this object's buffers."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._spans = (f"{prefix}.graph", f"{prefix}.capture")
        self.key = self._same = None    # the key, and the objects it names by id
        self.captured = None        # torch.cuda.CUDAGraph once captured
        self._stream = None
        self._groups = ()           # ([buffer], [tensor index]) per dtype, every
                                    # buffer the graph reads
        self._out = None

    def __reduce__(self):
        return (Graph, (self.prefix,))

    def run(self, fn: Callable, tensors: Sequence[torch.Tensor], key, same):
        """``fn(*tensors)``, eagerly at a key's first call, else by this
        graph (captured at the key's second call)."""
        full = key_of(tensors, key, same)
        if full != self.key:
            self.key, self._same, self.captured, self._groups, self._out = \
                full, same, None, (), None
            device = tensors[0].device
            if self._stream is None or self._stream.device != device:
                self._stream = torch.cuda.Stream(device)
            current = torch.cuda.current_stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn(*tensors)
            current.wait_stream(self._stream)
            return out
        if self.captured is None:
            # buffers outside the graph's pool
            statics = self._buffers(tensors)
            graph = torch.cuda.CUDAGraph()
            with tracing.span(self._spans[1]), torch.cuda.graph(graph, stream=self._stream):
                self._out = fn(*statics)
            self.captured = graph
        with tracing.span(self._spans[0]):
            self._load(tensors)
            self.captured.replay()
        return self._out

    def _buffers(self, tensors: Sequence[torch.Tensor]) -> list:
        """The graph's input buffers, one ``torch.empty_like`` of each
        tensor, grouped by dtype for :meth:`_load`."""
        statics, groups = [torch.empty_like(x) for x in tensors], {}
        for i, x in enumerate(statics):
            if x.numel():
                bufs, at = groups.setdefault(x.dtype, ([], []))
                bufs.append(x)
                at.append(i)
        self._groups = tuple(groups.values())
        return statics

    def _load(self, tensors: Sequence[torch.Tensor]):
        """Copy ``tensors`` into the graph's buffers."""
        for statics, at in self._groups:
            pairs = [(x, tensors[i]) for x, i in zip(statics, at) if tensors[i] is not x]
            if pairs:
                dst, src = zip(*pairs)
                torch._foreach_copy_(list(dst), list(src))
