"""The CUDA-graph mechanism of the port (``citylearn_tpu_torch.graphs``),
which ``sac_update`` and the district step share.

On the CPU: the graph's input buffers take the capturing call's dense
layout and copy in every layout of the same values; the key leaves out
strides and names the caller's identity members by identity; and, for
each owner (the update's ``AgentNets``, the step's ``StepGraph``), the CPU
runs the call eagerly and leaves no graph, and a copy or a pickle starts
without one. On the card the mechanism is tested through its owners:
``test_torch_sac_graph.py`` and ``test_torch_step_graph.py``."""

import copy
import pickle
import threading

import pytest
import torch

import test_torch_sac_graph as update_case
import test_torch_step_graph as step_case
from citylearn_tpu_torch import graphs
from citylearn_tpu_torch.agents import sac
from citylearn_tpu_torch.core.step_graph import StepGraph
from test_torch_step_graph import battery_schema, lstm_schema  # noqa: F401  (fixtures)

#: each owner of a graph, and the attribute that holds it
OWNERS = {
    "update": (lambda: sac.make_agent_nets(1, 4, 1, (8,), 3e-4, torch.Generator().manual_seed(0),
                                           "cpu"), "update_graph"),
    "step": (StepGraph, "graph"),
}


def test_static_inputs_take_the_capturing_calls_dense_layout(monkeypatch):
    """The buffers (``torch.empty_like`` of each input) take the update's
    inputs as ``BatchedSAC._update`` lays them out, element for element: an
    agent-first view keeps its strides, the expanded ``done`` becomes a
    dense (A, N) buffer, and an empty input gets no copy. A later call's
    contiguous inputs copy in alike; a buffer handed back is not copied."""
    batch, noise = update_case.update_inputs(5, 36, 1, 64, 3, "cpu")
    inputs = (*batch, *noise, torch.zeros((5, 0)))
    graph = graphs.Graph("test")
    statics = graph._buffers(inputs)
    copied = []
    shipped = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_", lambda dst, src: (copied.append(len(dst)),
                                                                   shipped(dst, src)))
    graph._load(inputs)
    assert copied == [7]
    assert all(torch.equal(buf, x) for buf, x in zip(statics, inputs))
    assert [b.stride() for b in statics[:4]] == [x.stride() for x in inputs[:4]]
    assert batch[4].stride()[0] == 0 and statics[4].is_contiguous()
    later = [x.contiguous() + 1 for x in inputs]
    graph._load(later)
    assert all(torch.equal(buf, x) for buf, x in zip(statics, later))
    graph._load([*statics[:3], *later[3:]])
    assert copied == [7, 7, 4]


def test_key_leaves_out_strides_and_names_same_by_identity():
    x = torch.arange(12.0).reshape(4, 3)
    row = torch.arange(3.0)
    key = graphs.key_of([x.t(), row[None].expand(4, 3)], (0.2, "names"), (sac, x))
    assert graphs.key_of([x.t().contiguous(), row[None].repeat(4, 1)], (0.2, "names"),
                         (sac, x)) == key
    for changed in (([x, row[None].expand(4, 3)], (0.2, "names"), (sac, x)),
                    ([x.t().double(), row[None].expand(4, 3)], (0.2, "names"), (sac, x)),
                    ([x.t(), row[None].expand(4, 3)], (0.3, "names"), (sac, x)),
                    ([x.t(), row[None].expand(4, 3)], (0.2, "names"), (sac, x.clone()))):
        assert graphs.key_of(*changed) != key
    with torch.inference_mode():
        assert graphs.key_of([x.t(), row[None].expand(4, 3)], (0.2, "names"), (sac, x)) != key


@pytest.mark.parametrize("case", ["update", "plain", "checks", "parity"])
def test_cpu_runs_eagerly(case, request):
    """On the CPU the update runs eagerly, and so does the step, plain,
    with the physics checks on and in the parity mode: each equal to its
    eager call, with no span of the graph's and no graph kept."""
    if case == "update":
        rec, graph = update_case.eager_updates()
    else:
        rec, graph = step_case.eager_steps(case, request.getfixturevalue("battery_schema"),
                                           request.getfixturevalue("lstm_schema"))
    assert update_case.spans(rec, f"{graph.prefix}.graph", f"{graph.prefix}.capture") == (0, 0)
    assert graph.key is None and graph.captured is None


@pytest.mark.parametrize("owner", list(OWNERS))
def test_copies_start_without_a_graph(owner):
    """A copy or a pickle (the CLI pickles the host-loop agents) of an
    owner whose graph holds a capture, which can be neither copied nor
    pickled, holds a fresh graph of the same spans."""
    make, attr = OWNERS[owner]
    ours = make()
    graph = getattr(ours, attr)
    graph.key, graph.captured = ("a key",), threading.Lock()
    for copied in (copy.deepcopy(ours), pickle.loads(pickle.dumps(ours))):
        fresh = getattr(copied, attr)
        assert isinstance(fresh, graphs.Graph) and fresh.prefix == graph.prefix
        assert fresh.key is None and fresh.captured is None
    assert getattr(ours, attr) is graph
    if owner == "update":
        assert torch.equal(copied.policy.mean_w, ours.policy.mean_w)
        assert "update_graph" not in ours.state_dict()
