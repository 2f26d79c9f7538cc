"""``sac_update``'s CUDA graph (``citylearn_tpu_torch.agents.sac``).

On a CUDA card the update is a replay of one captured graph, which must be
bit-equal (``torch.equal``) to the same update run eagerly by
``_sac_step`` on a ``copy.deepcopy`` of the nets: the losses, every
gradient, every parameter and target, and Adam's moments and step count,
through a key's eager first update, its capture and its replays; after
``load_state_dict`` and ``BatchedSAC.restore_checkpoint`` (which replace
the state tensors a graph read); for another batch size and for the
host-loop SAC's one agent without a mask. On the CPU a caller that wraps
the module global ``citylearn_tpu_torch.train.sac_update`` sees each
update once. The graph's mechanism, shared with the district step, and
what it does alike for both (the CPU runs eagerly; copies start without a
graph) are tested in ``test_torch_graphs.py``.

This file imports no JAX: the ``gpu`` tests run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_sac_graph.py``."""

import copy

import pytest
import torch

import citylearn_tpu_torch.train as train_mod
from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.agents import sac
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

EAGER_SPANS = ("sac.target", "sac.critic", "sac.policy", "sac.polyak")
HP = dict(alpha=0.2, discount=0.99, tau=5e-3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), 5, 200, seed=1)


def trainer(dataset, device, hidden=(16, 16)):
    cfg = TrainConfig(n_districts=128, hidden=hidden, batch_size=32, replay_capacity=128 * 64,
                      warmup_steps=8, collect="kernel")
    return BatchedSAC(dataset, cfg, seed=3, episode_time_steps=48, device=device)


def update_inputs(A, K, M, N, seed, device, laid_out=True):
    """A batch and noise; ``laid_out`` as ``BatchedSAC._update`` lays them
    out (agent-first views of row-major replay rows, ``done`` expanded,
    both noises views of one draw), else contiguous as the host-loop SAC
    hands them."""
    g = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=g, device=device)
    if not laid_out:
        batch = (draw(A, N, K), draw(A, N, M).tanh(), draw(A, N), draw(A, N, K),
                 (draw(A, N) > 1.5).float())
        return batch, (draw(A, N, M), draw(A, N, M))
    obs, act, rew, nxt = draw(N, A * K), draw(N, A, M).tanh(), draw(N, A), draw(N, A * K)
    done = (draw(N) > 1.5).float()
    agents_first = lambda x: x.view(N, A, -1).transpose(0, 1)
    noise = draw(2, A, N, M)
    return ((agents_first(obs), act.transpose(0, 1), rew.t(), agents_first(nxt),
             done[None].expand(A, N)), (noise[0], noise[1]))


def action_bounds(A, M, device):
    g = torch.Generator(device=device).manual_seed(11)
    scale = torch.rand((A, M), generator=g, device=device) + 0.5
    bias = torch.rand((A, M), generator=g, device=device) - 0.5
    mask = torch.ones((A, M), device=device)
    mask[0, -1] = 0.0
    return scale * mask, bias * mask, mask


def assert_nets_equal(ours: sac.AgentNets, ref: sac.AgentNets):
    for name in sac.AgentNets.NETS:
        for (leaf, p), q in zip(getattr(ours, name).named_parameters(),
                                getattr(ref, name).parameters()):
            assert torch.equal(p, q), f"{name}.{leaf}"
            if name in sac.LOSSES:
                assert torch.equal(p.grad, q.grad), f"{name}.{leaf} gradient"
    for name in sac.AgentNets.OPTS:
        ours_opt, ref_opt = getattr(ours, name), getattr(ref, name)
        for p, q in zip(ours_opt.param_groups[0]["params"], ref_opt.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(ours_opt.state[p][k], ref_opt.state[q][k]), f"{name} {k}"


def step_both(nets, ref, inputs, consts):
    batch, noise = inputs
    ours = sac.sac_update(nets, batch, noise, *consts, **HP)
    theirs = sac._sac_step(ref, batch, noise, *consts, **HP)
    for k in sac.LOSSES:
        assert torch.equal(ours[k], theirs[k]), k
    assert_nets_equal(nets, ref)


def spans(rec, *names):
    seen = [s.name for s in rec.spans]
    return tuple(seen.count(n) for n in names)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update's graph is a CUDA graph")


def eager_updates():
    """Three updates on the CPU; (their recording, the nets' graph) for
    ``test_torch_graphs.py::test_cpu_runs_eagerly``."""
    gen = torch.Generator().manual_seed(0)
    nets = sac.make_agent_nets(3, 7, 2, (16, 16), 3e-4, gen, "cpu")
    assert not any(g["capturable"] for k in nets.OPTS for g in getattr(nets, k).param_groups)
    batch, noise = update_inputs(3, 7, 2, 32, 1, "cpu")
    with tracing.recording() as rec:
        for _ in range(3):
            sac.sac_update(nets, batch, noise, *action_bounds(3, 2, "cpu"), **HP)
    assert spans(rec, *EAGER_SPANS) == (3, 3, 3, 3)
    return rec, nets.update_graph


# --- the CPU ---------------------------------------------------------------------


def test_wrapped_global_sees_each_update_once(dataset, monkeypatch):
    """The benchmark's recorder wraps ``train.sac_update``: one call an
    update, each returning that update's losses, as ``_sac_step`` computes
    them on a copy of the nets taken just before it."""
    tr = trainer(dataset, "cpu")
    shipped, calls = train_mod.sac_update, []

    def recorded(nets, batch, noise, *args, **kw):
        ref = copy.deepcopy(nets)
        out = shipped(nets, batch, noise, *args, **kw)
        expected = sac._sac_step(ref, batch, noise, *args, **kw)
        calls.append(all(torch.equal(out[k], expected[k]) for k in sac.LOSSES))
        assert_nets_equal(nets, ref)
        return out

    monkeypatch.setattr(train_mod, "sac_update", recorded)
    with tracing.recording() as rec:
        tr.train(30, chunk=30)
    assert spans(rec, "train.update") == (30 - 8,)
    assert len(calls) == 30 - 8 and all(calls)


@pytest.mark.parametrize("saved_capturable", [False, True], ids=["cpu-saved", "card-saved"])
def test_loaded_state_fits_the_device(saved_capturable):
    """A state saved on the card (capturable Adam, its step on the card)
    loads into CPU nets as a plain Adam with its step on the CPU, updates
    as the state saved on the CPU does, and drops any graph."""
    gen = torch.Generator().manual_seed(0)
    nets = sac.make_agent_nets(2, 5, 1, (8, 8), 3e-4, gen, "cpu")
    batch, noise = update_inputs(2, 5, 1, 16, 2, "cpu", laid_out=False)
    consts = action_bounds(2, 1, "cpu")
    sac.sac_update(nets, batch, noise, *consts, **HP)
    state = copy.deepcopy(nets.state_dict())
    ref = copy.deepcopy(nets)
    if saved_capturable:
        for k in nets.OPTS:
            state[k]["param_groups"][0]["capturable"] = True
    nets.update_graph.key = ("a key",)
    nets.load_state_dict(state)
    assert nets.update_graph.key is None
    for k in nets.OPTS:
        opt = getattr(nets, k)
        assert opt.param_groups[0]["capturable"] is False
        assert all(s["step"].device.type == "cpu" for s in opt.state.values())
    sac.sac_update(nets, batch, noise, *consts, **HP)
    sac.sac_update(ref, batch, noise, *consts, **HP)
    assert_nets_equal(nets, ref)


# --- the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_graph_is_bit_equal_to_eager_at_the_cells_shapes():
    """Eight updates at the benchmark cell's shapes (A=5, K=36, M=1, hidden
    256x256, N=256): the eager first, the capture, six replays."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    nets = sac.make_agent_nets(5, 36, 1, (256, 256), 3e-4, gen, "cuda")
    assert all(getattr(nets, k).param_groups[0]["capturable"] for k in nets.OPTS)
    ref = copy.deepcopy(nets)
    consts = action_bounds(5, 1, "cuda")
    with tracing.recording() as rec:
        for i in range(8):
            step_both(nets, ref, update_inputs(5, 36, 1, 256, 100 + i, "cuda"), consts)
    assert spans(rec, "sac.graph", "sac.capture") == (7, 1)
    # the eager reference's spans, and the first update's and the capture's
    assert spans(rec, *EAGER_SPANS) == (10, 10, 10, 10)


@pytest.mark.gpu
def test_graph_after_load_state_dict():
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    nets = sac.make_agent_nets(5, 36, 1, (64, 64), 3e-4, gen, "cuda")
    ref = copy.deepcopy(nets)
    consts = action_bounds(5, 1, "cuda")
    for i in range(3):
        step_both(nets, ref, update_inputs(5, 36, 1, 256, 200 + i, "cuda"), consts)
    saved = copy.deepcopy(nets.state_dict())
    for i in range(2):
        step_both(nets, ref, update_inputs(5, 36, 1, 256, 300 + i, "cuda"), consts)
    # each its own copy: Adam's load_state_dict keeps the tensors it is given
    nets.load_state_dict(copy.deepcopy(saved))
    ref.load_state_dict(copy.deepcopy(saved))
    assert nets.update_graph.key is None
    with tracing.recording() as rec:
        for i in range(4):
            step_both(nets, ref, update_inputs(5, 36, 1, 256, 400 + i, "cuda"), consts)
    assert spans(rec, "sac.graph", "sac.capture") == (3, 1)


@pytest.mark.gpu
def test_graph_after_restore_checkpoint(dataset, tmp_path, monkeypatch):
    """A trainer whose update has a graph restores a checkpoint and trains
    on bit-equal to a trainer restored from it that runs every update
    eagerly."""
    needs_card()
    tr, ref = trainer(dataset, "cuda"), trainer(dataset, "cuda")
    tr.train(16, chunk=16)
    tr.save_checkpoint(str(tmp_path))
    tr.train(16, chunk=16)
    assert tr.state.nets.update_graph.captured is not None
    tr.restore_checkpoint(str(tmp_path))
    ref.restore_checkpoint(str(tmp_path))
    assert tr.state.nets.update_graph.key is None
    with tracing.recording() as rec:
        tr.train(20, chunk=20)
    assert spans(rec, "train.update", "sac.graph", "sac.capture") == (20, 19, 1)
    monkeypatch.setattr(train_mod, "sac_update", sac._sac_step)
    ref.train(20, chunk=20)
    assert_nets_equal(tr.state.nets, ref.state.nets)


@pytest.mark.gpu
def test_graph_for_another_batch_and_the_host_loop_agent():
    """A batch of another N (a new key: eager, capture, replays) on nets
    that have a graph; and one agent without a mask, contiguous inputs, as
    the host-loop SAC updates."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    nets = sac.make_agent_nets(5, 36, 1, (64, 64), 3e-4, gen, "cuda")
    ref = copy.deepcopy(nets)
    consts = action_bounds(5, 1, "cuda")
    with tracing.recording() as rec:
        for i, n in enumerate((256, 256, 256, 100, 100, 100, 100)):
            step_both(nets, ref, update_inputs(5, 36, 1, n, 500 + i, "cuda"), consts)
    assert spans(rec, "sac.graph", "sac.capture") == (5, 2)

    nets = sac.make_agent_nets(1, 30, 1, (64, 64), 3e-4, gen, "cuda")
    ref = copy.deepcopy(nets)
    scale, bias, _ = action_bounds(1, 1, "cuda")
    with tracing.recording() as rec:
        for i in range(6):
            step_both(nets, ref, update_inputs(1, 30, 1, 64, 600 + i, "cuda", laid_out=False),
                      (scale, bias, None))
    assert spans(rec, "sac.graph", "sac.capture") == (5, 1)


@pytest.mark.gpu
def test_trainer_replays_every_update_after_the_first_call(dataset):
    needs_card()
    tr = trainer(dataset, "cuda", hidden=(256, 256))
    tr.train(64, chunk=64)
    with tracing.recording() as rec:
        tr.train(64, chunk=64)
    assert spans(rec, "train.update", "sac.graph", "sac.capture") == (64, 64, 0)
    assert spans(rec, *EAGER_SPANS) == (0, 0, 0, 0)
