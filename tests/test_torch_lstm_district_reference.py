"""The port on the LSTM-dynamics district (``challenge2023_phase1``'s shape:
3 ``LSTMDynamicsBuilding``s, a 2-layer LSTM of 8 units over 12 hours of 12
channels) against the benchmark's independent plain-PyTorch reference
(``benchmark/reference/lstm_district.py`` and ``train_scan.py``), with
seeded weights, on the CPU at a small size: D=8 districts, 96 rows,
48-step episodes, nets 32x32, batch 32.

- ``district_step`` hour by hour under seeded actions, from several
  episode windows: the encoded observations, the rewards, the indoor
  temperature, the net consumption, the cooling demand and what the heat
  pump delivered, the LSTM's ``h``, ``c`` and window,
  and the battery's and DHW tank's states of charge;
- ``BatchedSAC.train`` on ``collect="scan"`` against the reference
  trainer: each update's losses, the actions and rewards written to the
  replay, the district state and the networks after, within one episode
  and across its end and reset;
- the per-step collect's spans (``train.step``, ``step.partial_load``,
  ``step.dynamics``).

Tolerances: both sides compute in float32 in other orders of the same
sums (the LSTM's two biases, the batched products), so the physics and
the LSTM agree to a few float32 rounding steps (``rtol`` 1e-5, ``atol``
1e-5 on values of order 1-30); the trainer's networks, fed those
values through up to 40 Adam updates, to 1e-4.

The ``gpu`` test runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_lstm_district_reference.py``:
the SAC update's CUDA graph against the eager update, ``torch.equal``, at
the per-step cadence on this district's action layout."""

import copy

import pytest
import torch

import citylearn_tpu_torch.train as train_mod
from benchmark.reference import lstm_district, sac as ref_sac
from benchmark.reference.train import Draws, Job
from benchmark.reference.train_scan import ReferenceScanTrainer
from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.agents import sac
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.synthetic import write_lstm_dataset
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

D, ROWS, EPISODE = 8, 96, 48
JOB = Job(n_districts=D, hidden=(32, 32), batch_size=32, replay_slots=64, warmup_steps=8,
          chunk=8, episode_time_steps=EPISODE)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return write_lstm_dataset(str(tmp_path_factory.mktemp("lstm")), n_buildings=3,
                              n_rows=ROWS, seed=5, hidden_size=8, num_layers=2, lookback=12)


def trainer(schema, seed, device="cpu"):
    cfg = TrainConfig(n_districts=JOB.n_districts, hidden=JOB.hidden, batch_size=JOB.batch_size,
                      replay_capacity=JOB.n_districts * JOB.replay_slots,
                      warmup_steps=JOB.warmup_steps, collect="scan")
    return BatchedSAC(schema, cfg, seed=seed, device=device, episode_time_steps=EPISODE)


def seeded(tr, seed):
    """The trainer with seeded networks, and those networks."""
    g = torch.Generator(device=tr.device).manual_seed(seed)
    nets = ref_sac.init_params(tr.env_cfg.n_buildings, tr.obs_dim, tr.act_dim, JOB.hidden, g,
                               tr.device)
    with torch.no_grad():
        for name in ("q1", "q2", "policy"):
            for leaf, p in getattr(tr.state.nets, name).named_parameters():
                p.copy_(nets[name][leaf])
        for name in ("q1", "q2"):
            for leaf, p in getattr(tr.state.nets, f"{name}_target").named_parameters():
                p.copy_(nets[name][leaf])
    return nets


def close(ours, theirs, what, **tol):
    torch.testing.assert_close(ours, theirs.to(ours.dtype), msg=lambda m: f"{what}: {m}",
                               **(tol or TOL))


# --- the district hour by hour ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_district_step_matches_the_reference(schema, seed):
    tr = trainer(schema, seed)
    d = lstm_district.load(schema, "cpu")
    table = lstm_district.observation_table(d)
    low, high = lstm_district.action_bounds(d)
    torch.testing.assert_close(tr.act_low, low)
    torch.testing.assert_close(tr.act_high, high)
    assert d.action_names == list(tr.spec.buildings[0].active_actions)

    offsets = Draws(seed, "cpu").offsets(0, 5, D, ROWS - EPISODE)
    ours = tr._broadcast_initial(offsets.int())
    ref = lstm_district.initial(d, offsets)
    g = torch.Generator().manual_seed(seed)
    warm = 0
    for t in range(EPISODE - 1):
        close(tr._encoded_obs(ours).reshape(D, -1), table[ref.offset + ref.t], f"obs {t}")
        a = low + torch.rand((D,) + tuple(low.shape), generator=g) * (high - low)
        ours, out = district_step(tr.env_cfg, tr.params, ours, tr._actions_dict(a))
        ref, r = lstm_district.step(d, ref, a)
        close(out.indoor_temperature, r.temperature, f"temperature {t}")
        close(out.reward, r.reward, f"reward {t}")
        close(out.net_electricity_consumption, r.net, f"net {t}")
        close(out.cooling_demand_actual, r.cooling_demand, f"cooling demand {t}")
        close(out.cooling_demand_met, r.cooling, f"cooling delivered {t}")
        close(ours.battery_soc, ref.soc, f"battery soc {t}")
        close(ours.dhw_storage_soc, ref.dhw_soc, f"dhw soc {t}")
        close(ours.lstm_h[0].permute(1, 2, 0, 3), ref.h, f"h {t}")
        close(ours.lstm_c[0].permute(1, 2, 0, 3), ref.c, f"c {t}")
        close(ours.dyn_input[0].permute(1, 0, 3, 2), ref.window, f"window {t}")
        warm += bool(ref.h.abs().max() > 0)
    # the LSTM predicted (t >= lookback) and partial load set the demand
    assert warm == EPISODE - 1 - 12


# --- the trainer ----------------------------------------------------------------------

def reference_trainer(schema, seed, nets, n_steps):
    job = Job(**{**JOB.__dict__, "chunk": n_steps})
    ref = ReferenceScanTrainer(schema, job, seed, nets, "cpu")
    ref.train_call()
    return ref


@pytest.mark.parametrize("n_steps", [24, 56], ids=["one-episode", "across-the-reset"])
def test_training_matches_the_reference_trainer(schema, n_steps, monkeypatch):
    seed = 11
    tr = trainer(schema, seed)
    nets = seeded(tr, seed)
    shipped, losses = train_mod.sac_update, []
    monkeypatch.setattr(train_mod, "sac_update",
                        lambda *a, **kw: losses.append(shipped(*a, **kw)) or losses[-1])
    tr.train(n_steps, chunk=8)
    ref = reference_trainer(schema, seed, nets, n_steps)

    theirs = ref.record.losses[0]
    assert len(losses) == len(theirs) == n_steps - JOB.warmup_steps
    for i, (p, r) in enumerate(zip(losses, theirs)):
        for k in ("q1", "q2", "policy"):
            close(p[k], r[k], f"update {i} {k} loss", rtol=1e-4, atol=1e-4)
    ts = tr.state
    close(ts.replay_act[:n_steps], ref.stacked("action"), "actions", rtol=1e-4, atol=1e-5)
    close(ts.replay_rew[:n_steps], ref.stacked("reward"), "rewards", rtol=1e-4, atol=1e-4)
    close(ts.replay_done[:n_steps], ref.stacked("done")[:, None].expand(-1, D), "done")
    assert int(ts.replay_done.sum()) == D * (n_steps > EPISODE - 1)
    es = ts.env_state
    assert torch.equal(es.data_offset.long(), ref.state.offset)
    assert int(es.t[0]) == ref.state.t == (n_steps if n_steps < EPISODE - 1 else n_steps - EPISODE + 1)
    close(es.battery_soc, ref.state.soc, "battery soc", rtol=1e-4, atol=1e-5)
    close(es.dhw_storage_soc, ref.state.dhw_soc, "dhw soc")
    close(es.lstm_h[0].permute(1, 2, 0, 3), ref.state.h, "h", rtol=1e-4, atol=1e-5)
    for name in ("q1", "q2", "policy"):
        for leaf, p in getattr(ts.nets, name).named_parameters():
            close(p.detach(), ref.agents.trained()[name][leaf], f"{name}.{leaf}",
                  rtol=1e-4, atol=1e-5)


def test_per_step_collect_spans(schema):
    tr = trainer(schema, 3)
    with tracing.recording() as rec:
        tr.train(16, chunk=8)
    spans = rec.spans
    names = [s.name for s in spans]
    by_id = {s.id: s for s in spans}
    assert names.count("train.step") == 16
    assert names.count("step.partial_load") == names.count("step.dynamics") == 16
    assert names.count("train.update") == 16 - JOB.warmup_steps
    for s in spans:
        if s.name in ("step.partial_load", "step.dynamics", "train.update"):
            assert by_id[s.parent].name == "train.step", s.name
        if s.name == "train.step":
            assert by_id[s.parent].name == "train.call"


# --- the card ----------------------------------------------------------------------------

@pytest.mark.gpu
def test_graph_is_bit_equal_to_eager_on_this_districts_actions(schema, monkeypatch):
    """Every update of a per-step trainer on the card (3 agents, 3 action
    slots each, ``cooling_device`` in [0, 1]; nets 256x256, batch 256)
    against ``_sac_step`` on a copy of the nets taken just before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update's graph is a CUDA graph")
    cfg = TrainConfig(n_districts=128, hidden=(256, 256), batch_size=256,
                      replay_capacity=128 * 64, warmup_steps=8, collect="scan")
    tr = BatchedSAC(schema, cfg, seed=3, device="cuda", episode_time_steps=EPISODE)
    assert (tr.env_cfg.n_buildings, tr.act_dim) == (3, 3)
    assert float(tr.act_low[0, 2]) == 0.0 and float(tr.act_high[0, 2]) == 1.0
    shipped, seen = train_mod.sac_update, []

    def compared(nets, batch, noise, *args, **kw):
        ref = copy.deepcopy(nets)
        out = shipped(nets, batch, noise, *args, **kw)
        theirs = sac._sac_step(ref, batch, noise, *args, **kw)
        for k in sac.LOSSES:
            assert torch.equal(out[k], theirs[k]), k
        for name in sac.AgentNets.NETS:
            for (leaf, p), q in zip(getattr(nets, name).named_parameters(),
                                    getattr(ref, name).parameters()):
                assert torch.equal(p, q), f"{name}.{leaf}"
        seen.append(nets.update_graph.key is not None)
        return out

    monkeypatch.setattr(train_mod, "sac_update", compared)
    with tracing.recording() as rec:
        tr.train(24, chunk=24)
    names = [s.name for s in rec.spans]
    assert len(seen) == 24 - 8 and all(seen[1:])
    assert names.count("sac.graph") == 24 - 8 - 1 and names.count("sac.capture") == 1
