"""The port's ``BatchedSAC`` on an EV district (chargers with electric
vehicles, a washing machine, the EV reward) against the JAX package's:
construction and action routing (a charger's ``electric_vehicle_storage``
and the machine's action), 60 warmup steps with the JAX trainer's draws
fed in (one per-district reset; no EV docks before step 16 of an episode,
so the reward is zero until then and the steps run past it), the KPI
table of carried networks, and training past warmup. Tolerances as in
``tests/_train_parity.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import _train_parity as tp
from citylearn_tpu_torch import train
from citylearn_tpu_torch.synthetic import write_ev_dataset
from citylearn_tpu_torch.train import StepDraws, train_state_from_numpy

EV_REWARD_FROM = 16          # the first episode step at which an EV is docked


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return write_ev_dataset(str(tmp_path_factory.mktemp("ev")), 4, 3, 4, 1, 200)


@pytest.fixture(scope="module")
def jax_warmup(schema):
    """The JAX trainer's state before and after WARM warmup steps."""
    ref = tp.jax_trainer(schema, warmup_steps=10**9)
    start = tp.as_numpy(ref.state)
    ref.train(tp.WARM, chunk=tp.WARM)
    return ref, start, tp.as_numpy(ref.state)


def test_construction_matches_jax(schema, jax_warmup):
    ours = tp.port_trainer(schema)
    tp.assert_construction_matches(ours, jax_warmup[0])
    assert (ours.obs_dim, ours.act_dim, ours.max_offset) == (43, 3, 152)
    assert ours.w_ch.shape == (4, 3, 3) and ours.w_wm.shape == (4, 3, 1)
    # every charger and the machine take exactly one (building, slot)
    assert torch.equal(ours.w_ch.sum((0, 1)), torch.ones(3))
    assert torch.equal(ours.w_wm.sum((0, 1)), torch.ones(1))
    assert not ours.use_kernel_collect


def test_actions_route_to_chargers_and_machine(schema, jax_warmup):
    ours, ref = tp.port_trainer(schema), jax_warmup[0]
    a = np.random.RandomState(0).uniform(-1, 1, (tp.D, 4, 3)).astype(np.float32)
    a *= ours.act_mask.numpy()
    got, want = ours._actions_dict(torch.tensor(a)), ref._actions_dict(a)
    assert set(got) == set(want) and {"electric_vehicle_storage", "washing_machine"} <= set(got)
    assert got["electric_vehicle_storage"].shape == (tp.D, 3)
    assert got["washing_machine"].shape == (tp.D, 1)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_warmup_transitions_match_jax(schema, jax_warmup):
    ref, start, end = jax_warmup
    ours = tp.port_trainer(schema, warmup_steps=10**9)
    ours.load_state(train_state_from_numpy(start, device="cpu"))
    ours.draws = tp.FedDraws(end.replay_act, {StepDraws.RESET: end.env_state.data_offset})
    ours.train(tp.WARM, chunk=30)
    tp.assert_train_states_close(ours.state, end)
    assert len(np.unique(end.env_state.data_offset)) > 1
    # the EV reward: zero before the first docking, then non-zero
    rew = ours.state.replay_rew[:tp.WARM]
    assert float(rew[:EV_REWARD_FROM].abs().max()) == 0.0
    assert float(rew[EV_REWARD_FROM:tp.EPISODE - 1].abs().max()) > 0.0
    assert float(ours.state.env_state.ev_soc.std()) > 0.0


def test_evaluate_matches_jax(schema, jax_warmup):
    ref = jax_warmup[0]
    ref.state = ref.state._replace(nets=tp.acting_nets(ref.state.nets))
    ours = tp.port_trainer(schema)
    ours.load_state(train_state_from_numpy(tp.as_numpy(ref.state), device="cpu"))
    ours.draws = tp.FedDraws(offsets={StepDraws.EVAL: tp.eval_offsets(ref)})
    n = 30
    table, jtable = ours.evaluate(n_steps=n), ref.evaluate(n_steps=n)
    tp.assert_tables_match(table, jtable, n)
    assert not np.allclose(table["district|cost_total"].numpy(), 1.0)


def test_scripted_evaluate_takes_the_kernel_path(schema, monkeypatch):
    plans = {"electrical_storage": tp.NIGHT,
             "electric_vehicle_storage": np.tile(np.where(tp.HOURS < 9, 0.8, -0.4)[:, None],
                                                 (1, 3)),
             "washing_machine": np.ones(24)}
    tp.assert_scripted_takes_the_kernel_path(tp.port_trainer(schema), plans, monkeypatch)


def test_trains_past_warmup(schema):
    tr = tp.port_trainer(schema, warmup_steps=8)
    w0 = tr.state.nets.policy.mean_w.detach().clone()
    q0 = tr.state.nets.q1_target.w[0].detach().clone()
    hist = tr.train(24, chunk=12)
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert (tr.state.nets.policy.mean_w - w0).abs().max() > 0, "the policy never updated"
    assert (tr.state.nets.q1_target.w[0] - q0).abs().max() > 0, "the targets never moved"
    assert torch.isfinite(tr.state.replay_rew).all()
    # the policy's charger actions reach the district
    assert float(tr.state.replay_act[8:24].abs().max()) > 0


def test_unknown_action_and_central_agent_raise(schema, monkeypatch):
    with pytest.raises(ValueError, match="decentralized"):
        tp.port_trainer(schema, trainer_kw=dict(central_agent=True))
    compile_schema = train.compile_schema

    def with_unknown_action(*args, **kw):
        spec = compile_schema(*args, **kw)
        b = spec.buildings[1]
        spec.buildings[1] = dataclasses.replace(
            b, active_actions=list(b.active_actions) + ["unknown_device"],
            action_low=list(b.action_low) + [-1.0], action_high=list(b.action_high) + [1.0])
        return spec

    monkeypatch.setattr(train, "compile_schema", with_unknown_action)
    with pytest.raises(NotImplementedError, match="trainer action routing for unknown_device"):
        tp.port_trainer(schema)
