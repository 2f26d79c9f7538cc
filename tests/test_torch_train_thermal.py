"""The port's ``BatchedSAC`` on a thermal-storage district (cooling and DHW
devices and tanks, battery, PV) against the JAX package's: construction,
60 warmup steps with the JAX trainer's draws fed in (one per-district
reset; the tank SOCs carried), the KPI table of carried networks, and
training past warmup. Tolerances as in ``tests/_train_parity.py``."""

import numpy as np
import pytest
import torch

import _train_parity as tp
from citylearn_tpu_torch.synthetic import write_thermal_dataset
from citylearn_tpu_torch.train import StepDraws, train_state_from_numpy


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return write_thermal_dataset(str(tmp_path_factory.mktemp("thermal")), 3, 200)


@pytest.fixture(scope="module")
def jax_warmup(schema):
    ref = tp.jax_trainer(schema, warmup_steps=10**9)
    start = tp.as_numpy(ref.state)
    ref.train(tp.WARM, chunk=tp.WARM)
    return ref, start, tp.as_numpy(ref.state)


def test_construction_matches_jax(schema, jax_warmup):
    ours = tp.port_trainer(schema)
    tp.assert_construction_matches(ours, jax_warmup[0])
    assert (ours.obs_dim, ours.act_dim, ours.max_offset) == (30, 3, 152)
    assert not ours.use_kernel_collect


def test_warmup_transitions_match_jax(schema, jax_warmup):
    _, start, end = jax_warmup
    ours = tp.port_trainer(schema, warmup_steps=10**9)
    ours.load_state(train_state_from_numpy(start, device="cpu"))
    ours.draws = tp.FedDraws(end.replay_act, {StepDraws.RESET: end.env_state.data_offset})
    ours.train(tp.WARM, chunk=30)
    tp.assert_train_states_close(ours.state, end)
    assert len(np.unique(end.env_state.data_offset)) > 1
    # the tanks moved from their initial charge
    st, st0 = ours.state.env_state, tp.as_numpy(start.env_state)
    assert float((st.cooling_storage_soc - torch.tensor(st0.cooling_storage_soc)).abs().max()) > 0
    assert float((st.dhw_storage_soc - torch.tensor(st0.dhw_storage_soc)).abs().max()) > 0


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
    plans = {"cooling_storage": tp.NIGHT, "dhw_storage": tp.NIGHT,
             "electrical_storage": tp.NIGHT}
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


def test_central_agent_raises(schema):
    with pytest.raises(ValueError, match="decentralized"):
        tp.port_trainer(schema, trainer_kw=dict(central_agent=True))
