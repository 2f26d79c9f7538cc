"""The port's ``BatchedSAC`` on the neighborhood districts against the JAX
package's: the synthetic EULP shape (6 LSTM buildings, the signed
``cooling_or_heating_device`` action, the default reward), the synthetic
quebec shape (3 occupant buildings, heating-side partial load, no battery,
the ComfortReward) and ``tests/golden/quebec_occ`` (real decision trees,
6480 rows: shifted windows up to offset 6432). Construction, 60 warmup
steps with the JAX trainer's draws fed in (one per-district reset: a
shifted window starts from offset 0's LSTM lookback and occupant state, as
in the reference trainer), the KPI table of carried networks, and training
past warmup. Tolerances as in ``tests/_train_parity.py``."""

import os
import warnings

import numpy as np
import pytest
import torch

import _train_parity as tp
from citylearn_tpu_torch.synthetic import write_neighborhood_dataset
from citylearn_tpu_torch.train import StepDraws, train_state_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "quebec_occ", "schema.json")
# (obs_dim, act_dim, max_offset, under the ComfortReward)
SHAPES = {"eulp": (37, 2, 152, False), "quebec": (37, 1, 152, True),
          "golden": (19, 1, 6432, True)}


def write(name, root):
    if name == "golden":
        return GOLDEN
    return write_neighborhood_dataset(root, 6 if name == "eulp" else 3, 200,
                                      quebec=name == "quebec")


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request, tmp_path_factory):
    """(name, schema, JAX trainer after warmup, its state before and after)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the synthetic quebec shape has no trees
        schema = write(request.param, str(tmp_path_factory.mktemp(request.param)))
        ref = tp.jax_trainer(schema, warmup_steps=10**9)
    start = tp.as_numpy(ref.state)
    ref.train(tp.WARM, chunk=tp.WARM)
    return request.param, schema, ref, start, tp.as_numpy(ref.state)


def port(schema, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tp.port_trainer(schema, **kw)


def test_construction_matches_jax(case):
    name, schema, ref, _, _ = case
    ours = port(schema)
    tp.assert_construction_matches(ours, ref)
    assert (ours.obs_dim, ours.act_dim, ours.max_offset) == SHAPES[name][:3]
    assert ours.env_cfg.has_dynamics and ours.env_cfg.has_occupant == (name != "eulp")
    assert not ours.use_kernel_collect


def test_warmup_transitions_match_jax(case):
    name, schema, ref, start, end = case
    ours = port(schema, warmup_steps=10**9)
    ours.load_state(train_state_from_numpy(start, device="cpu"))
    ours.draws = tp.FedDraws(end.replay_act, {StepDraws.RESET: end.env_state.data_offset})
    ours.train(tp.WARM, chunk=30)
    tp.assert_train_states_close(ours.state, end, comfort=SHAPES[name][3])
    assert len(np.unique(end.env_state.data_offset)) > 1
    # the windows drawn stay inside the data
    assert int(end.env_state.data_offset.max()) <= ours.max_offset


def test_evaluate_matches_jax(case):
    _, schema, ref, _, _ = case
    ref.state = ref.state._replace(nets=tp.acting_nets(ref.state.nets))
    ours = port(schema)
    ours.load_state(train_state_from_numpy(tp.as_numpy(ref.state), device="cpu"))
    ours.draws = tp.FedDraws(offsets={StepDraws.EVAL: tp.eval_offsets(ref)})
    n = 24
    table, jtable = ours.evaluate(n_steps=n), ref.evaluate(n_steps=n)
    tp.assert_tables_match(table, jtable, n)


def test_scripted_evaluate_takes_the_kernel_path(case, monkeypatch):
    plans = {"cooling_or_heating_device": np.where(tp.HOURS < 12, 0.6, -0.5),
             "heating_device": np.where(tp.HOURS < 8, 0.3, 0.1),
             "electrical_storage": tp.NIGHT}
    tp.assert_scripted_takes_the_kernel_path(port(case[1]), plans, monkeypatch)


def test_trains_past_warmup(case):
    tr = port(case[1], warmup_steps=8)
    w0 = tr.state.nets.policy.mean_w.detach().clone()
    q0 = tr.state.nets.q1_target.w[0].detach().clone()
    hist = tr.train(24, chunk=12)
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert (tr.state.nets.policy.mean_w - w0).abs().max() > 0, "the policy never updated"
    assert (tr.state.nets.q1_target.w[0] - q0).abs().max() > 0, "the targets never moved"
    assert torch.isfinite(tr.state.replay_rew).all()


def test_central_agent_raises(case):
    with pytest.raises(ValueError, match="decentralized"):
        port(case[1], trainer_kw=dict(central_agent=True))
