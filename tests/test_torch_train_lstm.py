"""The port's ``BatchedSAC`` on LSTM-dynamics districts against the JAX
package's: the plain district (3 buildings, the ``cooling_device``
partial-load action, the ComfortReward) and the heterogeneous one (a
fourth building of another LSTM shape with a cooling tank, so actions pad
to a common width). Construction, 60 warmup steps with the JAX trainer's
draws fed in (one per-district reset: a shifted window starts from offset
0's LSTM lookback, as in the reference trainer), the KPI table of carried
networks, training past warmup, and padded action dims that stay 0.
Tolerances as in ``tests/_train_parity.py`` (the LSTM's on its carry and
the reward)."""

import numpy as np
import pytest
import torch

import _train_parity as tp
from citylearn_tpu_torch.synthetic import write_lstm_dataset
from citylearn_tpu_torch.train import StepDraws, train_state_from_numpy

KINDS = {"plain": {}, "heterogeneous": {"heterogeneous": True}}
WIDTHS = {"plain": (37, 3), "heterogeneous": (38, 4)}


@pytest.fixture(scope="module", params=sorted(KINDS))
def case(request, tmp_path_factory):
    """(kind, schema, JAX trainer after warmup, its state before and after)."""
    schema = write_lstm_dataset(str(tmp_path_factory.mktemp(request.param)), n_rows=200,
                                lookback=4, **KINDS[request.param])
    ref = tp.jax_trainer(schema, warmup_steps=10**9)
    start = tp.as_numpy(ref.state)
    ref.train(tp.WARM, chunk=tp.WARM)
    return request.param, schema, ref, start, tp.as_numpy(ref.state)


def test_construction_matches_jax(case):
    kind, schema, ref, _, _ = case
    ours = tp.port_trainer(schema)
    tp.assert_construction_matches(ours, ref)
    assert (ours.obs_dim, ours.act_dim, ours.max_offset) == WIDTHS[kind] + (152,)
    assert ours.env_cfg.has_dynamics and ours.w_ch is None and ours.w_wm is None
    assert not ours.use_kernel_collect


def test_warmup_transitions_match_jax(case):
    _, schema, ref, start, end = case
    ours = tp.port_trainer(schema, warmup_steps=10**9)
    ours.load_state(train_state_from_numpy(start, device="cpu"))
    ours.draws = tp.FedDraws(end.replay_act, {StepDraws.RESET: end.env_state.data_offset})
    ours.train(tp.WARM, chunk=30)
    tp.assert_train_states_close(ours.state, end, comfort=True)
    assert len(np.unique(end.env_state.data_offset)) > 1
    # the LSTM carry moved after the reset
    assert float(ours.state.env_state.lstm_h[0].abs().max()) > 0


def test_evaluate_matches_jax(case):
    _, schema, ref, _, _ = case
    ref.state = ref.state._replace(nets=tp.acting_nets(ref.state.nets))
    ours = tp.port_trainer(schema)
    ours.load_state(train_state_from_numpy(tp.as_numpy(ref.state), device="cpu"))
    ours.draws = tp.FedDraws(offsets={StepDraws.EVAL: tp.eval_offsets(ref)})
    n = 24
    table, jtable = ours.evaluate(n_steps=n), ref.evaluate(n_steps=n)
    tp.assert_tables_match(table, jtable, n)


def test_scripted_evaluate_takes_the_kernel_path(case, monkeypatch):
    plans = {"cooling_device": np.where(tp.HOURS < 12, 0.8, 0.4),
             "dhw_storage": np.full(24, 0.05), "electrical_storage": tp.NIGHT}
    tp.assert_scripted_takes_the_kernel_path(tp.port_trainer(case[1]), plans, monkeypatch)


def test_trains_past_warmup(case):
    kind, schema = case[:2]
    tr = tp.port_trainer(schema, warmup_steps=8)
    w0 = tr.state.nets.policy.mean_w.detach().clone()
    q0 = tr.state.nets.q1_target.w[0].detach().clone()
    hist = tr.train(24, chunk=12)
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert (tr.state.nets.policy.mean_w - w0).abs().max() > 0, "the policy never updated"
    assert (tr.state.nets.q1_target.w[0] - q0).abs().max() > 0, "the targets never moved"
    assert torch.isfinite(tr.state.replay_rew).all()
    padded = tr.act_mask == 0
    assert bool(padded.any()) == (kind == "heterogeneous")
    # padded action dims stay exactly 0, in warmup and under the policy
    acts = tr.state.replay_act[:24]
    assert int(torch.count_nonzero(acts[:, :, padded])) == 0
    assert float(acts[8:24][:, :, ~padded].abs().max()) > 0


def test_central_agent_raises(case):
    with pytest.raises(ValueError, match="decentralized"):
        tp.port_trainer(case[1], trainer_kw=dict(central_agent=True))
