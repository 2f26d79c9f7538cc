"""The port's ``BatchedMARLISA`` (``citylearn_tpu_torch.train_marlisa``)
against the JAX package's on a battery+PV district, and on its own on a
heterogeneous LSTM district.

- The energy coefficients and the capacity dispatched before each agent
  equal JAX's.
- The coordination ring with JAX-drawn noise (``jax.random.split`` of the
  ring's key into one key per (sweep, agent), a normal draw of each, as
  ``citylearn_tpu/agents/sac.py`` draws it) equals JAX's
  ``_coordination_ring``: actions and coordination variables within 1e-5
  of their scale, sampled and deterministic.
- The first agent of a one-sweep ring sees zero total demand.
- 60 warmup steps with JAX's exploration actions and reset windows fed
  in: the delayed-by-one replay rows (the transition across the reset
  dropped), the ridge accumulators within 1e-5 of their scale. The
  weights of the last refit are held by their predictions on the stored
  rows, within 1e-4 of scale: X^T X + 1e-3 I has a condition number above
  1e5 along the encoder's collinear columns (one-hot classes beside the
  constant; asserted), so two solves of it, JAX's in float32 and the
  port's in float64 (``ridge_solve``), part in the weights and agree on
  what the weights predict. The refit alone, on JAX's accumulators,
  leaves a residual within 1e-5 of the right-hand side. At D=4096 a
  float32 system is exactly singular within 8 steps, and the float64
  solve still returns the ridge solution.
- ``evaluate`` with the live ring, carried networks and weights, equals
  JAX's KPI table (1e-5 relative).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import _train_parity as tp
from citylearn_tpu_torch.agents.sac import policy_sample
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset, write_lstm_dataset
from citylearn_tpu_torch.train import StepDraws, train_state_from_numpy
from citylearn_tpu_torch.train_marlisa import (
    COORD_VARS,
    RIDGE,
    MarlisaTrainState,
    marlisa_state_from_numpy,
    ridge_solve,
)

B = 5
EVERY = 8                    # regression_update_every: refits at steps 7, 15, ..., 55


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=0)


def jax_marlisa(schema, **kw):
    return tp.jax_trainer(schema, marlisa=True,
                          trainer_kw=dict(regression_update_every=EVERY), **kw)


def port_marlisa(schema, **kw):
    return tp.port_trainer(schema, marlisa=True,
                           trainer_kw=dict(regression_update_every=EVERY), **kw)


@pytest.fixture(scope="module")
def jax_warmup(schema):
    """The JAX trainer over WARM warmup steps, one step a call: its state
    before, each step's actions and windows, and its state after."""
    ref = jax_marlisa(schema, warmup_steps=10**9)
    start = tp.as_numpy(ref.state)
    actions, offsets = [], []
    for _ in range(tp.WARM):
        ref.train(1, chunk=1)
        actions.append(np.asarray(ref.state.prev_act))
        offsets.append(np.asarray(ref.state.base.env_state.data_offset))
    return ref, start, actions, offsets, tp.as_numpy(ref.state)


def test_coefficients_match_jax(schema, jax_warmup):
    ours, ref = port_marlisa(schema), jax_warmup[0]
    tp.assert_construction_matches(ours, ref)
    assert (ours.obs_dim, ours.enc_dim, ours.reg_dim) == (ref.obs_dim, ref.enc_dim, ref.reg_dim)
    assert ours.obs_dim == ours.enc_dim + COORD_VARS and ours.reg_dim == ours.enc_dim + 2
    np.testing.assert_array_equal(ours.energy_size_coefficient.numpy(),
                                  np.asarray(ref.energy_size_coefficient))
    np.testing.assert_array_equal(ours.cap_dispatched.numpy(), np.asarray(ref.cap_dispatched))
    assert ours.total_coefficient == ref.total_coefficient
    assert not ours.use_kernel_collect and isinstance(ours.state, MarlisaTrainState)


@pytest.fixture(scope="module")
def ring_inputs(schema, jax_warmup):
    """An acting JAX policy, encoded observations, seeded ridge weights and
    the ring's key."""
    ref = jax_warmup[0]
    nets = tp.acting_nets(ref.state.base.nets)
    obs = ref._encoded_obs(ref.state.base.env_state)
    reg_w = np.random.RandomState(1).normal(0.0, 0.3, (B, ref.reg_dim)).astype(np.float32)
    return ref, nets, obs, reg_w, jax.random.PRNGKey(7)


def jax_ring_noise(key, iterations, n_agents, shape):
    keys = jax.random.split(key, iterations * n_agents).reshape(iterations, n_agents, -1)
    return np.stack([[np.asarray(jax.random.normal(keys[i, a], shape))
                      for a in range(n_agents)] for i in range(iterations)])


@pytest.mark.parametrize("deterministic", [False, True])
def test_ring_matches_jax(schema, ring_inputs, deterministic):
    ref, nets, obs, reg_w, key = ring_inputs
    ours = port_marlisa(schema)
    state = marlisa_state_from_numpy(tp.as_numpy(ref.state), device="cpu")
    state.base.nets = train_state_from_numpy(
        tp.as_numpy(ref.state.base._replace(nets=nets)), device="cpu").nets
    cv0 = np.zeros((tp.D, B, COORD_VARS), np.float32)
    want_a, want_cv = ref._coordination_ring(nets.policy, obs, cv0, reg_w, key,
                                             deterministic=deterministic)
    noise = jax_ring_noise(key, ours.iterations, B, (tp.D, ours.act_dim))
    got_a, got_cv = ours._coordination_ring(
        state.base.nets.policy, torch.tensor(np.asarray(obs)), torch.tensor(cv0),
        torch.tensor(reg_w), torch.tensor(noise), deterministic=deterministic)
    tp.assert_close(got_a, want_a, "actions")
    tp.assert_close(got_cv, want_cv, "cv")
    assert float(np.abs(np.asarray(want_cv)[..., 0]).max()) > 0
    np.testing.assert_array_equal(got_cv[..., 1].numpy(),
                                  np.broadcast_to(ours.cap_dispatched.numpy(), (tp.D, B)))
    if deterministic:
        zero = ours._coordination_ring(state.base.nets.policy, torch.tensor(np.asarray(obs)),
                                       torch.tensor(cv0), torch.tensor(reg_w),
                                       torch.zeros_like(torch.tensor(noise)), True)
        assert torch.equal(zero[0], got_a)


def test_ring_first_agent_sees_zero_total_demand(schema, ring_inputs):
    ref, nets, obs, reg_w, _ = ring_inputs
    ours = tp.port_trainer(schema, marlisa=True, trainer_kw=dict(iterations=1))
    policy = train_state_from_numpy(tp.as_numpy(ref.state.base._replace(nets=nets)),
                                       device="cpu").nets.policy
    obs = torch.tensor(np.asarray(obs))
    noise = torch.randn((1, B, tp.D, ours.act_dim), generator=torch.Generator().manual_seed(0))
    acts, cv = ours._coordination_ring(policy, obs, torch.zeros((tp.D, B, COORD_VARS)),
                                       torch.tensor(reg_w), noise)
    assert float(cv[:, 0, 0].abs().max()) == 0.0 and float(cv[:, 1:, 0].abs().max()) > 0
    # agent 0 acted on its observation and two zero coordination variables
    inp = torch.cat([obs[:, 0], torch.zeros((tp.D, COORD_VARS))], -1)
    with torch.no_grad():
        first, _, _ = policy_sample(lambda x: policy(x, agents=slice(0, 1)), inp[None],
                                    noise[0, 0][None], ours.action_scale[:1],
                                    ours.action_bias[:1], ours.act_mask[:1])
    assert torch.equal(acts[:, 0], first[0])


def test_warmup_replay_and_ridge_match_jax(schema, jax_warmup):
    _, start, actions, offsets, end = jax_warmup
    ours = port_marlisa(schema, warmup_steps=10**9)
    ours.load_state(marlisa_state_from_numpy(start, device="cpu"))
    reset = [t for t in range(1, tp.WARM) if not np.array_equal(offsets[t], offsets[t - 1])]
    assert reset == [tp.EPISODE - 2]               # the episode's last step resets
    ours.draws = tp.FedDraws(actions, {StepDraws.RESET: offsets[reset[0]]})
    ours.train(tp.WARM, chunk=30)
    ms = ours.state
    # one row a step, delayed by one, none for the transition across the reset
    assert ms.base.replay_pos == tp.WARM - 2 == int(end.base.replay_pos)
    tp.assert_train_states_close(ms.base, end.base)
    assert float(ms.base.replay_done.abs().max()) == 0.0
    stored = ms.base.replay_act[:tp.WARM - 2].numpy()
    np.testing.assert_array_equal(stored, np.stack(actions[:reset[0]] + actions[reset[0] + 1:-1]))
    for f in ("reg_xtx", "reg_xty", "prev_obs", "prev_act", "prev_rew", "cv"):
        tp.assert_close(getattr(ms, f), getattr(end, f), f)
    assert ms.prev_valid == bool(end.prev_valid) is True
    assert float(ms.cv.abs().max()) == 0.0          # warmup zeroes the variables
    # the weights of the last refit (step 55), held by what they predict
    # on the stored rows' features: two float32 solves of this system part
    # by ~1 % in the weights and agree on the predictions
    n = tp.WARM - 2
    obs = end.base.replay_obs[:n].reshape(n, tp.D, B, ours.obs_dim)[..., :ours.enc_dim]
    feats = np.concatenate([obs, end.base.replay_act[:n], np.ones((n, tp.D, B, 1), np.float32)],
                           -1).astype(np.float64)
    predict = lambda w: np.einsum("sdaf,af->sda", feats, np.asarray(w, np.float64))
    assert float(ms.reg_w.abs().max()) > 0
    tp.assert_close(predict(ms.reg_w.numpy()), predict(end.reg_w), "reg_w", rtol=1e-4)
    # the refit alone, on JAX's own accumulators: the same predictions, and
    # a residual within 1e-5 of the right-hand side's scale
    system = end.reg_xtx + np.eye(ours.reg_dim, dtype=np.float32) * RIDGE
    assert np.linalg.cond(system.astype(np.float64)).min() > 1e5
    solved = ridge_solve(torch.tensor(end.reg_xtx), torch.tensor(end.reg_xty)).numpy()
    want = np.asarray(jax.vmap(jax.numpy.linalg.solve)(system, end.reg_xty))
    tp.assert_close(predict(solved), predict(want), "solve", rtol=1e-4)
    residual = np.einsum("afg,ag->af", system.astype(np.float64), solved) - end.reg_xty
    assert np.abs(residual).max() <= 1e-5 * np.abs(end.reg_xty).max()


def test_ridge_solve_where_float32_loses_the_ridge():
    """At D=4096 the accumulators pass 32768 rows within 8 steps: 1e-3 is
    below half an ulp of the diagonal, and two columns that every row
    shares (a one-hot class and the constant) leave X^T X + 1e-3 I exactly
    singular in float32. The float64 solve returns the ridge solution."""
    rng = np.random.RandomState(0)
    n, f = 32768, 6
    x = np.concatenate([rng.uniform(-1, 1, (n, f - 2)), np.ones((n, 2))], 1).astype(np.float32)
    y = (x[:, :f - 2] @ rng.normal(0, 1, f - 2) + 0.5).astype(np.float32)
    xtx = torch.tensor(x.T @ x)[None]
    xty = torch.tensor(x.T @ y)[None]
    in_f32 = xtx + torch.eye(f) * RIDGE
    assert torch.equal(in_f32[0, -2:, -2:], torch.full((2, 2), float(n)))   # the ridge is gone
    got = ridge_solve(xtx, xty)[0].numpy()
    x64 = x.astype(np.float64)
    want = np.linalg.solve(x64.T @ x64 + RIDGE * np.eye(f), x64.T @ y)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_evaluate_with_live_ring_matches_jax(schema, jax_warmup):
    ref = jax_warmup[0]
    ref.state = ref.state._replace(
        base=ref.state.base._replace(nets=tp.acting_nets(ref.state.base.nets)))
    ours = port_marlisa(schema)
    ours.load_state(marlisa_state_from_numpy(tp.as_numpy(ref.state), device="cpu"))
    ours.draws = tp.FedDraws(offsets={StepDraws.EVAL: tp.eval_offsets(ref)})
    n = 30
    table, jtable = ours.evaluate(n_steps=n), ref.evaluate(n_steps=n)
    tp.assert_tables_match(table, jtable, n)
    assert not np.allclose(table["district|cost_total"].numpy(), 1.0)


def test_trains_on_a_heterogeneous_lstm_district(tmp_path):
    schema = write_lstm_dataset(str(tmp_path), n_rows=200, lookback=4, heterogeneous=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = port_marlisa(schema, warmup_steps=8)
    w0 = tr.base_state.nets.policy.mean_w.detach().clone()
    hist = tr.train(24, chunk=12)
    ms = tr.state
    assert all(np.isfinite(h) for h in hist)
    assert (ms.base.nets.policy.mean_w - w0).abs().max() > 0, "the policy never updated"
    assert float(ms.reg_w.abs().max()) > 0 and float(ms.cv[..., 0].abs().max()) > 0
    np.testing.assert_array_equal(ms.cv[..., 1].numpy(),
                                  np.broadcast_to(tr.cap_dispatched.numpy(), ms.cv.shape[:2]))
    padded = tr.act_mask == 0
    assert bool(padded.any())
    assert int(torch.count_nonzero(ms.base.replay_act[:, :, padded])) == 0
    table = tr.evaluate(n_steps=12)
    assert len(table) == 37 and torch.isfinite(table["district|cost_total"]).all()
