"""The float64 parity mode (``CityLearnEnv(..., parity_f64=True)``) of the
port against the JAX package's parity mode: the packed parameters and the
reset state leaf by leaf (float64 but for the LSTM groups and carries),
and whole episodes — observations, rewards, history, carried state and
the ``evaluate()`` table — on the battery+PV, thermal and LSTM districts
(plain and with a stochastic outage), and on the EV district with charging
constraints and the golden ``quebec_occ`` district.

Tolerance 1e-6 of each series' scale, at most about one float32 ulp at the
store points. The runs show the battery+PV, thermal and EV districts equal
to the bit; on the LSTM and quebec districts the LSTMs run in float32 (as
the reference's torch models do) and XLA sums their products in another
order, which moves the indoor temperature by up to 7.4e-8 of its scale, the
ComfortReward by up to 6.4e-7 of its scale, and a discomfort delta (a
difference of two temperatures) by one float32 ulp of the temperature,
1.9e-6 C at 20 C: those are held to 1e-6 of the temperature's scale."""

import jax
import numpy as np
import pytest
import torch

import _env_parity as ep
from citylearn_tpu_torch.core.types import flatten

TOL = 1e-6
FAMILIES = ("battery", "thermal", "lstm", "lstm_outage", "ev_constrained", "quebec_occ")


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    paths = ep.write_all(tmp_path_factory)
    paths["quebec_occ"] = ep.GOLDEN
    return paths


def jax_leaves(tree):
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", None)))
    return {".".join(name(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", ["battery", "ev_constrained", "lstm"])
def test_parity_pack_and_reset_state_equal_jax(schemas, family):
    ours, ref = ep.pair(schemas[family], parity_f64=True, episode_time_steps=48)
    assert ours.cfg.parity_f64 and ref.cfg.parity_f64
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    mine, theirs = flatten(ours.params), jax_leaves(ref.params)
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        assert str(v.numpy().dtype) == str(theirs[k].dtype), k
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    assert mine["battery.capacity"].dtype == torch.float64
    state = flatten(ours._state)
    for k, v in jax_leaves(ref._state).items():
        assert str(state[k].numpy().dtype) == str(v.dtype), k
        np.testing.assert_array_equal(state[k].numpy()[0], v, err_msg=k)
    if family == "lstm":
        assert state["lstm_h.0"].dtype == torch.float32
        assert mine["dynamics.0.w_ih.0"].dtype == torch.float32


@pytest.mark.parametrize("family", FAMILIES)
def test_parity_episode_matches_jax(schemas, family):
    rows = 48 if family == "quebec_occ" else 168
    ours, ref = ep.pair(schemas[family], parity_f64=True, episode_time_steps=rows)
    ep.run_episode(ours, ref, rows - 1, seed=11, tol=TOL)
    assert ours.terminated and ref.terminated
    ep.assert_history_close(ours, ref, TOL)
    # a discomfort delta is a difference of temperatures: its scale is theirs
    temperature_scale = float(np.abs(ref._history["indoor_temperature"]).max())
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL, temperature_scale)
    state = flatten(ours._state)
    for k, v in jax_leaves(ref._state).items():
        if v.dtype.kind == "f":
            ep.assert_close(state[k].numpy()[0], v, TOL, f"state {k}")
        else:
            np.testing.assert_array_equal(state[k].numpy()[0], v, err_msg=k)
    if family in ("battery", "thermal", "ev_constrained"):
        # no LSTM on these districts: the two packages agree to the bit
        for k in ref._history:
            np.testing.assert_array_equal(ours._history[k], ref._history[k], err_msg=k)
        assert ours.rewards == ref.rewards
