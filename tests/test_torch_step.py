"""The port's stepped battery+PV rollouts against the JAX package's
scanned ones: per-step series of a 168-step scripted rollout and the
closed-loop hour-RBC rollout, on a seeded synthetic dataset.

Tolerance: XLA:CPU contracts ``a + b * c`` into one fused multiply-add
(e.g. ``energy_init + e * rt`` in the battery event) where the port
rounds twice, so single steps may differ in the last float32 bit. The
SOC is a running sum of those steps, so the differences accumulate like
a sum's: per-step series are held to 1e-5 relative to their scale, and
single steps taken from the same JAX state to 1e-6."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout_fast import run_battery_episode
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import EnvState
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

D, S, B = 4, 168, 5
RBC = np.where(np.arange(1, 25) < 9, 0.091, -0.08).astype(np.float32)
REWARDS = {
    "default": "citylearn.reward_function.RewardFunction",
    "marl": "citylearn.reward_function.MARL",
    "solar_penalty": "citylearn.reward_function.SolarPenaltyReward",
    "independent_sac": "citylearn.reward_function.IndependentSACReward",
    "multi": {"default": "citylearn.reward_function.MARL",
              "Building_2": "citylearn.reward_function.SolarPenaltyReward"},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=2)


def _both(schema_path, reward, central):
    with open(schema_path) as f:
        schema = json.load(f)
    schema["root_directory"] = os.path.dirname(schema_path)
    schema["reward_function"]["type"] = REWARDS[reward]
    kw = dict(central_agent=central, episode_time_steps=S + 1)
    return (pack(compile_schema(schema, **kw), device="cpu")[:2],
            jax_pack(jax_compile(schema, **kw))[:2])


def assert_series_close(ours, ref, name):
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("reward,central", [
    ("default", False), ("default", True), ("marl", False),
    ("solar_penalty", True), ("independent_sac", False), ("multi", False)])
def test_rollout_scripted_matches_jax(dataset, reward, central):
    (cfg, params), (jcfg, jparams) = _both(dataset, reward, central)
    rng = np.random.RandomState(0)
    actions = np.zeros((D, S, 7, B), np.float32)
    actions[:, :, 3, :] = rng.uniform(-1.0, 1.0, (D, S, B))   # electrical_storage
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    final, ours = rollout.rollout_scripted(cfg, params, states, torch.tensor(actions),
                                           collect=True)
    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D)
    run = jax.jit(jax.vmap(lambda s, a: jax_rollout.rollout_scripted(
        jcfg, jparams, s, a, collect=True)))
    jfinal, ref = run(jstates, jnp.asarray(actions))
    assert set(ours) == set(ref)
    n_reward = 1 if central else B
    assert ours["reward"].shape == (D, S, n_reward)
    for k in ours:
        assert ours[k].shape == ref[k].shape, k
        assert_series_close(ours[k], ref[k], k)
    assert_series_close(final.battery_soc, jfinal.battery_soc, "final soc")
    assert int(final.t[0]) == S
    # the per-district plans differ, so must the districts
    assert not torch.equal(ours["net"][0], ours["net"][1])


@pytest.mark.parametrize("central", [False, True])
def test_rollout_districts_hour_rbc_matches_jax(dataset, central):
    (cfg, params), (jcfg, jparams) = _both(dataset, "default", central)
    states = rollout.batched_initial_states(cfg, params, D, data_offset=3, device="cpu")
    final, ours = rollout.rollout_districts(cfg, params, states, S - 3,
                                            rollout.hour_rbc_policy(RBC), device="cpu")
    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D, data_offset=3)
    jfinal, ref = jax_rollout.rollout_districts(jcfg, jparams, jstates, S - 3,
                                                jax_rollout.hour_rbc_policy(jnp.asarray(RBC)))
    assert_series_close(ours["reward_sum"], ref["reward_sum"], "reward_sum")
    for k in ("battery_soc", "battery_efficiency", "battery_degraded_capacity"):
        assert_series_close(getattr(final, k), getattr(jfinal, k), k)
    assert int(final.t[0]) == S - 3 and int(final.data_offset[0]) == 3


def test_unsupported_configuration_raises(dataset):
    """The float64 parity mode, once refused here, packs and steps on the
    stepped path (the JAX package's parity episodes are held against it in
    ``test_torch_parity_f64.py``), while the whole-episode kernel path
    (K1's) refuses it."""
    cfg, params, _ = pack(compile_schema(dataset, episode_time_steps=S + 1), device="cpu",
                          param_dtype=torch.float64)
    assert cfg.parity_f64
    assert params.battery.capacity.dtype == params.series.non_shiftable_load.dtype == torch.float64
    states = rollout.batched_initial_states(cfg, params, 1, device="cpu")
    final, out = rollout.rollout_districts(cfg, params, states, 2, rollout.hour_rbc_policy(RBC),
                                           device="cpu")
    assert out["reward_sum"].dtype == final.battery_soc.dtype == torch.float64
    assert torch.isfinite(out["reward_sum"]).all() and int(final.t[0]) == 2
    with pytest.raises(ValueError, match="parity_f64"):
        run_battery_episode(cfg, params, 1, RBC, device="cpu")
    with pytest.raises(ValueError, match="parity_f64"):
        evaluate_scripted(cfg, params, ScriptedPolicy({"electrical_storage": RBC}),
                          device="cpu")


@pytest.mark.parametrize("central", [False, True])
def test_district_step_matches_jax_from_each_state(dataset, central):
    """One port step from each of the 168 states of a JAX trajectory (the
    168 states form the district axis of a single batched step): here no
    error can accumulate, so outputs agree to 1e-6 of their scale — the
    last-bit differences of XLA's fused multiply-adds."""
    (cfg, params), (jcfg, jparams) = _both(dataset, "default", central)
    rng = np.random.RandomState(1)
    actions = np.zeros((S, 7, B), np.float32)
    actions[:, 3, :] = rng.uniform(-1.0, 1.0, (S, B))

    def body(st, a):
        nxt, out = jax_step(jcfg, jparams, st, jax_rollout.actions_dict_from_array(a))
        return nxt, (st, nxt, out)

    jstate = jax.tree_util.tree_map(lambda x: x[0],
                                    jax_rollout.batched_initial_states(jcfg, jparams, 1))
    _, (before, after, jout) = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(
        jstate, jnp.asarray(actions))
    t = lambda x: torch.tensor(np.asarray(x))
    states = EnvState(**{f.name: v if isinstance(v, tuple) else t(v)    # no dynamics: ()
                         for f in dataclasses.fields(EnvState)
                         for v in (getattr(before, f.name),)})
    nxt, out = district_step(cfg, params, states,
                             rollout.actions_dict_from_array(torch.tensor(actions)))
    pairs = {
        "net": (out.net_electricity_consumption, jout.net_electricity_consumption),
        "cost": (out.net_electricity_consumption_cost, jout.net_electricity_consumption_cost),
        "emission": (out.net_electricity_consumption_emission,
                     jout.net_electricity_consumption_emission),
        "reward": (out.reward, jout.reward),
        "battery_balance": (out.battery_balance, jout.battery_balance),
        "battery_consumption": (out.battery_consumption, jout.battery_consumption),
        "non_shiftable_consumption": (out.non_shiftable_consumption,
                                      jout.non_shiftable_consumption),
        "soc": (nxt.battery_soc, after.battery_soc),
        "efficiency": (nxt.battery_efficiency, after.battery_efficiency),
        "degraded_capacity": (nxt.battery_degraded_capacity, after.battery_degraded_capacity),
    }
    for name, (a, b) in pairs.items():
        b = np.asarray(b)
        scale = float(np.max(np.abs(b))) or 1.0
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * scale, err_msg=name)
    np.testing.assert_array_equal(nxt.t.numpy(), np.asarray(after.t))
