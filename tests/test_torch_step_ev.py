"""The port's stepped EV district against the JAX package's: 168 steps of
``district_step`` at D=4 under per-district random battery, charger and
washing-machine actions, every ``StepOutput`` field and the carried
state, on the seeded synthetic EV dataset
(``citylearn_tpu_torch.synthetic.write_ev_dataset``): decentral and
central agents, the EV reward and the default reward, with and without
charging constraints (which bind under these actions); and the EV reward
function alone on random inputs.

Tolerances. Stepped series: 1e-5 relative to each series' scale. XLA:CPU
contracts ``a + b * c`` into one fused multiply-add (``energy_init +
e * rt`` in the battery events) where the port rounds twice, so single
steps may differ in the last float32 bit, and the battery and EV SOCs
carry those differences through 168 steps like a running sum. The reward
function alone: 1e-6 of scale (the same operations on the same inputs;
only the segment sums differ in order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import reward as jax_reward
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import reward, rollout
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import EnvState, StepOutput

D, S = 4, 168
B, C, V, W = 6, 4, 7, 1
REWARDS = {"ev": "citylearn.reward_function.Electric_Vehicles_Reward_Function",
           "default": "citylearn.reward_function.RewardFunction"}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from citylearn_tpu_torch.synthetic import write_ev_dataset

    return {cons: write_ev_dataset(str(tmp_path_factory.mktemp("ds")), B, C, V, W, 400,
                                   seed=2, constraints=cons)
            for cons in (False, True)}


def _both(datasets, constraints, central, reward_name):
    path = datasets[constraints]
    with open(path) as f:
        schema = json.load(f)
    schema["root_directory"] = os.path.dirname(path)
    schema["reward_function"]["type"] = REWARDS[reward_name]
    kw = dict(central_agent=central, episode_time_steps=S + 1)
    return pack(compile_schema(schema, **kw), device="cpu"), jax_pack(jax_compile(schema, **kw))


def _random_actions(seed):
    """Per-district plans: battery in [-1, 1]; chargers in [-1, 1] with a
    third of the steps idle (an idle charger leaves its EV untouched);
    the machine's trigger on a third of the steps."""
    rng = np.random.RandomState(seed)
    a_ev = rng.uniform(-1.0, 1.0, (D, S, C)).astype(np.float32)
    a_ev[rng.rand(D, S, C) < 0.33] = 0.0
    return {"electrical_storage": rng.uniform(-1.0, 1.0, (D, S, B)).astype(np.float32),
            "electric_vehicle_storage": a_ev,
            "washing_machine": (rng.rand(D, S, W) < 0.33).astype(np.float32)}


def _stepped_both(cfg, params, jcfg, jparams, actions):
    """All StepOutput fields over S steps, (S, D, ...) each, and the final
    states, from the port and from JAX under the same actions."""
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    outs = []
    for s in range(S):
        states, out = district_step(cfg, params, states,
                                    {k: torch.tensor(v[:, s]) for k, v in actions.items()})
        outs.append(out)
    ours = {f.name: torch.stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(StepOutput)}

    def episode(state, acts):
        return jax.lax.scan(lambda st, a: jax_step(jcfg, jparams, st, a), state, acts)

    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D)
    jfinal, jouts = jax.jit(jax.vmap(episode))(
        jstates, {k: jnp.asarray(v) for k, v in actions.items()})
    ref = {k: np.swapaxes(np.asarray(getattr(jouts, k)), 0, 1) for k in ours}
    return states, ours, jfinal, ref


def assert_series_close(ours, ref, name, tol=1e-5):
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("constraints,central,reward_name", [
    (True, False, "ev"), (True, True, "ev"), (False, False, "ev"), (False, False, "default"),
    (True, True, "default")])
def test_ev_steps_match_jax(datasets, constraints, central, reward_name):
    (cfg, params, _), (jcfg, jparams, _) = _both(datasets, constraints, central, reward_name)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.has_evs and cfg.has_washing_machines
    assert cfg.has_charging_constraints == constraints
    final, ours, jfinal, ref = _stepped_both(cfg, params, jcfg, jparams, _random_actions(0))
    assert ours["reward"].shape == (S, D, 1 if central else B)
    assert ours["ev_soc"].shape == (S, D, V)
    assert ours["charger_consumption"].shape == (S, D, C)
    for k in ours:
        assert_series_close(ours[k], ref[k], k)
    for f in dataclasses.fields(EnvState):
        if f.name in ("lstm_h", "lstm_c", "dyn_input"):     # no dynamics: empty tuples
            assert getattr(final, f.name) == getattr(jfinal, f.name) == ()
            continue
        assert_series_close(getattr(final, f.name), getattr(jfinal, f.name), f.name)

    # what the episode exercised: forced arrival SOCs and drift, chargers
    # charging and discharging their EVs, the machine's trigger, the
    # districts taking different paths, and limits that bind
    force = params.evs.force_soc[:S]
    assert torch.isfinite(force).any() and torch.isfinite(params.evs.drift_mult[:S]).any()
    cons = ours["charger_consumption"]
    assert (cons > 0).any() and (cons < 0).any()
    assert (ours["washing_machines_consumption"] > 0).any()
    assert not torch.equal(ours["ev_soc"][:, 0], ours["ev_soc"][:, 1])
    assert (ours["chargers_consumption"][..., 0] != 0).any()        # two chargers
    assert float(ours["chargers_consumption"][..., 1].abs().max()) == 0.0   # none
    if reward_name == "ev":
        assert (ours["reward"] != 0).any()
    viol = ours["charging_violation_kwh"]
    if constraints:
        assert (viol > 0).any()
        assert (ours["charging_building_headroom"] == 0).any()      # a limit met exactly
        assert ours["charging_phase_headroom"].shape == (S, D, 2)
    else:
        assert float(viol.abs().max()) == 0.0


@pytest.mark.parametrize("central", [False, True], ids=["decentral", "central"])
def test_ev_reward_matches_jax(datasets, central):
    """``_ev_reward`` alone on random (D, C) charger inputs that reach
    every branch: departures due now, SOC far below and near the required
    one, energy beyond the battery's limits, both signs of the building's
    net load."""
    (cfg, params, _), (jcfg, jparams, _) = _both(datasets, True, central, "ev")
    rng = np.random.RandomState(5)
    f32 = lambda a: np.asarray(a, np.float32)
    net = f32(rng.uniform(-3.0, 6.0, (D, B)))
    ch = params.chargers
    ev = dict(
        building_index=ch.building_index.numpy(),
        connected=rng.rand(D, C) < 0.7,
        last_charged_kwh=f32(rng.uniform(-8.0, 8.0, (D, C)) * (rng.rand(D, C) < 0.8)),
        soc_prev=f32(rng.uniform(0.0, 1.0, (D, C))),
        soc_now=f32(rng.uniform(0.0, 1.0, (D, C))),
        capacity=f32(rng.uniform(40.0, 80.0, (D, C))),
        depth_of_discharge=f32(rng.uniform(0.7, 0.9, (D, C))),
        required_soc=f32(rng.uniform(0.5, 1.0, (D, C))),
        hours_until_departure=f32(rng.randint(0, 4, (D, C))),
        max_charging_power=ch.max_charging_power.numpy(),
        max_discharging_power=ch.max_discharging_power.numpy(),
        violation_kwh=f32(rng.uniform(-1.0, 2.0, (D, B))))
    zeros = np.zeros((D, B), np.float32)
    x = dict(net=net, solar=zeros, battery_soc=zeros, cooling_storage_soc=zeros,
             heating_storage_soc=zeros, dhw_storage_soc=zeros,
             battery_capacity=params.battery.capacity.numpy(),
             cooling_storage_capacity=zeros[0], heating_storage_capacity=zeros[0],
             dhw_storage_capacity=zeros[0])
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    ours = reward.compute_reward(cfg, reward.RewardInputs(**t(x)),
                                 reward.EVRewardInputs(**t(ev)))

    def one(xd, evd):
        xi = jax_reward.RewardInputs(**xd, **{
            k: xd["net"] for k in jax_reward.RewardInputs._fields if k not in xd})
        return jax_reward.compute_reward(jcfg, xi, ev=jax_reward.EVRewardInputs(**evd))

    shared = ("battery_capacity", "cooling_storage_capacity", "heating_storage_capacity",
              "dhw_storage_capacity")
    ev_shared = ("building_index", "max_charging_power", "max_discharging_power")
    ref = jax.vmap(one, in_axes=({k: None if k in shared else 0 for k in x},
                                 {k: None if k in ev_shared else 0 for k in ev}))(
        {k: jnp.asarray(v) for k, v in x.items()}, {k: jnp.asarray(v) for k, v in ev.items()})
    assert ours.shape == (D, 1 if central else B)
    assert_series_close(ours, ref, "ev reward", tol=1e-6)
    assert (ours != 0).any()
