"""The port's stepped thermal-storage district against the JAX package's:
packed leaves and initial state, then 168 steps of ``district_step`` at
D=4 under per-district random storage actions, every ``StepOutput`` field
and the carried state, on the seeded synthetic thermal dataset
(``citylearn_tpu_torch.synthetic.write_thermal_dataset``) in a summer
window, where cooling demand is high and one undersized heat pump
saturates; and once with a heating end use (winter window, heating demand
and tank, an electric heating device in one building), which also makes
the DHW tanks controllable through the heating tank's capacity.

Tolerances. Packed leaves, configuration and initial state: exact.
Stepped series: 1e-5 relative to each series' scale. XLA:CPU contracts
``a + b * c`` into one fused multiply-add (``energy_init + e * rt`` in the
tank and battery events) where the port rounds twice, so single steps may
differ in the last float32 bit, and the tank and battery SOCs carry those
differences through 168 steps like a running sum."""

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
from citylearn_tpu.core import rollout_fast as jax_rollout_fast
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout, rollout_fast
from citylearn_tpu_torch.core.params import initial_state, pack, params_from_numpy
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import EnvState, StepOutput, flatten
from citylearn_tpu_torch.synthetic import write_thermal_dataset

D, S, B = 4, 168, 9
SUMMER = dict(simulation_start_time_step=4700, simulation_end_time_step=4899)
STORAGE_ACTIONS = (0, 1, 2, 3)      # cooling, heating, dhw, electrical in ACTION_KEYS
REWARDS = {"default": "citylearn.reward_function.RewardFunction",
           "solar_penalty": "citylearn.reward_function.SolarPenaltyReward"}


def jax_leaves(tree):
    """{"field.subfield": numpy array} of a JAX pytree of dataclasses."""
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Schema paths: the kernel-eligible district and the one with heating."""
    return {heating: write_thermal_dataset(str(tmp_path_factory.mktemp("ds")), B,
                                           5000 if not heating else 200, seed=3,
                                           heating=heating)
            for heating in (False, True)}


def _both(datasets, heating=False, central=False, reward="default"):
    path = datasets[heating]
    with open(path) as f:
        schema = json.load(f)
    schema["root_directory"] = os.path.dirname(path)
    schema["reward_function"]["type"] = REWARDS[reward]
    kw = dict(central_agent=central, episode_time_steps=S + 1, **({} if heating else SUMMER))
    return (pack(compile_schema(schema, **kw), device="cpu"), jax_pack(jax_compile(schema, **kw)))


@pytest.mark.parametrize("heating", [False, True], ids=["eligible", "heating"])
def test_pack_equals_jax(datasets, heating):
    (cfg, params, layout), (jcfg, jparams, jlayout) = _both(datasets, heating)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.any_cooling and cfg.any_dhw and cfg.any_heating == heating
    assert rollout_fast.eligible_thermal(cfg) == jax_rollout_fast.eligible_thermal(jcfg)
    assert rollout_fast.eligible_thermal(cfg) == (not heating)
    assert layout.union_names == jlayout.union_names
    carried = flatten(params_from_numpy(jax_leaves(jparams), device="cpu"))
    ours = flatten(params)
    assert set(ours) == set(carried) and len(ours) == 69
    for k, v in ours.items():
        assert v.dtype == carried[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), carried[k].numpy(), err_msg=k)
    # the district is heterogeneous: heaters and heat pumps, an absent DHW
    # tank, finite power caps beside infinite ones
    dhw_hp = params.dhw_device.is_heat_pump
    assert dhw_hp.any() and not dhw_hp.all()
    assert float(params.dhw_storage.capacity[2]) == 0.0
    caps = params.cooling_storage.max_input_power
    assert torch.isfinite(caps).any() and torch.isinf(caps).any()
    ours_state = flatten(initial_state(cfg, params, 5))
    ref_state = jax_leaves(jax_initial_state(jcfg, jparams, 5))
    assert len(ours_state) == 18               # 6 zero-sized occupant leaves
    for k, v in ours_state.items():
        np.testing.assert_array_equal(v.numpy(), ref_state[k], err_msg=k)


def _stepped_both(cfg, params, jcfg, jparams, actions):
    """All StepOutput fields over S steps, (S, D, ...) each, and the final
    states, from the port and from JAX under the same (D, S, 7, B) actions."""
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    outs = []
    for s in range(S):
        states, out = district_step(
            cfg, params, states, rollout.actions_dict_from_array(torch.tensor(actions[:, s])))
        outs.append(out)
    ours = {f.name: torch.stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(StepOutput)
            if getattr(outs[0], f.name) is not None}     # per-charger series: no chargers

    def episode(state, acts):
        def body(st, a):
            st, out = jax_step(jcfg, jparams, st, jax_rollout.actions_dict_from_array(a))
            return st, out
        return jax.lax.scan(body, state, acts)

    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D)
    jfinal, jouts = jax.jit(jax.vmap(episode))(jstates, jnp.asarray(actions))
    ref = {k: np.swapaxes(np.asarray(getattr(jouts, k)), 0, 1) for k in ours}
    return states, ours, jfinal, ref


def assert_series_close(ours, ref, name):
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0     # EV leaves are zero-sized here
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def _random_actions(seed):
    rng = np.random.RandomState(seed)
    actions = np.zeros((D, S, 7, B), np.float32)
    for a in STORAGE_ACTIONS:
        actions[:, :, a, :] = rng.uniform(-1.0, 1.0, (D, S, B))
    actions[0, 10:20] = 0.0                  # idle steps take the charging order
    return actions


@pytest.mark.parametrize("central,reward", [(False, "default"), (True, "default"),
                                            (False, "solar_penalty")])
def test_thermal_steps_match_jax(datasets, central, reward):
    (cfg, params, _), (jcfg, jparams, _) = _both(datasets, False, central, reward)
    final, ours, jfinal, ref = _stepped_both(cfg, params, jcfg, jparams, _random_actions(0))
    assert ours["reward"].shape == (S, D, 1 if central else B)
    for k in ours:
        assert_series_close(ours[k], ref[k], k)
    for f in dataclasses.fields(EnvState):
        if f.name in ("lstm_h", "lstm_c", "dyn_input"):     # no dynamics: empty tuples
            assert getattr(final, f.name) == getattr(jfinal, f.name) == ()
            continue
        assert_series_close(getattr(final, f.name), getattr(jfinal, f.name), f.name)
    # both priority orders of the cooling block ran, the undersized heat
    # pump saturated, and the t == 0 row carries its multi-count
    cbal = ours["cooling_storage_balance"]
    assert (cbal > 0).any() and (cbal < 0).any()
    met, want = ours["cooling_demand_met"], ours["cooling_demand_actual"]
    assert (met[..., 4] < want[..., 4] - 1e-3).any()
    assert (ours["cooling_consumption"][0] > 2.0 * ours["cooling_consumption"][1]).any()
    # DHW converts through the heating tank's capacity, which is 0 here:
    # the tanks only lose charge, and heating is inert
    assert float(ours["dhw_storage_balance"].abs().max()) == 0.0
    assert (ours["dhw_storage_soc"][-1] < ours["dhw_storage_soc"][0])[..., 0].all()
    assert float(ours["heating_consumption"].abs().max()) == 0.0
    assert not torch.equal(ours["net_electricity_consumption"][:, 0],
                           ours["net_electricity_consumption"][:, 1])


def test_heating_steps_match_jax(datasets):
    """Heating demand, device and tank on the stepped path: the heating
    action converts through the cooling tank's capacity, the DHW action
    through the heating tank's, and building 2's electric heating device
    books its reset-time consumption with the DHW device's efficiency."""
    (cfg, params, _), (jcfg, jparams, _) = _both(datasets, True)
    assert not bool(params.heating_device.is_heat_pump[2])
    final, ours, jfinal, ref = _stepped_both(cfg, params, jcfg, jparams, _random_actions(1))
    for k in ours:
        assert_series_close(ours[k], ref[k], k)
    for f in dataclasses.fields(EnvState):
        if f.name in ("lstm_h", "lstm_c", "dyn_input"):     # no dynamics: empty tuples
            assert getattr(final, f.name) == getattr(jfinal, f.name) == ()
            continue
        assert_series_close(getattr(final, f.name), getattr(jfinal, f.name), f.name)
    for end_use in ("heating", "dhw", "cooling"):
        bal = ours[f"{end_use}_storage_balance"]
        assert (bal > 0).any() and (bal < 0).any(), end_use
        assert (ours[f"{end_use}_demand_met"] > 0).any(), end_use
