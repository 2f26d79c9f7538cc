"""Sub-hourly districts in the port against the JAX package: hourly steps
over 15-minute rows, a time-step ratio of 4 (the JAX package's
``tests/test_subhour.py`` pattern, on the seeded writers'
``minutes=True`` files instead of the bundled data). Each port path is held
against its own JAX counterpart: the stepped battery+PV and thermal
districts against JAX's stepped ``district_step``, the plain versions of K1,
K3 and K6 against the Pallas kernels in interpret mode. The reference's own
differences between its paths at a ratio other than 1 are asserted as they
are: the thermal kernel and the stepped path clamp a tank's charge
differently (``ops/pallas_thermal.py:80-82`` against
``core/storage.tank_charge``), and the EV kernel scales the EV battery's
degradation by the ratio where the stepped path does not
(``ops/pallas_ev.py:288-290``).

Tolerance: 1e-5 of each series' scale, as for every family (XLA:CPU
contracts ``a + b * c`` where the port rounds twice)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core import rollout_fast as jax_rollout_fast
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout, rollout_fast
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import StepOutput
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)

S, D = 96, 3
SUMMER = 4700            # the thermal district's summer rows, as its other tests
HRS = np.arange(1, 25)
RBC = np.where((HRS >= 22) | (HRS <= 8), 0.091, -0.08).astype(np.float32)
THERMAL = {"cooling_storage": RBC, "dhw_storage": RBC, "electrical_storage": RBC}


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    err = float(np.max(np.abs(ours - ref), initial=0.0))
    assert err <= rtol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def districts(tmp_path_factory):
    root = lambda name: str(tmp_path_factory.mktemp(name))
    out = {}
    for name, path, kw in (
            ("battery_pv", write_battery_pv_dataset(root("bat"), 4, 400, minutes=True), {}),
            ("thermal", write_thermal_dataset(root("th"), 5, 5000, heating=True, minutes=True),
             {"simulation_start_time_step": SUMMER, "simulation_end_time_step": 4899})):
        kw = dict(kw, episode_time_steps=S + 1)
        out[name] = (pack(compile_schema(path, **kw), device="cpu")[:2],
                     jax_pack(jax_compile(path, **kw))[:2])
    return out


def test_minutes_give_a_ratio_of_four(districts, tmp_path):
    for (cfg, _), (jcfg, _) in districts.values():
        assert cfg.time_step_ratio == jcfg.time_step_ratio == 4.0
        assert cfg.seconds_per_time_step == 3600.0
    spec = compile_schema(write_battery_pv_dataset(str(tmp_path), 2, 48, minutes=True),
                          seconds_per_time_step=900)
    assert spec.time_step_ratio == 1.0


@pytest.mark.parametrize("name", ["battery_pv", "thermal"])
def test_stepped_district_matches_jax(districts, name):
    (cfg, params), (jcfg, jparams) = districts[name]
    B = cfg.n_buildings
    rng = np.random.RandomState(len(name))
    actions = np.zeros((D, S, 7, B), np.float32)
    for a in (0, 1, 2, 3):                       # the three tanks and the battery
        actions[:, :, a, :] = rng.uniform(-1.0, 1.0, (D, S, B))
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    outs = []
    for s in range(S):
        states, out = district_step(
            cfg, params, states, rollout.actions_dict_from_array(torch.tensor(actions[:, s])))
        outs.append(out)

    def episode(state, acts):
        body = lambda st, a: jax_step(jcfg, jparams, st, jax_rollout.actions_dict_from_array(a))
        return jax.lax.scan(body, state, acts)

    jfinal, jouts = jax.jit(jax.vmap(episode))(jax_rollout.batched_initial_states(jcfg, jparams, D),
                                               jnp.asarray(actions))
    for f in dataclasses.fields(StepOutput):
        if getattr(outs[0], f.name) is None:
            continue
        ours = torch.stack([getattr(o, f.name) for o in outs])
        assert_close(ours, np.swapaxes(np.asarray(getattr(jouts, f.name)), 0, 1), f.name)
    for k in ("battery_soc", "cooling_storage_soc", "heating_storage_soc", "dhw_storage_soc"):
        assert_close(getattr(states, k), getattr(jfinal, k), k)
    # the ratio reached the battery: its degradation is scaled by 4
    assert float((params.battery.capacity - states.battery_degraded_capacity).max()) > 0.0


def test_battery_kernel_matches_jax(districts):
    (cfg, params), (jcfg, jparams) = districts["battery_pv"]
    ours = rollout_fast.run_battery_episode(cfg, params, D, RBC, record_series=True,
                                            device="cpu")
    ref = jax_rollout_fast.run_battery_episode(jcfg, jparams, 256, RBC, interpret=True,
                                               record_series=True)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert_close(a, np.asarray(b)[:D] if i < len(ours) - 1 else b, f"output {i}")


def test_thermal_kernel_matches_jax_and_differs_from_stepped(districts):
    (cfg, params), (jcfg, jparams) = districts["thermal"]
    # K3 serves a district without a heating end use
    cool = dataclasses.replace(cfg, any_heating=False)
    jcool = dataclasses.replace(jcfg, any_heating=False)
    ours = rollout_fast.run_thermal_episode(cool, params, D, THERMAL, record_series=True,
                                            device="cpu")
    ref = jax_rollout_fast.run_thermal_episode(jcool, jparams, 256, THERMAL, interpret=True,
                                               record_series=True)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert_close(a, np.asarray(b)[:D] if i < len(ours) - 1 else b, f"output {i}")
    # the stepped path clamps the tank's charge after the ratio, the kernel
    # before: at a ratio of 4 the cooling tanks end elsewhere
    states = rollout.batched_initial_states(cool, params, 1, device="cpu")
    policy = ScriptedPolicy(THERMAL).as_policy_fn(cool, params, S)
    for _ in range(S):
        states, _ = district_step(cool, params, states, policy(params, states))
    assert not torch.allclose(ours[3][0], states.cooling_storage_soc[0], rtol=1e-4)


def test_neighborhood_kernel_matches_jax_at_a_quarter_hour(tmp_path):
    """K6's hours_ratio and ratio: a neighborhood district stepped every 15
    minutes over 15-minute rows (hours ratio 0.25, time-step ratio 1), and
    the same rows stepped hourly (ratio 4)."""
    path = write_neighborhood_dataset(str(tmp_path), 4, 8760, seed=2)
    kw = dict(episode_time_steps=S + 1, simulation_start_time_step=2952)
    cfg, params, _ = pack(compile_schema(path, **kw), device="cpu")
    jcfg, jparams, _ = jax_pack(jax_compile(path, **kw))
    plans = {"cooling_or_heating_device": np.where(HRS < 12, 0.6, -0.5).astype(np.float32),
             "electrical_storage": RBC}
    for seconds, ratio in ((900.0, 1.0), (3600.0, 4.0)):
        c = dataclasses.replace(cfg, seconds_per_time_step=seconds, time_step_ratio=ratio)
        jc = dataclasses.replace(jcfg, seconds_per_time_step=seconds, time_step_ratio=ratio)
        ours = rollout_fast.run_neighborhood_episode(c, params, D, plans, record_series=True,
                                                     device="cpu")
        ref = jax_rollout_fast.run_neighborhood_episode(jc, jparams, 256, plans,
                                                        interpret=True, record_series=True)
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_close(a, np.asarray(b)[:D] if i < len(ours) - 1 else b, f"output {i}")


def test_ev_kernel_scales_degradation_by_the_ratio(tmp_path):
    """The EV kernel degrades an EV's battery by the time-step ratio, the
    stepped path by 1: at a ratio of 4 the kernel's EVs lose capacity four
    times as fast, at 1 both paths agree."""
    path = write_ev_dataset(str(tmp_path), 4, 3, 4, 1, 200, seed=1)
    cfg, params, _ = pack(compile_schema(path, episode_time_steps=S + 1), device="cpu")
    plans = {"electrical_storage": RBC,
             "electric_vehicle_storage": np.where(HRS < 12, 1.0, -1.0).astype(np.float32)}
    lost = {}
    for ratio in (1.0, 4.0):
        c = dataclasses.replace(cfg, time_step_ratio=ratio)
        kernel = rollout_fast.run_ev_episode(c, params, 1, plans, device="cpu")[8][0]
        states = rollout.batched_initial_states(c, params, 1, device="cpu")
        policy = ScriptedPolicy(plans).as_policy_fn(c, params, S)
        for _ in range(S):
            states, _ = district_step(c, params, states, policy(params, states))
        capacity = params.evs.battery.capacity
        lost[ratio] = (capacity - kernel, capacity - states.ev_degraded_capacity[0])
    kernel_1, stepped_1 = lost[1.0]
    kernel_4, stepped_4 = lost[4.0]
    used = kernel_1 > 0.0                       # EVs that charged at a charger
    assert used.any()
    assert_close(kernel_1, stepped_1.numpy(), "degradation at ratio 1", rtol=1e-3)
    assert_close(stepped_4, stepped_1.numpy(), "stepped degradation at ratio 4", rtol=1e-3)
    assert bool((kernel_4[used] > 3.0 * kernel_1[used]).all())
