"""The port's host-loop rule-based agents (``citylearn_tpu_torch.agents``)
against the JAX package's, each stepping its own package's ``CityLearnEnv``
on the seeded synthetic districts (``tests/_env_parity.py``): every RBC's
per-step actions over one deterministic episode, exactly (both resolve the
same hour maps from the same hour observation), and the ``evaluate()``
tables within 1e-5 of scale (the env tests' tolerance: XLA:CPU fuses
multiply-adds where the port rounds twice); ``BaselineAgent``, which
empties the action surface after the env was built; and
``ScriptedPolicy.from_hour_rbc``'s plans, exactly, central, per building,
and with the EV district's charger and machine maps on their own axes.
Also the port's ``Box`` against gymnasium's from the same seed."""

import numpy as np
import pytest

import _env_parity as ep
import citylearn_tpu
from citylearn_tpu.agents import base as jax_base
from citylearn_tpu.agents import rbc as jax_rbc
from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
from citylearn_tpu_torch import CityLearnEnv
from citylearn_tpu_torch.agents import base, rbc
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy
from citylearn_tpu_torch.spaces import Box

TOL = 1e-5
#: (family, agent, episode rows, central); the neighborhood districts at
#: 72 rows keep the JAX env's steps quick
CASES = [
    ("battery", "BasicRBC", 168, False),
    ("battery", "BasicBatteryRBC", 48, True),
    ("thermal", "OptimizedRBC", 168, False),
    ("ev", "BasicElectricVehicleRBC_ReferenceController", 168, False),
    ("ev", "BasicElectricVehicleRBC_ReferenceController", 48, True),
    ("lstm", "BasicRBC", 168, False),
    ("eulp", "BasicRBC", 72, False),
    ("quebec", "OptimizedRBC", 72, False),
]


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    writers = dict(ep.WRITERS)
    writers.update({k: ep.NEIGHBORHOOD_WRITERS[k] for k in ("eulp", "quebec")})
    return ep.write_all(tmp_path_factory, writers)


def recorded(agent):
    """Wrap ``agent.predict`` to keep every action list it returns."""
    actions, predict = [], agent.predict

    def record(observations, deterministic=None):
        out = predict(observations, deterministic=deterministic)
        actions.append([[float(x) for x in a] for a in out])
        return out

    agent.predict = record
    return actions


def learn_both(path, name, rows, central, modules=(rbc, jax_rbc), **kw):
    """(port env, JAX env, port actions, JAX actions) after one
    deterministic episode of agent ``name`` on each."""
    ours = CityLearnEnv(path, device="cpu", central_agent=central, episode_time_steps=rows)
    ref = citylearn_tpu.CityLearnEnv(path, central_agent=central, episode_time_steps=rows)
    acts = []
    for env, module in zip((ours, ref), modules):
        agent = getattr(module, name)(env, **kw)
        acts.append(recorded(agent))
        agent.learn(episodes=1, deterministic=True)
    return ours, ref, acts[0], acts[1]


@pytest.mark.parametrize("family,name,rows,central", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'central' if c[3] else 'decentral'}"
                              for c in CASES])
def test_rbc_episode_matches_jax(schemas, family, name, rows, central):
    ours, ref, a, b = learn_both(schemas[family], name, rows, central)
    assert len(a) == len(b) == rows - 1
    assert a == b
    assert ours.terminated and ref.terminated
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL)


def test_hour_rbc_with_a_given_map_matches_jax(schemas):
    """A flat hour map given by the user: one table for every action."""
    table = {h: (0.1 if h < 12 else -0.2) for h in range(1, 25)}
    ours, ref, a, b = learn_both(schemas["battery"], "HourRBC", 48, False, action_map=table)
    assert a == b
    assert {x for step in a for row in step for x in row} == {0.1, -0.2}
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL)


@pytest.mark.parametrize("family", ["battery", "ev"])
def test_baseline_agent_matches_jax(schemas, family):
    """``BaselineAgent`` empties every building's actions after the env was
    built; both envs then step with no actions."""
    ours, ref, a, b = learn_both(schemas[family], "BaselineAgent", 48, False,
                                 modules=(base, jax_base))
    assert a == b and all(row == [] for step in a for row in step)
    assert all(bld.active_actions == [] for bld in ours.spec.buildings)
    assert ours.action_names == ref.action_names
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL)


@pytest.mark.parametrize("family,name,central", [
    ("battery", "BasicRBC", True),
    ("thermal", "OptimizedRBC", False),
    ("ev", "BasicElectricVehicleRBC_ReferenceController", False),
    ("ev", "BasicElectricVehicleRBC_ReferenceController", True),
    ("lstm", "BasicBatteryRBC", False),
])
def test_from_hour_rbc_plans_match_jax(schemas, family, name, central):
    ours = CityLearnEnv(schemas[family], device="cpu", central_agent=central,
                        episode_time_steps=24)
    ref = citylearn_tpu.CityLearnEnv(schemas[family], central_agent=central,
                                     episode_time_steps=24)
    B = ours.cfg.n_buildings
    plans = ScriptedPolicy.from_hour_rbc(getattr(rbc, name)(ours), B, spec=ours.spec).plans
    want = JaxScriptedPolicy.from_hour_rbc(getattr(jax_rbc, name)(ref), B, spec=ref.spec).plans
    assert sorted(plans) == sorted(want)
    for k in want:
        assert plans[k].dtype == want[k].dtype and np.array_equal(plans[k], want[k]), k
    if family == "ev":
        assert plans["electric_vehicle_storage"].shape == (24, ours.cfg.n_chargers)
        assert plans["washing_machine"].shape == (24, ours.cfg.n_washing_machines)


def test_action_tables_match_jax():
    for maps in ("BASIC_MAPS", "OPTIMIZED_MAPS", "BATTERY_MAPS"):
        for action in ("electrical_storage", "cooling_device", "heating_device",
                       "cooling_or_heating_device", "dhw_storage"):
            ours = rbc.action_table(getattr(rbc, maps), action)
            assert np.array_equal(ours, jax_rbc.action_table(getattr(jax_rbc, maps), action))


def test_box_draws_as_gymnasium():
    from gymnasium import spaces

    low = np.array([-1.0, 0.0, -np.inf, 2.0, -np.inf], np.float32)
    high = np.array([1.0, 0.5, 3.0, np.inf, np.inf], np.float32)
    ours, ref = Box(low, high), spaces.Box(low, high, dtype=np.float32)
    ours.seed(3)
    ref.seed(3)
    for _ in range(4):
        a, b = ours.sample(), ref.sample()
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert ours.contains(a) and ref.contains(a)
    assert (ours.shape, ours.dtype) == (ref.shape, ref.dtype)
    assert np.array_equal(ours.low, ref.low) and np.array_equal(ours.high, ref.high)
    assert not ours.contains(np.full(5, 9.0, np.float32))
    assert not ours.contains(np.zeros(4, np.float32))
