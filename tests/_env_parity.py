"""Helpers of the Gym env tests: the seeded synthetic districts of every
family, and the port's ``CityLearnEnv`` stepped beside the JAX package's
under the same actions.

Tolerances are relative to each series' scale: ``max(1, max |ref|)`` over
the episode (a KPI value: ``max(1, |ref|)``), NaN where the reference has
NaN."""

import os

import numpy as np

import citylearn_tpu
from citylearn_tpu_torch import CityLearnEnv
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_lstm_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "quebec_occ",
                      "schema.json")

#: family -> writer of its schema under a directory, at the sizes of the
#: other port tests
WRITERS = {
    "battery": lambda root: write_battery_pv_dataset(root, 5, 200, seed=1),
    "thermal": lambda root: write_thermal_dataset(root, 4, 200, seed=3, heating=True),
    "ev": lambda root: write_ev_dataset(root, 4, 3, 4, 1, 300),
    "ev_constrained": lambda root: write_ev_dataset(root, 4, 3, 4, 1, 300, constraints=True),
    "lstm": lambda root: write_lstm_dataset(root, n_rows=300),
    "lstm_outage": lambda root: write_lstm_dataset(root, n_rows=300, stochastic_outage=True),
}
NEIGHBORHOOD_WRITERS = {
    "eulp": lambda root: write_neighborhood_dataset(root, 6, 300),
    "quebec": lambda root: write_neighborhood_dataset(root, 6, 300, quebec=True),
    "quebec_occ": lambda root: GOLDEN,
}


def write_all(tmp_path_factory, writers=None):
    """{family: schema path} of the fixture districts (``WRITERS``'s by
    default)."""
    return {name: write(str(tmp_path_factory.mktemp(name)))
            for name, write in (writers or WRITERS).items()}


def pair(path, **kw):
    """(port env on the CPU, JAX env) of one schema, both reset."""
    ours = CityLearnEnv(path, device="cpu", **kw)
    ref = citylearn_tpu.CityLearnEnv(path, **kw)
    return ours, ref


def flat(obs):
    return np.concatenate([np.asarray(o, np.float64).ravel() for o in obs])


def random_actions(env, rng):
    return [rng.uniform(-1.0, 1.0, s.shape[0]).astype(np.float32) for s in env.action_space]


def assert_close(ours, ref, tol, name):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, name
    assert np.array_equal(np.isnan(ours), np.isnan(ref)), name
    scale = max(1.0, float(np.nanmax(np.abs(ref), initial=0.0)))
    err = float(np.nanmax(np.abs(ours - ref), initial=0.0))
    assert err <= tol * scale, f"{name}: max |diff| {err} over scale {scale}"


def run_episode(ours, ref, n_steps, seed, tol):
    """Reset both envs, step them ``n_steps`` under the same random actions
    and hold observations, rewards and ``terminated`` at every step;
    returns the (steps + 1, n) observation and (steps, n) reward arrays."""
    o1, info1 = ours.reset()
    o2, info2 = ref.reset()
    assert info1 == info2 == {}
    obs1, obs2, rew1, rew2 = [flat(o1)], [flat(o2)], [], []
    rng = np.random.RandomState(seed)
    for _ in range(n_steps):
        acts = random_actions(ref, rng)
        a, r1, term1, trunc1, _ = ours.step(acts)
        b, r2, term2, trunc2, _ = ref.step(acts)
        assert (term1, trunc1) == (term2, trunc2)
        assert len(r1) == len(r2)
        obs1.append(flat(a))
        obs2.append(flat(b))
        rew1.append(r1)
        rew2.append(r2)
        if term2:
            break
    obs1, obs2 = np.stack(obs1), np.stack(obs2)
    for k in range(obs2.shape[1]):
        assert_close(obs1[:, k], obs2[:, k], tol, f"observation column {k}")
    assert_close(rew1, rew2, tol, "reward")
    return obs1, np.asarray(rew1)


def assert_history_close(ours, ref, tol):
    assert set(ours._history) == set(ref._history)
    for k in ref._history:
        assert_close(ours._history[k], ref._history[k], tol, f"history {k}")


def assert_frames_close(ours, ref, tol, delta_scale=1.0):
    """``evaluate()`` frames: the same rows in the same order, the values
    within ``tol`` of ``max(1, |ref|)``; the discomfort deltas, which are
    differences of temperatures, within ``tol`` of ``max(delta_scale,
    |ref|)`` (the temperatures' scale)."""
    assert list(ours.columns) == list(ref.columns)
    assert len(ours) == len(ref)
    for col in ("cost_function", "name", "level"):
        assert list(ours[col]) == list(ref[col]), col
    for (_, a), (_, b) in zip(ours.iterrows(), ref.iterrows()):
        x, y = float(a.value), float(b.value)
        if np.isnan(y):
            assert np.isnan(x), (b.cost_function, b["name"])
        else:
            floor = delta_scale if "_delta_" in b.cost_function else 1.0
            assert abs(x - y) <= tol * max(floor, abs(y)), (b.cost_function, b["name"], x, y)


def check_episode(path, central, rows, tol, seed=7):
    """One whole episode of ``rows`` rows of both envs under the same
    random actions: observations, rewards, ``terminated``,
    ``episode_rewards``, the history, the district series and the
    ``evaluate()`` table."""
    steps = rows - 1
    ours, ref = pair(path, central_agent=central, episode_time_steps=rows)
    run_episode(ours, ref, steps, seed=seed, tol=tol)
    assert ours.terminated and ref.terminated
    assert ours.time_step == ref.time_step == steps
    assert len(ours.episode_rewards) == len(ref.episode_rewards) == 1
    for key in ("min", "max", "sum", "mean"):
        assert_close(ours.episode_rewards[0][key], ref.episode_rewards[0][key], tol, key)
    assert_history_close(ours, ref, tol)
    assert_frames_close(ours.evaluate(), ref.evaluate(), tol)
    for name in ("net_electricity_consumption", "net_electricity_consumption_cost",
                 "net_electricity_consumption_emission",
                 "net_electricity_consumption_without_storage",
                 "net_electricity_consumption_without_storage_and_pv"):
        assert_close(getattr(ours, name), getattr(ref, name), tol, name)


def check_spaces_and_metadata(path):
    for central in (False, True):
        ours, ref = pair(path, central_agent=central, episode_time_steps=24)
        assert ours.observation_names == ref.observation_names
        assert ours.action_names == ref.action_names
        assert ours.shared_observations == ref.shared_observations
        assert ours.observation_space == ref.observation_space
        assert ours.action_space == ref.action_space
        assert ours.get_metadata() == ref.get_metadata()
        assert (ours.time_steps, ours.central_agent) == (ref.time_steps, ref.central_agent)
