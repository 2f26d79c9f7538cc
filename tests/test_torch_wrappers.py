"""The port's wrappers (``citylearn_tpu_torch.wrappers``) against the JAX
package's, each around its own package's ``CityLearnEnv`` on the seeded
synthetic battery+PV and EV districts: spaces (kind, bounds, sizes),
observations at reset and over a dozen steps under the same actions,
rewards and the flags. Continuous observations within 1e-5 of scale (the
env tests' tolerance); discretized observations and indices exactly.
Without gymnasium the Box wrappers run on the port's ``Box`` and the
discrete ones raise an ``ImportError`` that names gymnasium."""

import os
import subprocess
import sys

import numpy as np
import pytest

import _env_parity as ep
import citylearn_tpu
from citylearn_tpu import wrappers as jax_wrappers
from citylearn_tpu_torch import CityLearnEnv
from citylearn_tpu_torch import wrappers

TOL = 1e-5
STEPS = 12
BINS = dict(default_observation_bin_size=4, default_action_bin_size=5)
KW = dict(episode_time_steps=24)
TABULAR_KW = dict(KW, active_observations=["hour", "day_type"],
                  active_actions=["electrical_storage"])

#: (id, wrapper name, its keyword arguments, env keyword arguments)
CASES = [
    ("clipped", "ClippedObservationWrapper", {}, dict(KW)),
    ("normalized_obs", "NormalizedObservationWrapper", {}, dict(KW)),
    ("normalized_obs_central", "NormalizedObservationWrapper", {},
     dict(KW, central_agent=True)),
    ("normalized_action", "NormalizedActionWrapper", {}, dict(KW)),
    ("normalized_space_central", "NormalizedSpaceWrapper", {}, dict(KW, central_agent=True)),
    ("discrete_obs", "DiscreteObservationWrapper", {"default_bin_size": 6}, dict(KW)),
    ("discrete_action", "DiscreteActionWrapper", {"default_bin_size": 7}, dict(KW)),
    ("discrete_space", "DiscreteSpaceWrapper",
     {"default_observation_bin_size": 5, "default_action_bin_size": 3}, dict(KW)),
    ("tabular_obs", "TabularQLearningObservationWrapper", {"default_bin_size": 4},
     dict(TABULAR_KW)),
    ("tabular_action", "TabularQLearningActionWrapper", {"default_bin_size": 5},
     dict(TABULAR_KW)),
    ("tabular", "TabularQLearningWrapper", BINS, dict(TABULAR_KW)),
]


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    return ep.write_all(tmp_path_factory, {k: ep.WRITERS[k] for k in ("battery", "ev")})


def space_summary(space):
    kind = type(space).__name__
    if kind == "Box":
        return kind, space.shape, space.low.tolist(), space.high.tolist()
    if kind == "MultiDiscrete":
        return kind, space.nvec.tolist()
    return kind, int(space.n)


def random_actions(space_list, rng):
    out = []
    for s in space_list:
        kind = type(s).__name__
        if kind == "Box":
            out.append(list(rng.uniform(s.low, s.high)))
        elif kind == "MultiDiscrete":
            out.append([int(rng.randint(n)) for n in s.nvec])
        else:
            out.append([int(rng.randint(s.n))])
    return out


def assert_obs(ours, ref, name):
    a, b = ep.flat(ours), ep.flat(ref)
    if all(float(x).is_integer() for x in b):
        assert np.array_equal(a, b), name
    else:
        ep.assert_close(a, b, TOL, name)


#: the tabular wrappers' cross products are sized for the battery+PV
#: district's one action a building
PAIRS = [(family, case) for case in CASES for family in ("battery", "ev")
         if family == "battery" or not case[1].startswith("Tabular")]


@pytest.mark.parametrize("family,case", PAIRS, ids=[f"{c[0]}-{f}" for f, c in PAIRS])
def test_wrapper_matches_jax(schemas, family, case):
    _, name, wkw, env_kw = case
    ours = getattr(wrappers, name)(CityLearnEnv(schemas[family], device="cpu", **env_kw), **wkw)
    ref = getattr(jax_wrappers, name)(citylearn_tpu.CityLearnEnv(schemas[family], **env_kw),
                                      **wkw)
    assert [space_summary(s) for s in ours.observation_space] == \
        [space_summary(s) for s in ref.observation_space]
    assert [space_summary(s) for s in ours.action_space] == \
        [space_summary(s) for s in ref.action_space]
    if hasattr(ref, "observation_names") and name.startswith("Normalized"):
        assert ours.observation_names == ref.observation_names
    o1, _ = ours.reset()
    o2, _ = ref.reset()
    assert_obs(o1, o2, "reset")
    rng = np.random.RandomState(3)
    for t in range(STEPS):
        acts = random_actions(ref.action_space, rng)
        o1, r1, term1, trunc1, _ = ours.step(acts)
        o2, r2, term2, trunc2, _ = ref.step(acts)
        assert (term1, trunc1) == (term2, trunc2)
        assert_obs(o1, o2, f"step {t}")
        ep.assert_close(r1, r2, TOL, f"reward {t}")


def test_stable_baselines3_wrapper_matches_jax(schemas):
    env_kw = dict(KW, central_agent=True)
    ours = wrappers.StableBaselines3Wrapper(wrappers.NormalizedSpaceWrapper(
        CityLearnEnv(schemas["battery"], device="cpu", **env_kw)))
    ref = jax_wrappers.StableBaselines3Wrapper(jax_wrappers.NormalizedSpaceWrapper(
        citylearn_tpu.CityLearnEnv(schemas["battery"], **env_kw)))
    assert space_summary(ours.observation_space) == space_summary(ref.observation_space)
    assert space_summary(ours.action_space) == space_summary(ref.action_space)
    o1, _ = ours.reset()
    o2, _ = ref.reset()
    assert o1.dtype == o2.dtype == np.float32 and o1.shape == o2.shape
    ep.assert_close(o1, o2, TOL, "reset")
    rng = np.random.RandomState(4)
    for t in range(STEPS):
        a = rng.uniform(0, 1, ref.action_space.shape).astype(np.float32)
        o1, r1, term1, *_ = ours.step(a)
        o2, r2, term2, *_ = ref.step(a)
        assert isinstance(r1, float) and term1 == term2
        ep.assert_close(o1, o2, TOL, f"step {t}")
        ep.assert_close(r1, r2, TOL, f"reward {t}")


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_rllib_wrappers_match_jax(schemas, multi):
    """The RLlib wrappers build their own env from ``env_config``; the
    port's builds the port's ``CityLearnEnv``."""
    name = "RLlibMultiAgentEnv" if multi else "RLlibSingleAgentWrapper"
    config = {"env_kwargs": dict(KW, schema=schemas["battery"]),
              "wrappers": [wrappers.NormalizedObservationWrapper]}
    ours = getattr(wrappers, name)({"env_kwargs": dict(config["env_kwargs"], device="cpu"),
                                    "wrappers": config["wrappers"]})
    ref = getattr(jax_wrappers, name)({"env_kwargs": config["env_kwargs"],
                                       "wrappers": [jax_wrappers.NormalizedObservationWrapper]})
    assert isinstance(ours.env.unwrapped, CityLearnEnv)
    assert ours.central_agent is (not multi)
    o1, i1 = ours.reset()
    o2, i2 = ref.reset()
    rng = np.random.RandomState(5)
    for t in range(STEPS):
        if multi:
            assert sorted(o1) == sorted(o2) and i1 == i2
            for k in o2:
                ep.assert_close(o1[k], o2[k], TOL, f"{k} step {t}")
            acts = {k: rng.uniform(s.low, s.high).astype(np.float32)
                    for k, s in ref.action_space.items()}
        else:
            ep.assert_close(o1, o2, TOL, f"step {t}")
            acts = rng.uniform(ref.action_space.low, ref.action_space.high).astype(np.float32)
        o1, r1, term1, trunc1, i1 = ours.step(acts)
        o2, r2, term2, trunc2, i2 = ref.step(acts)
        assert term1 == term2 and trunc1 == trunc2
        if multi:
            ep.assert_close([r1[k] for k in r2], list(r2.values()), TOL, f"reward {t}")
        else:
            ep.assert_close(r1, r2, TOL, f"reward {t}")


def test_wrappers_without_gymnasium(schemas):
    code = (
        "import sys; sys.modules['gymnasium'] = None\n"
        "from citylearn_tpu_torch import CityLearnEnv, wrappers\n"
        "from citylearn_tpu_torch.spaces import Box\n"
        f"env = CityLearnEnv({schemas['battery']!r}, episode_time_steps=8, device='cpu')\n"
        "w = wrappers.NormalizedSpaceWrapper(env)\n"
        "obs, _ = w.reset()\n"
        "w.step([[0.5] * s.shape[0] for s in w.action_space])\n"
        "print(all(type(s) is Box for s in w.observation_space + w.action_space))\n"
        "try:\n    wrappers.DiscreteSpaceWrapper(env).observation_space\n"
        "except ImportError as e:\n    print('gymnasium' in str(e))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["True", "True"]
