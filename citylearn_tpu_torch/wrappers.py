"""Gym wrappers (reference ``citylearn/wrappers.py``): normalization,
discretization, tabular-Q combinatorial spaces, SB3/RLlib adapters.

These wrap :class:`citylearn_tpu_torch.envs.environment.CityLearnEnv`
(whose step/reset API mirrors the reference's list-of-lists protocol).
Box spaces come from :func:`citylearn_tpu_torch.spaces.box` (gymnasium's
where it imports); the discrete spaces need gymnasium, imported when they
are built, and raise an ``ImportError`` that names it where it is absent.
Importing this module imports no gymnasium: the SB3 and single-agent RLlib
wrappers, which are ``gymnasium.Env``s where gymnasium imports, are made
on their first access (the module's ``__getattr__``).
"""

from __future__ import annotations

import itertools
from typing import Any, List, Mapping, Tuple

import numpy as np

from citylearn_tpu_torch.spaces import box

PERIODIC_METADATA = {"hour": range(1, 25), "day_type": range(1, 8),
                     "month": range(1, 13), "minutes": range(1, 61)}


def _discrete_spaces():
    """``gymnasium.spaces``, for the spaces that only gymnasium has."""
    try:
        from gymnasium import spaces
    except ImportError as e:
        raise ImportError("the Discrete and MultiDiscrete spaces of the discretizing "
                          "wrappers need gymnasium, which is not installed") from e
    return spaces


class Wrapper:
    """Minimal pass-through wrapper base."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, actions):
        return self.env.step(actions)


class ClippedObservationWrapper(Wrapper):
    """Clip observations into their space bounds (reference ``wrappers.py:15-38``)."""

    @property
    def observations(self):
        return self._clip(self.env.observations)

    def _clip(self, obs):
        out = []
        for o, s in zip(obs, self.env.observation_space):
            out.append(list(np.clip(np.asarray(o, float), s.low, s.high)))
        return out

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._clip(obs), info

    def step(self, actions):
        obs, r, term, trunc, info = self.env.step(actions)
        return self._clip(obs), r, term, trunc, info


def _periodic_limits(x_max) -> Tuple[Mapping[str, float], Mapping[str, float]]:
    vals = np.arange(1, x_max + 1)
    enc = 2 * np.pi * vals / x_max
    sin, cos = np.sin(enc), np.cos(enc)
    return {"sin": (sin.min(), sin.max()), "cos": (cos.min(), cos.max())}


class NormalizedObservationWrapper(Wrapper):
    """Periodic sin/cos + min-max [0,1] normalization
    (reference ``wrappers.py:39-168``). Periodic keys expand to
    ``<name>_cos``, ``<name>_sin`` (in that order, ``building.py:1196-1201``)."""

    def __init__(self, env):
        super().__init__(env)
        self._build_limits()

    def _build_limits(self):
        self._norms = []       # per building: list of (kind, params)
        self._names = []
        for b in self.env.spec.buildings:
            row, names = [], []
            for name in b.active_observations:
                if name in PERIODIC_METADATA:
                    x_max = max(PERIODIC_METADATA[name])
                    lim = _periodic_limits(x_max)
                    row.append(("periodic", x_max, lim))
                    names.extend([f"{name}_cos", f"{name}_sin"])
                else:
                    row.append(("minmax", b.observation_low[name],
                                b.observation_high[name]))
                    names.append(name)
            self._norms.append(row)
            self._names.append(names)

    @property
    def observation_names(self) -> List[List[str]]:
        if not self.env.central_agent:
            return [list(n) for n in self._names]
        merged, seen = [], []
        shared = self.env.shared_observations
        for bi, b in enumerate(self.env.spec.buildings):
            for base, names in zip(b.active_observations, self._grouped_names(bi)):
                if bi == 0 or base not in shared or base not in seen:
                    merged.extend(names)
                if base in shared and base not in seen:
                    seen.append(base)
        return [merged]

    def _grouped_names(self, bi):
        b = self.env.spec.buildings[bi]
        out = []
        for name in b.active_observations:
            if name in PERIODIC_METADATA:
                out.append([f"{name}_cos", f"{name}_sin"])
            else:
                out.append([name])
        return out

    @property
    def observation_space(self):
        out = []
        for row in self._norms:
            n = sum(2 if kind == "periodic" else 1 for kind, *rest in row)
            out.append(box(np.zeros(n, np.float32), np.ones(n, np.float32)))
        if not self.env.central_agent:
            return out
        merged_len = len(self.observation_names[0])
        return [box(np.zeros(merged_len, np.float32), np.ones(merged_len, np.float32))]

    def _transform_building(self, bi, values):
        out = []
        for (kind, *p), v in zip(self._norms[bi], values):
            if kind == "periodic":
                x_max, lim = p
                enc = 2 * np.pi * v / x_max
                sin, cos = np.sin(enc), np.cos(enc)
                slo, shi = lim["sin"]
                clo, chi = lim["cos"]
                out.append(0.0 if chi == clo else (cos - clo) / (chi - clo))
                out.append(0.0 if shi == slo else (sin - slo) / (shi - slo))
            else:
                lo, hi = p
                out.append(0.0 if hi == lo else (v - lo) / (hi - lo))
        return out

    def _transform(self, obs_per_building):
        if not self.env.central_agent:
            return [self._transform_building(bi, o)
                    for bi, o in enumerate(obs_per_building)]
        # central: obs came merged; re-split by building using dedup order
        values = list(obs_per_building[0])
        merged, seen = [], []
        shared = self.env.shared_observations
        shared_cache = {}
        for bi, b in enumerate(self.env.spec.buildings):
            row = []
            for name in b.active_observations:
                if bi == 0 or name not in shared or name not in seen:
                    row.append(values.pop(0))
                    if name in shared:
                        shared_cache[name] = row[-1]
                        if name not in seen:
                            seen.append(name)
                else:
                    row.append(shared_cache[name])
            t = self._transform_building(bi, row)
            # drop shared duplicates from the merged output
            keep = []
            idx = 0
            for name in b.active_observations:
                n_out = 2 if name in PERIODIC_METADATA else 1
                if bi == 0 or name not in shared:
                    keep.extend(t[idx:idx + n_out])
                idx += n_out
            merged.extend(keep)
        return [merged]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._transform(obs), info

    def step(self, actions):
        obs, r, term, trunc, info = self.env.step(actions)
        return self._transform(obs), r, term, trunc, info


class NormalizedActionWrapper(Wrapper):
    """Agent acts in [0, 1]; denormalized to true bounds
    (reference ``wrappers.py:169-223``)."""

    @property
    def action_space(self):
        return [box(np.zeros(s.shape[0], np.float32), np.ones(s.shape[0], np.float32))
                for s in self.env.action_space]

    def step(self, actions):
        denorm = []
        for a, s in zip(actions, self.env.action_space):
            a = np.asarray(a, float)
            denorm.append(list(s.low + a * (s.high - s.low)))
        return self.env.step(denorm)


class NormalizedSpaceWrapper(Wrapper):
    """Both of the above (reference ``wrappers.py:224-240``)."""

    def __init__(self, env):
        super().__init__(NormalizedActionWrapper(NormalizedObservationWrapper(env)))


class DiscreteObservationWrapper(Wrapper):
    """Bin observations into MultiDiscrete (reference ``wrappers.py:241-309``)."""

    def __init__(self, env, bin_sizes=None, default_bin_size: int = None):
        super().__init__(env)
        self.default_bin_size = 10 if default_bin_size is None else default_bin_size
        self.bin_sizes = self._resolve_bins(bin_sizes)

    def _resolve_bins(self, bin_sizes):
        out = []
        for b in self.env.spec.buildings:
            provided = bin_sizes or {}
            if isinstance(provided, list):
                provided = provided[b.index]
            out.append([int(provided.get(n, self.default_bin_size))
                        for n in b.active_observations])
        return out

    @property
    def observation_space(self):
        return [_discrete_spaces().MultiDiscrete(np.asarray(bins))
                for bins in self.bin_sizes]

    def _discretize(self, obs):
        # exact reference semantics (wrappers.py:295-308):
        # np.digitize(v, linspace(lo, hi, n), right=True) — UNclamped, so
        # the result ranges over 0..n inclusive (n + 1 values)
        out = []
        for o, s, bins in zip(obs, self.env.observation_space, self.bin_sizes):
            row = [int(np.digitize(v, np.linspace(lo, hi, n), right=True))
                   for v, lo, hi, n in zip(o, s.low, s.high, bins)]
            out.append(row)
        return out

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._discretize(obs), info

    def step(self, actions):
        obs, r, term, trunc, info = self.env.step(actions)
        return self._discretize(obs), r, term, trunc, info


class DiscreteActionWrapper(Wrapper):
    """MultiDiscrete actions -> continuous bins (reference ``wrappers.py:310-367``)."""

    def __init__(self, env, bin_sizes=None, default_bin_size: int = None):
        super().__init__(env)
        self.default_bin_size = 10 if default_bin_size is None else default_bin_size
        self.bin_sizes = []
        for b in self.env.spec.buildings:
            provided = bin_sizes or {}
            if isinstance(provided, list):
                provided = provided[b.index]
            self.bin_sizes.append([int(provided.get(n, self.default_bin_size))
                                   for n in b.active_actions])

    @property
    def action_space(self):
        return [_discrete_spaces().MultiDiscrete(np.asarray(bins))
                for bins in self.bin_sizes]

    def step(self, actions):
        cont = []
        for a, s, bins in zip(actions, self.env.action_space, self.bin_sizes):
            row = [np.linspace(lo, hi, n)[int(v)]
                   for v, lo, hi, n in zip(np.ravel(a), s.low, s.high, bins)]
            cont.append(row)
        return self.env.step(cont)


class DiscreteSpaceWrapper(Wrapper):
    def __init__(self, env, observation_bin_sizes=None, action_bin_sizes=None,
                 default_observation_bin_size: int = None,
                 default_action_bin_size: int = None):
        super().__init__(DiscreteActionWrapper(
            DiscreteObservationWrapper(env, observation_bin_sizes,
                                       default_observation_bin_size),
            action_bin_sizes, default_action_bin_size))


class TabularQLearningObservationWrapper(Wrapper):
    """Cross-product Discrete observation index (reference ``wrappers.py:393-441``).

    Combinations enumerate ``range(n + 1)`` per dimension because the
    unclamped right-inclusive digitize yields n + 1 possible values, and
    the space is ``Discrete(len(combinations) - 1)`` — both reference
    quirks (``wrappers.py:417-440``)."""

    def __init__(self, env, bin_sizes=None, default_bin_size: int = None):
        super().__init__(DiscreteObservationWrapper(env, bin_sizes,
                                                    default_bin_size))
        self.combinations = [list(itertools.product(*[range(n + 1) for n in bins]))
                             for bins in self.env.bin_sizes]

    @property
    def observation_space(self):
        return [_discrete_spaces().Discrete(len(c) - 1) for c in self.combinations]

    def _index(self, obs):
        return [[c.index(tuple(o))] for o, c in zip(obs, self.combinations)]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._index(obs), info

    def step(self, actions):
        obs, r, term, trunc, info = self.env.step(actions)
        return self._index(obs), r, term, trunc, info


class TabularQLearningActionWrapper(Wrapper):
    """Cross-product Discrete action index (reference ``wrappers.py:442-490``)."""

    def __init__(self, env, bin_sizes=None, default_bin_size: int = None):
        super().__init__(DiscreteActionWrapper(env, bin_sizes, default_bin_size))
        self.combinations = [list(itertools.product(*[range(n) for n in bins]))
                             for bins in self.env.bin_sizes]

    @property
    def action_space(self):
        return [_discrete_spaces().Discrete(len(c)) for c in self.combinations]

    def step(self, actions):
        expanded = [list(c[int(np.ravel(a)[0])])
                    for a, c in zip(actions, self.combinations)]
        return self.env.step(expanded)


class TabularQLearningWrapper(Wrapper):
    def __init__(self, env, observation_bin_sizes=None, action_bin_sizes=None,
                 default_observation_bin_size: int = None,
                 default_action_bin_size: int = None):
        super().__init__(TabularQLearningActionWrapper(
            TabularQLearningObservationWrapper(env, observation_bin_sizes,
                                               default_observation_bin_size),
            action_bin_sizes, default_action_bin_size))


class _StableBaselines3Methods:
    """Flatten central-agent lists to single arrays; scalar reward
    (reference ``wrappers.py:516-622``)."""

    def __init__(self, env):
        assert env.central_agent, "SB3 wrapper requires central_agent=True"
        self.env = env
        self.metadata = {"render_modes": []}
        self.render_mode = None

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def observation_space(self):
        return self.env.observation_space[0]

    @property
    def action_space(self):
        return self.env.action_space[0]

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return np.asarray(obs[0], np.float32), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step([list(np.ravel(action))])
        return (np.asarray(obs[0], np.float32), float(reward[0]),
                terminated, truncated, info)

    def render(self):
        return self.env.render()


class _RLlibSingleAgentMethods:
    """SB3-style flattening with an env_config constructor
    (reference ``wrappers.py:623-663``): ``env_config['env_kwargs']``
    initializes the env (central_agent forced True) and an optional
    ``env_config['wrappers']`` list wraps it first."""

    def __init__(self, env_config: Mapping[str, Any]):
        from citylearn_tpu_torch.envs.environment import CityLearnEnv
        env_kwargs = dict(env_config["env_kwargs"])
        env_kwargs["central_agent"] = True
        assert "schema" in env_kwargs, "missing schema key in env_kwargs."
        env = CityLearnEnv(**env_kwargs)
        for w in (env_config.get("wrappers") or []):
            env = w(env)
        StableBaselines3Wrapper.__init__(self, env)


class RLlibMultiAgentEnv:
    """Dict-keyed per-building multi-agent protocol with ``agent_<i>``
    policy ids (reference ``wrappers.py:664-856``): env_config['env_kwargs']
    initializes the env (central_agent forced False), optional
    env_config['wrappers'] wrap first."""

    def __init__(self, env_config: Mapping[str, Any]):
        from citylearn_tpu_torch.envs.environment import CityLearnEnv
        env_kwargs = dict(env_config["env_kwargs"])
        env_kwargs["central_agent"] = False
        assert "schema" in env_kwargs, "missing schema key in env_kwargs."
        env = CityLearnEnv(**env_kwargs)
        for w in (env_config.get("wrappers") or []):
            env = w(env)
        self.env = env
        self._agent_ids = [f"agent_{i}"
                           for i in range(len(self.env.spec.buildings))]

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def observation_space(self):
        return {a: s for a, s in zip(self._agent_ids, self.env.observation_space)}

    @property
    def action_space(self):
        return {a: s for a, s in zip(self._agent_ids, self.env.action_space)}

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return ({a: np.asarray(o, np.float32) for a, o in zip(self._agent_ids, obs)},
                {a: {} for a in self._agent_ids})

    def step(self, action_dict):
        actions = [list(np.ravel(action_dict[a])) for a in self._agent_ids]
        obs, rewards, terminated, truncated, info = self.env.step(actions)
        obs_d = {a: np.asarray(o, np.float32) for a, o in zip(self._agent_ids, obs)}
        rew_d = {a: float(r) for a, r in zip(self._agent_ids, rewards)}
        term_d = {a: terminated for a in self._agent_ids}
        term_d["__all__"] = terminated
        trunc_d = {a: truncated for a in self._agent_ids}
        trunc_d["__all__"] = truncated
        return obs_d, rew_d, term_d, trunc_d, {a: {} for a in self._agent_ids}


def _env_classes():
    """``StableBaselines3Wrapper`` and ``RLlibSingleAgentWrapper`` on
    ``gymnasium.Env`` where gymnasium imports, else on :class:`Wrapper`."""
    try:
        from gymnasium import Env as base
    except ImportError:
        base = Wrapper
    made = {}
    for name, methods, parent in (("StableBaselines3Wrapper", _StableBaselines3Methods, base),
                                  ("RLlibSingleAgentWrapper", _RLlibSingleAgentMethods, None)):
        bases = (methods, parent or made["StableBaselines3Wrapper"])
        made[name] = type(name, bases, {"__module__": __name__, "__qualname__": name,
                                        "__doc__": methods.__doc__})
    return made


def __getattr__(name):
    if name in ("StableBaselines3Wrapper", "RLlibSingleAgentWrapper"):
        globals().update(_env_classes())
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
