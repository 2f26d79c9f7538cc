"""Agent base classes (reference ``citylearn/agents/base.py``).

The host-side agent API mirrors the reference exactly:
``learn(episodes)`` drives reset -> predict -> step -> update; ``predict``
returns per-agent action lists. The agents step
:class:`citylearn_tpu_torch.envs.environment.CityLearnEnv` on its device;
the batched training path lives in :mod:`citylearn_tpu_torch.train` and
does not go through this interface.
"""

from __future__ import annotations

import logging
from typing import Any, List

import numpy as np

LOGGER = logging.getLogger(__name__)


class Agent:
    """Random-action base agent (reference ``agents/base.py:10-236``)."""

    def __init__(self, env, **kwargs: Any):
        self.env = env
        self.observation_names = env.observation_names
        self.action_names = env.action_names
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.episode_time_steps = env.time_steps
        self.random_seed = getattr(env.spec, "random_seed", 0)
        self._np_random = np.random.RandomState(self.random_seed)
        self.reset()

    @property
    def action_dimension(self) -> List[int]:
        return [s.shape[0] for s in self.action_space]

    def learn(self, episodes: int = None, deterministic: bool = None,
              deterministic_finish: bool = None, logging_level: int = None):
        """Episode loop (reference ``agents/base.py:127-186``)."""
        episodes = 1 if episodes is None else episodes
        deterministic_finish = bool(deterministic_finish)
        deterministic = bool(deterministic)

        for episode in range(episodes):
            det = deterministic or (deterministic_finish and episode >= episodes - 1)
            observations, _ = self.env.reset()
            terminated = False
            rewards_list = []
            while not terminated:
                actions = self.predict(observations, deterministic=det)
                next_observations, rewards, terminated, truncated, _ = \
                    self.env.step(actions)
                rewards_list.append(rewards)
                if not det:
                    self.update(observations, actions, rewards, next_observations,
                                terminated=terminated, truncated=truncated)
                observations = [list(o) for o in next_observations]
            r = np.array(rewards_list, dtype=float)
            LOGGER.info("episode %d/%d reward sum %s", episode + 1, episodes,
                        r.sum(axis=0))

    def predict(self, observations, deterministic: bool = None):
        return [list(s.sample()) for s in self.action_space]

    def update(self, *args, **kwargs):
        pass

    def reset(self):
        pass


class BaselineAgent(Agent):
    """No-control baseline: empty actions and deactivated action surface
    (reference ``agents/base.py:238-284``). The env reads each building's
    ``active_actions`` at every step, so emptying them after the env was
    built takes effect at its next ``reset``/``step``."""

    def __init__(self, env, **kwargs: Any):
        for b in env.spec.buildings:
            b.active_actions = []
            b.action_low, b.action_high = [], []
        super().__init__(env, **kwargs)

    def predict(self, observations, deterministic: bool = None):
        return [[] for _ in self.action_names]
