"""Tabular Q-Learning with epsilon-greedy exploration
(reference ``citylearn/agents/q_learning.py``); use with
:class:`citylearn_tpu_torch.wrappers.TabularQLearningWrapper`."""

from __future__ import annotations

import math
from typing import Any, List

import numpy as np

from citylearn_tpu_torch.agents.base import Agent


class TabularQLearning(Agent):
    def __init__(self, env, epsilon: float = None, minimum_epsilon: float = None,
                 epsilon_decay: float = None, learning_rate: float = None,
                 discount_factor: float = None, q_init_value: float = None,
                 **kwargs: Any):
        super().__init__(env, **kwargs)
        self.epsilon = 1.0 if epsilon is None else epsilon
        self.epsilon_init = self.epsilon
        self.minimum_epsilon = 0.01 if minimum_epsilon is None else minimum_epsilon
        self.epsilon_decay = 1e-4 if epsilon_decay is None else epsilon_decay
        self.learning_rate = 0.05 if learning_rate is None else learning_rate
        self.discount_factor = 0.90 if discount_factor is None else discount_factor
        self.q_init_value = np.nan if q_init_value is None else q_init_value
        self.time_step = 0
        self.q = [np.full((od.n, ad.n), self.q_init_value)
                  for od, ad in zip(self.observation_space, self.action_space)]
        self.q_exploration = [np.zeros_like(x) for x in self.q]
        self.q_exploitation = [np.zeros_like(x) for x in self.q]
        self.__explored = False

    def predict(self, observations: List[List[float]], deterministic: bool = None):
        deterministic = bool(deterministic)
        nprs = np.random.RandomState(None if self.random_seed is None
                                     else self.random_seed + self.time_step)
        if deterministic or nprs.random() > self.epsilon:
            actions = self._exploit(observations)
            self.__explored = False
        else:
            actions = [[s.sample()] for s in self.action_space]
            self.__explored = True
        episode = int(self.time_step / self.episode_time_steps)
        self.epsilon = max(self.minimum_epsilon,
                           self.epsilon_init * np.exp(-self.epsilon_decay * episode))
        self.time_step += 1
        return actions

    def _exploit(self, observations):
        actions = []
        for i, o in enumerate(observations):
            o = int(o[0])
            try:
                a = int(np.nanargmax(self.q[i][o]))
            except ValueError:
                a = self.action_space[i].sample()
            actions.append([a])
        return actions

    def update(self, observations, actions, reward, next_observations,
               terminated: bool, truncated: bool):
        for i, (o, a, r, n) in enumerate(zip(observations, actions, reward,
                                             next_observations)):
            o, n, a = int(o[0]), int(n[0]), int(a[0])
            current_q = self.q[i][o, a]
            current_q = 0.0 if math.isnan(current_q) else current_q
            try:
                # quirk preserved: the reference uses nanargmax (the argmax
                # *index*, not the max value) in the TD target
                # (q_learning.py:142)
                next_max_q = float(np.nanargmax(self.q[i][n]))
            except ValueError:
                next_max_q = 0.0
            self.q[i][o, a] = current_q + self.learning_rate * (
                r + self.discount_factor * next_max_q - current_q)
            if self.__explored:
                self.q_exploration[i][o, a] += 1
            else:
                self.q_exploitation[i][o, a] += 1

    def reset(self):
        super().reset()
        self.time_step = 0
