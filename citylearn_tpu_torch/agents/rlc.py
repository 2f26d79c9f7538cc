"""RLC hyperparameter base (reference ``citylearn/agents/rlc.py``)."""

from __future__ import annotations

from typing import Any, List

from citylearn_tpu_torch.agents.base import Agent
from citylearn_tpu_torch.preprocessing import (
    Encoder,
    Normalize,
    OnehotEncoding,
    PeriodicNormalization,
    encoded_dimension,
)


class RLC(Agent):
    def __init__(self, env, hidden_dimension: List[int] = None,
                 discount: float = None, tau: float = None, alpha: float = None,
                 lr: float = None, batch_size: int = None,
                 replay_buffer_capacity: int = None,
                 standardize_start_time_step: int = None,
                 end_exploration_time_step: int = None,
                 action_scaling_coefficienct: float = None,
                 reward_scaling: float = None,
                 update_per_time_step: int = None, **kwargs: Any):
        super().__init__(env, **kwargs)
        self.hidden_dimension = hidden_dimension or [256, 256]
        self.discount = 0.99 if discount is None else discount
        self.tau = 5e-3 if tau is None else tau
        self.alpha = 0.2 if alpha is None else alpha
        self.lr = 3e-4 if lr is None else lr
        self.batch_size = 256 if batch_size is None else int(batch_size)
        self.replay_buffer_capacity = int(replay_buffer_capacity or 1e5)
        # defaults per reference rlc.py docstring: T-2 / T-1
        T = env.time_steps
        self.standardize_start_time_step = (T - 2 if standardize_start_time_step is None
                                            else int(standardize_start_time_step))
        self.end_exploration_time_step = (T - 1 if end_exploration_time_step is None
                                          else int(end_exploration_time_step))
        self.action_scaling_coefficient = (0.5 if action_scaling_coefficienct is None
                                           else action_scaling_coefficienct)
        self.reward_scaling = 5.0 if reward_scaling is None else reward_scaling
        self.update_per_time_step = 2 if update_per_time_step is None else int(update_per_time_step)
        self.encoders = self.set_encoders()

    @property
    def observation_dimension(self) -> List[int]:
        return [encoded_dimension(e) for e in self.encoders]

    def set_encoders(self) -> List[List[Encoder]]:
        """Reference ``rlc.py:207-240``."""
        encoders = []
        for names, space in zip(self.observation_names, self.observation_space):
            e = []
            for i, n in enumerate(names):
                if n in ("month", "hour"):
                    e.append(PeriodicNormalization(space.high[i]))
                elif n == "day_type":
                    e.append(OnehotEncoding([1, 2, 3, 4, 5, 6, 7, 8]))
                elif n == "daylight_savings_status":
                    e.append(OnehotEncoding([0, 1]))
                else:
                    e.append(Normalize(space.low[i], space.high[i]))
            encoders.append(e)
        return encoders
