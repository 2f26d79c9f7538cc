"""Episode window selection (reference ``citylearn/base.py:6-134``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np


class EpisodeTracker:
    """Fixed / rolling / random episode splits over the simulation range.

    Reproduces ``citylearn.base.EpisodeTracker`` exactly, including the
    random-split seed derivation ``seed = random_seed * (episode + 1)`` and
    ``choice(len(splits) - 1)`` (which never selects the last split —
    shipped quirk, ``base.py:121-124``)."""

    def __init__(self, simulation_start_time_step: int, simulation_end_time_step: int):
        self.simulation_start_time_step = simulation_start_time_step
        self.simulation_end_time_step = simulation_end_time_step
        self.episode = -1
        self.episode_start_time_step: Optional[int] = None
        self.episode_end_time_step: Optional[int] = None

    @property
    def episode_time_steps(self) -> int:
        return self.episode_end_time_step - self.episode_start_time_step + 1

    @property
    def simulation_time_steps(self) -> int:
        return self.simulation_end_time_step - self.simulation_start_time_step + 1

    def next_episode(self, episode_time_steps: Union[int, List, None],
                     rolling_episode_split: bool, random_episode_split: bool,
                     random_seed: int) -> Tuple[int, int]:
        self.episode += 1
        if isinstance(episode_time_steps, list):
            splits = [list(s) for s in episode_time_steps]
        else:
            n = (self.simulation_time_steps if episode_time_steps is None
                 else int(episode_time_steps))
            earliest = self.simulation_start_time_step
            latest = (self.simulation_end_time_step + 1) - n
            step = 1 if rolling_episode_split else n
            starts = list(range(earliest, latest + 1, step))
            splits = [[s, s + n - 1] for s in starts]

        if random_episode_split:
            seed = int(random_seed * (self.episode + 1))
            ix = np.random.RandomState(seed).choice(len(splits) - 1)
        else:
            ix = self.episode % len(splits)

        self.episode_start_time_step, self.episode_end_time_step = splits[ix]
        return self.episode_start_time_step, self.episode_end_time_step
