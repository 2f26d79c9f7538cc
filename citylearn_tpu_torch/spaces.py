"""Observation and action spaces without gymnasium.

The env, its building views and the agents read a space's ``low``,
``high``, ``shape`` and ``dtype``, and draw from it with ``sample()``. A
machine without gymnasium still runs them: :func:`box` returns
``gymnasium.spaces.Box`` where gymnasium imports, and :class:`Box`, which
carries the same attributes and draws the same numbers from the same
seed, where it does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Box:
    """A float32 box: the part of ``gymnasium.spaces.Box`` that the port's
    agents, encoders and wrappers read. Draws come from an explicit
    ``np.random.Generator`` (``seed()``), in gymnasium's order."""

    def __init__(self, low, high):
        self.dtype = np.dtype(np.float32)
        self.low = np.asarray(low, self.dtype)
        self.high = np.asarray(high, self.dtype)
        if self.low.shape != self.high.shape:
            raise ValueError(f"low {self.low.shape} and high {self.high.shape} differ in shape")
        self.shape = self.low.shape
        self.np_random = np.random.default_rng()

    def seed(self, seed: Optional[int] = None) -> "Box":
        self.np_random = np.random.default_rng(seed)
        return self

    def sample(self) -> np.ndarray:
        """A uniform draw in the box; a normal or exponential one along a
        side without a bound (``gymnasium.spaces.Box.sample``)."""
        below, above = -np.inf < self.low, self.high < np.inf
        high = self.high.astype(np.float64)
        out = np.empty(self.shape)
        free, low_only = ~below & ~above, below & ~above
        high_only, both = ~below & above, below & above
        out[free] = self.np_random.normal(size=int(free.sum()))
        out[low_only] = self.np_random.exponential(size=int(low_only.sum())) + self.low[low_only]
        out[high_only] = -self.np_random.exponential(size=int(high_only.sum())) + high[high_only]
        out[both] = self.np_random.uniform(low=self.low[both], high=high[both],
                                           size=int(both.sum()))
        return out.astype(self.dtype)

    def contains(self, x) -> bool:
        if not isinstance(x, np.ndarray):
            try:
                x = np.asarray(x, dtype=self.dtype)
            except (ValueError, TypeError):
                return False
        return bool(np.can_cast(x.dtype, self.dtype) and x.shape == self.shape
                    and np.all(x >= self.low) and np.all(x <= self.high))


def box(low, high):
    """A float32 ``gymnasium.spaces.Box(low, high)`` where gymnasium
    imports, else the port's :class:`Box`."""
    try:
        from gymnasium import spaces as gym_spaces
    except ImportError:
        return Box(low, high)
    return gym_spaces.Box(low=np.asarray(low, np.float32), high=np.asarray(high, np.float32),
                          dtype=np.float32)
