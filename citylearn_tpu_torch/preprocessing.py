"""Observation encoders of the host-loop agents (reference
``citylearn/preprocessing.py``), in numpy.

Each encoder maps one observation value by ``encoder * value`` (the
reference applies them elementwise via ``__rmul__``); :func:`encode`
concatenates an encoder list's outputs and drops ``None``."""

from __future__ import annotations

from typing import Any, List, Union

import numpy as np


class Encoder:
    def __mul__(self, x):
        raise NotImplementedError

    __rmul__ = __mul__


class NoNormalization(Encoder):
    def __mul__(self, x):
        return x
    __rmul__ = __mul__


class PeriodicNormalization(Encoder):
    """sin/cos pair (reference ``preprocessing.py:38-79``)."""

    def __init__(self, x_max):
        self.x_max = x_max

    def __mul__(self, x):
        v = 2 * np.pi * x / self.x_max
        return np.array([np.sin(v), np.cos(v)])
    __rmul__ = __mul__


class OnehotEncoding(Encoder):
    def __init__(self, classes):
        self.classes = classes

    def __mul__(self, x):
        identity = np.eye(len(self.classes))
        return identity[np.array(self.classes) == x][0]
    __rmul__ = __mul__


class Normalize(Encoder):
    def __init__(self, x_min, x_max):
        self.x_min = x_min
        self.x_max = x_max

    def __mul__(self, x):
        if self.x_min == self.x_max:
            return 0
        return (x - self.x_min) / (self.x_max - self.x_min)
    __rmul__ = __mul__


class NormalizeWithMissing(Normalize):
    """Normalize that maps a sentinel 'missing' value to a fixed output."""

    def __init__(self, x_min, x_max, missing_value=-0.1, default=-1.0):
        super().__init__(x_min, x_max)
        self.missing_value = missing_value
        self.default = default

    def __mul__(self, x):
        if x == self.missing_value:
            return self.default
        return super().__mul__(x)
    __rmul__ = __mul__


class RemoveFeature(Encoder):
    def __mul__(self, x):
        return None
    __rmul__ = __mul__


def encode(encoders: List[Encoder], observations) -> np.ndarray:
    """Apply encoders elementwise and drop ``None`` outputs
    (reference ``sac.py:232``: ``hstack`` then filter None)."""
    out = []
    for e, x in zip(encoders, observations):
        v = e * x
        if v is None:
            continue
        arr = np.atleast_1d(np.asarray(v, dtype=float))
        out.append(arr)
    if not out:
        return np.zeros(0)
    return np.concatenate(out)


def encoded_dimension(encoders: List[Encoder]) -> int:
    """Output length of :func:`encode` (reference ``rlc.py:75``)."""
    n = 0
    for e in encoders:
        if isinstance(e, RemoveFeature):
            continue
        if isinstance(e, PeriodicNormalization):
            n += 2
        elif isinstance(e, OnehotEncoding):
            n += len(e.classes)
        else:
            n += 1
    return n
