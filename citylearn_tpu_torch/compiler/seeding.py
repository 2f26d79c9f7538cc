"""Reference-compatible seeded parameter resolution.

The reference resolves stochastic device parameters at construction time:

- Tuple-valued parameters are sampled uniformly with a *fresh*
  ``np.random.RandomState(seed)`` per access (the ``numpy_random_state``
  property constructs a new RandomState on every call; see reference
  ``citylearn/base.py:203-206`` and ``energy_model.py:65-84``). The net
  effect is that every tuple sample from one device uses the same base
  uniform draw scaled to its own ``(lo, hi)`` range.
- Each device receives a deterministic seed hashed from
  ``(building_name, building_type, device_name, device_type)`` via a
  cumulative md5 (reference ``citylearn/citylearn.py:2364-2378``).

We replicate both behaviors exactly at compile time (host-side numpy) so
that resolved parameters — including the default randomized battery
power-efficiency and capacity-power curves
(``energy_model.py:977-1003``) — are bit-identical with the reference.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

Number = Union[int, float]


def device_random_seed(building_name: str, building_type: str,
                       device_name: str, device_type: str,
                       schema_random_seed: int) -> int:
    """Deterministic per-device seed (reference ``citylearn.py:2364-2378``)."""
    md5 = hashlib.md5()
    seed = 0
    for string in [building_name, building_type, device_name, device_type]:
        md5.update(string.encode())
        seed += int(md5.hexdigest(), 16)
    return int(str(seed * (schema_random_seed + 1))[:9])


def sample_uniform(seed: int, lo: float, hi: float) -> float:
    """First draw of a fresh ``RandomState(seed).uniform(lo, hi)``."""
    return float(np.random.RandomState(seed).uniform(lo, hi))


def resolve(value: Any, default: Union[Number, Tuple[Number, Number]],
            seed: Optional[int]) -> float:
    """Reference ``Device._get_property_value`` (``energy_model.py:65-84``).

    ``value`` may be None/NaN (use default), a scalar, or a ``(lo, hi)``
    tuple/list sampled with the device's seeded RandomState.
    """
    is_missing = value is None or (
        isinstance(value, float) and math.isnan(value))
    target = default if is_missing else value
    if isinstance(target, (tuple, list)):
        if seed is None:
            raise ValueError("tuple-valued parameter requires a device seed")
        return sample_uniform(seed, float(target[0]), float(target[1]))
    return float(target)


def default_power_efficiency_curve(efficiency: float, seed: int) -> List[List[float]]:
    """Randomized default curve (reference ``energy_model.py:977-990``).

    Every ``numpy_random_state.uniform(a, b)`` call in the reference uses a
    fresh RandomState with the same seed, so each point is the first draw
    of ``RandomState(seed).uniform(a, b)``.
    """
    u = lambda a, b: sample_uniform(seed, a, b)
    return [
        [0.0, u(efficiency * 0.85, efficiency * 0.90)],
        [u(0.25, 0.35), u(efficiency * 0.90, efficiency * 0.95)],
        [u(0.65, 0.75), u(efficiency * 0.98, efficiency * 1.0)],
        [u(0.75, 0.85), efficiency],
        [1.0, u(efficiency * 0.95, efficiency * 0.98)],
    ]


def default_capacity_power_curve(seed: int) -> List[List[float]]:
    """Randomized default curve (reference ``energy_model.py:992-1003``)."""
    u = lambda a, b: sample_uniform(seed, a, b)
    return [
        [0.0, u(0.95, 1.0)],
        [u(0.75, 0.85), u(0.90, 0.95)],
        [1.0, u(0.20, 0.30)],
    ]


def pad_curve(curve: Sequence[Sequence[float]], length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a piecewise-linear ``[[x, y], ...]`` curve to ``length`` points.

    Padding repeats the final point *exactly*. The reference's lookup is
    ``idx = max(0, argmax(q <= x) - 1)`` (``energy_model.py:1083,1103``):
    with exact-duplicate padding the first match stays at the same original
    index, a query beyond every knot still yields all-False -> idx 0 (the
    reference's quirky fall-back to the first segment), and ``idx + 1``
    never lands in the padded tail, so interpolation divisions are safe.
    """
    arr = np.asarray(curve, dtype=np.float64)
    assert arr.ndim == 2 and arr.shape[1] == 2, f"bad curve shape {arr.shape}"
    n = arr.shape[0]
    assert 2 <= n <= length, f"curve with {n} points vs pad length {length}"
    if n < length:
        pad = np.repeat(arr[-1:, :], length - n, axis=0)
        arr = np.concatenate([arr, pad], axis=0)
    # keep float64: the reference holds curves as Python-float lists; the
    # packer downcasts to float32 for the fast path (core/params.py pack
    # ``param_dtype``), while parity mode needs the exact schema values
    return arr[:, 0], arr[:, 1]
