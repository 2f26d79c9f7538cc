"""Stochastic power outage signal models (reference
``citylearn/power_outage.py``) — numpy-exact RandomState replication,
evaluated host-side at episode reset and baked into the device tensors.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def random_outage_signals(time_steps: int, random_seed: int) -> np.ndarray:
    """Base model: uniform 0/1 per step (``power_outage.py:27-53``)."""
    return np.random.RandomState(random_seed).choice([0, 1], size=time_steps)


def reliability_metrics_outage_signals(
        time_steps: int, seconds_per_time_step: float, random_seed: int,
        saifi: float = None, caidi: float = None,
        start_time_steps: Optional[List[int]] = None) -> np.ndarray:
    """SAIFI/CAIDI model (``power_outage.py:120-170``): binomial outage
    days, uniform start step, exponential duration in minutes."""
    saifi = 1.436 if saifi is None else saifi
    caidi = 331.2 if caidi is None else caidi
    nprs = np.random.RandomState(random_seed)
    time_steps_per_day = 86400.0 / seconds_per_time_step
    time_steps_per_minute = 60.0 / seconds_per_time_step
    day_count = time_steps / time_steps_per_day
    p = saifi / 365.0
    outage_days = nprs.binomial(n=1, p=p, size=int(day_count))
    outage_day_ixs = outage_days * np.arange(day_count)
    outage_day_ixs = outage_day_ixs[outage_day_ixs != 0]
    n_days = int((outage_days == 1).sum())
    candidates = (list(range(int(time_steps_per_day)))
                  if start_time_steps is None else start_time_steps)
    starts = nprs.choice(candidates, size=n_days)
    durations = nprs.exponential(scale=caidi, size=n_days) * time_steps_per_minute
    signals = np.zeros(time_steps, dtype=int)
    for i, j, k in zip(outage_day_ixs, starts, durations):
        s = int(i * time_steps_per_day + j)
        e = int(i * time_steps_per_day + j + k)
        signals[s:e] = 1
    return signals


def building_outage_signal(b, episode_time_steps: int,
                           seconds_per_time_step: float,
                           episode_slice: slice) -> np.ndarray:
    """Per-episode outage signal for one building spec
    (reference ``Building.reset_power_outage_signal``,
    ``building.py:2566-2594``). Episode-relative indexing."""
    if not b.simulate_power_outage:
        return np.zeros(episode_time_steps, np.float32)
    if b.stochastic_power_outage:
        model = b.stochastic_power_outage_model or {}
        attrs = model.get("attributes") or {}
        mtype = (model.get("type") or "").rsplit(".", 1)[-1]
        seed = attrs.get("random_seed")
        if seed is None:
            # reference falls back to the *global* numpy RNG (power_outage.py:21)
            # — inherently non-reproducible; we use a fixed documented seed.
            seed = 0
        if mtype == "ReliabilityMetricsPowerOutage" or mtype == "":
            return reliability_metrics_outage_signals(
                episode_time_steps, seconds_per_time_step, int(seed),
                attrs.get("saifi"), attrs.get("caidi"),
                attrs.get("start_time_steps")).astype(np.float32)
        if mtype == "PowerOutage":
            return random_outage_signals(episode_time_steps, int(seed)).astype(np.float32)
        raise NotImplementedError(f"outage model {mtype}")
    return b.series["power_outage"][episode_slice].astype(np.float32)
