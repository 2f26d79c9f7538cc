"""Offline EV event resolution.

The reference's charger<->EV state machine
(``citylearn.py:1353-1475``: ``associate_chargers_to_electric_vehicles`` +
``simulate_unconnected_ev_soc``) is driven purely by the charger schedule
CSVs, so the per-step SOC events — forced arrival SOCs and unconnected
drift — resolve to data tensors at compile time. The district step then
applies them with no control flow. This is the port's own copy of the JAX
package's ``compiler/events.py`` (numpy only), kept equal to it.

Drift note: the reference draws the drift multiplier from the *global*
numpy RNG (``citylearn.py:1473``) making it inherently non-reproducible;
we use a seeded stream whose draw order matches the reference exactly
(one ``normal(1.0, 0.2)`` per undocked EV per step, EV-list order), so
seeding ``np.random`` in a reference run reproduces our trace bit-for-bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _resolve_arrival_soc(ch, step: int, prev_state: float, prev_ev: int,
                         ev_index: int) -> float:
    """Reference ``citylearn.py:1356-1376``. Returns NaN when unavailable."""
    candidate = step
    if prev_state == 2 and step > 0 and prev_ev == ev_index:
        candidate = step - 1
    soc = np.nan
    if 0 <= candidate < len(ch.estimated_soc_arrival):
        soc = ch.estimated_soc_arrival[candidate]
    if np.isfinite(soc) and 0.0 <= soc <= 1.0:
        return float(soc)
    fb = min(step, len(ch.current_soc) - 1)
    if fb >= 0:
        fbs = ch.current_soc[fb]
        if np.isfinite(fbs) and 0.0 <= fbs <= 1.0:
            return float(fbs)
    return np.nan


def resolve_ev_events(buildings, n_evs: int, episode_time_steps: int,
                      drift_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compute ``(force_soc, drift_mult)`` tensors, both ``(T_ep, n_evs)``
    with NaN where no event applies.

    Ordering reproduced per step t: ``simulate_unconnected_ev_soc``
    (pre-arrival forcing + drift) runs before
    ``associate_chargers_to_electric_vehicles`` (connection-time forcing),
    so association events override pre-arrival ones.
    """
    T = episode_time_steps
    force = np.full((T, n_evs), np.nan, np.float32)
    drift = np.full((T, n_evs), np.nan, np.float32)
    rng = np.random.RandomState(drift_seed)
    chargers = [ch for b in buildings for ch in b.chargers]

    for t in range(T):
        # --- simulate_unconnected_ev_soc at time_step t (called from
        # next_time_step after advancing; at t == 0 only associate runs) ---
        if t > 0 and t + 1 < T:
            for v in range(n_evs):
                found = False
                for ch in chargers:
                    curr_conn = t < len(ch.connected_ev) and ch.connected_ev[t] == v
                    curr_state = ch.state[t] if t < len(ch.state) else np.nan
                    next_state = ch.state[t + 1] if t + 1 < len(ch.state) else np.nan
                    next_conn = (t + 1 < len(ch.connected_ev)
                                 and ch.connected_ev[t + 1] == v and next_state == 1)
                    if curr_conn and curr_state == 1:
                        found = True
                        break
                    is_connecting = next_conn and curr_state != 1
                    is_incoming = (t < len(ch.incoming_ev)
                                   and ch.incoming_ev[t] == v and curr_state == 2)
                    if is_connecting:
                        found = True
                        ix = t if is_incoming else t + 1
                        soc = (ch.estimated_soc_arrival[ix]
                               if ix < len(ch.estimated_soc_arrival) else np.nan)
                        if 0 <= soc <= 1:
                            force[t, v] = soc
                        break
                if not found:
                    # one global-RNG draw per undocked EV (citylearn.py:1473)
                    drift[t, v] = np.clip(rng.normal(1.0, 0.2), 0.6, 1.4)

        # --- associate_chargers_to_electric_vehicles at t ---
        for ch in chargers:
            state = ch.state[t] if t < len(ch.state) else np.nan
            if not (state == 1):
                continue
            v = ch.connected_ev[t] if t < len(ch.connected_ev) else -1
            if v < 0:
                continue
            prev_state = ch.state[t - 1] if t > 0 else np.nan
            prev_ev = -2
            if t > 0:
                if prev_state == 1:
                    prev_ev = ch.connected_ev[t - 1]
                elif prev_state == 2:
                    prev_ev = ch.incoming_ev[t - 1]
            is_new = (prev_state != 1) or (prev_ev != v)
            if is_new:
                soc = _resolve_arrival_soc(ch, t, prev_state, prev_ev, v)
                if np.isfinite(soc):
                    force[t, v] = soc
                    drift[t, v] = np.nan
    return force, drift
