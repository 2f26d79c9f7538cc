"""Rule-based controllers (reference ``citylearn/agents/rbc.py``).

The hour-indexed action maps are also exported as flat 24-entry tables
(:func:`action_table`) for the batched rollout path
(:func:`citylearn_tpu_torch.core.rollout.hour_rbc_policy`), and an agent's
resolved maps become a whole-episode plan through
:meth:`citylearn_tpu_torch.core.evaluate_fast.ScriptedPolicy.from_hour_rbc`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from citylearn_tpu_torch.agents.base import Agent

HOURS = range(1, 25)


def _storage_basic(hour):   # rbc.py:169-178
    return -0.08 if 9 <= hour <= 21 else 0.091


def _map_from(fn) -> Mapping[int, float]:
    return {h: fn(h) for h in HOURS}


def _coh_map(hour):         # rbc.py:202-213
    if hour < 7:
        return 0.4
    if hour < 21:
        return -0.4
    return 0.8


BASIC_MAPS = {
    "storage": _map_from(_storage_basic),
    "cooling_device": _map_from(lambda h: 0.8 if 9 <= h <= 21 else 0.4),
    "heating_device": _map_from(lambda h: 0.4 if 9 <= h <= 21 else 0.8),
    "cooling_or_heating_device": _map_from(_coh_map),
}


def _storage_optimized(hour):  # rbc.py:260-275
    if 7 <= hour <= 15:
        return -0.02
    if 16 <= hour <= 18:
        return -0.044
    if 19 <= hour <= 22:
        return -0.024
    if 23 <= hour <= 24:
        return 0.034
    return 0.05532


OPTIMIZED_MAPS = {
    "storage": _map_from(_storage_optimized),
    "cooling_device": _map_from(
        lambda h: 0.7 if 7 <= h <= 15 else 0.6 if 16 <= h <= 18
        else 0.8 if 19 <= h <= 22 else 0.4 if h >= 23 else 0.2),
    "heating_device": _map_from(
        lambda h: 0.3 if 7 <= h <= 15 else 0.4 if 16 <= h <= 18
        else 0.6 if 19 <= h <= 22 else 0.7 if h >= 23 else 0.8),
    "cooling_or_heating_device": _map_from(_coh_map),
}

BATTERY_MAPS = {
    "storage": _map_from(lambda h: 0.11 if 6 <= h <= 14 else -0.067),
    "cooling_device": _map_from(lambda h: 0.7 if 6 <= h <= 14 else 0.3),
    "heating_device": _map_from(lambda h: 0.3 if 6 <= h <= 14 else 0.7),
    "cooling_or_heating_device": _map_from(_coh_map),
}


def _ev_map(hour):          # rbc.py:483-500
    if hour < 7:
        return 0.4
    if hour < 10:
        return 1.0
    if hour < 15:
        return -1.0
    if hour < 20:
        return -0.6
    return 0.8


class RBC(Agent):
    pass


class HourRBC(RBC):
    """Hour-of-use controller (reference ``rbc.py:24-137``): resolves the
    hour observation (tolerating 0-23 and 1-24 encodings) into per-action
    map lookups."""

    def __init__(self, env, action_map=None, **kwargs: Any):
        super().__init__(env, **kwargs)
        self.action_map = self._normalize_map(action_map)

    def _default_maps(self) -> Mapping[str, Mapping[int, float]]:
        return None

    def _normalize_map(self, action_map):
        if action_map is None:
            defaults = self._default_maps()
            if defaults is None:
                return None
            all_names = sorted({a for names in self.action_names for a in names})
            flat = {}
            for n in all_names:
                flat[n] = self._map_for_action(n, defaults)
            action_map = flat
        if isinstance(action_map, list):
            return action_map
        if isinstance(action_map, dict):
            first = next(iter(action_map.values()))
            if isinstance(first, dict):
                return [{n: action_map[n] for n in set(names)}
                        for names in self.action_names]
            return [{n: action_map for n in set(names)}
                    for names in self.action_names]
        raise ValueError("invalid action_map")

    def _map_for_action(self, name, defaults):
        if "storage" in name:
            return defaults["storage"]
        if name in defaults:
            return defaults[name]
        raise ValueError(f"Unknown action name: {name}")

    def predict(self, observations, deterministic: bool = None):
        if self.action_map is None:
            return super().predict(observations, deterministic=deterministic)
        actions = []
        for m, names, obs_names, o in zip(self.action_map, self.action_names,
                                          self.observation_names, observations):
            hour = int(round(o[obs_names.index("hour")]))
            candidates = []
            for c in (hour, hour % 24, ((hour - 1) % 24) + 1):
                if c not in candidates:
                    candidates.append(c)
            row = []
            for a in names:
                for c in candidates:
                    if c in m[a]:
                        row.append(m[a][c])
                        break
                else:
                    raise KeyError(f"hour {hour} not in action map for {a}")
            actions.append(row)
        return actions


class BasicRBC(HourRBC):
    """Charge storage at night / discharge by day (reference ``rbc.py:137-218``)."""

    def _default_maps(self):
        return BASIC_MAPS


class OptimizedRBC(BasicRBC):
    """Grid-search-optimized maps (reference ``rbc.py:220-327``)."""

    def _default_maps(self):
        return OPTIMIZED_MAPS


class BasicBatteryRBC(BasicRBC):
    """Solar-aligned battery maps (reference ``rbc.py:329-405``)."""

    def _default_maps(self):
        return BATTERY_MAPS


class BasicElectricVehicleRBC_ReferenceController(BasicRBC):
    """EV reference controller (reference ``rbc.py:407-515``)."""

    def _map_for_action(self, name, defaults):
        if name == "electrical_storage":
            return BASIC_MAPS["storage"]
        if "electric_vehicle" in name:
            return _map_from(_ev_map)
        if "dhw_storage" in name or "washing_machine" in name:
            return _map_from(lambda h: 1.0)
        return super()._map_for_action(name, defaults)

    def _default_maps(self):
        return BASIC_MAPS


def action_table(maps: Mapping[str, Mapping[int, float]], action: str):
    """(24,) numpy table for the batched RBC policy."""
    m = maps["storage"] if "storage" in action else maps[action]
    return np.asarray([m[h] for h in HOURS], np.float32)
