"""Pack a compiled :class:`DistrictSpec` into tensors + static config.

Data layout is time-major ``(T, B)`` so each step gathers one contiguous
``(B,)`` row per field (replaces the reference's per-step
``TimeSeriesData.__getattr__`` slicing, ``data.py:313``). The packed
leaves equal those of the JAX package's ``pack`` for the battery+PV and
thermal-storage districts (its float64-parity provenance flags are not
carried).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, get_type_hints

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.compiler.spaces import heat_pump_cop_np
from citylearn_tpu_torch.compiler.spec import BuildingSpec, DistrictSpec
from citylearn_tpu_torch.core.types import (
    BatteryParams,
    DistrictParams,
    EnvState,
    HVACParams,
    SeriesData,
    StaticConfig,
    StorageTankParams,
)


# Observation names whose returned-at-t value is state-derived and therefore
# *zero* at any index the step has not written yet (the reference returns
# observations at t+1 before anything is written there)
DERIVED_ZERO_OBSERVATIONS = frozenset({
    "cooling_storage_soc", "heating_storage_soc", "dhw_storage_soc",
    "electrical_storage_soc", "net_electricity_consumption",
    "cooling_electricity_consumption", "heating_electricity_consumption",
    "dhw_electricity_consumption", "cooling_storage_electricity_consumption",
    "heating_storage_electricity_consumption",
    "dhw_storage_electricity_consumption",
    "electrical_storage_electricity_consumption",
    "washing_machine_electricity_consumption",
})


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Static observation metadata: the union column order and each
    building's active subset (as indices into the union)."""
    union_names: Tuple[str, ...]
    building_indices: Tuple[Tuple[int, ...], ...]   # per building

    def column(self, name: str) -> int:
        return self.union_names.index(name)


def build_obs_layout(spec: DistrictSpec) -> ObsLayout:
    union: List[str] = []
    for b in spec.buildings:
        for k in b.active_observations:
            if k not in union:
                union.append(k)
    indices = tuple(tuple(union.index(k) for k in b.active_observations)
                    for b in spec.buildings)
    return ObsLayout(union_names=tuple(union), building_indices=indices)


def _stack(spec: DistrictSpec, key: str, dtype=np.float32) -> np.ndarray:
    """(T, B) stack of one series over the simulation range."""
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)
    cols = [b.series[key][sl] for b in spec.buildings]
    return np.stack(cols, axis=1).astype(dtype)


def _obs_series(b: BuildingSpec, name: str, sl: slice) -> np.ndarray:
    """Data-driven value of observation ``name`` for one building over the
    simulation range (reference ``building.py:1336-1481`` data paths)."""
    s = b.series
    n = len(s["hour"][sl])
    if name in DERIVED_ZERO_OBSERVATIONS:
        return np.zeros(n, np.float32)
    if name == "power_outage":
        # the compiler refuses stochastic outage signals
        if b.simulate_power_outage:
            return s["power_outage"][sl]
        return np.zeros(n, np.float32)
    if name == "solar_generation":
        return np.abs(b.pv_nominal_power * s["solar_generation"][sl] / 1000.0)
    if name == "cooling_device_efficiency":
        return heat_pump_cop_np(s["outdoor_dry_bulb_temperature"][sl],
                                b.cooling_device.efficiency,
                                b.cooling_device.target_cooling_temperature, False)
    if name in ("heating_device_efficiency", "dhw_device_efficiency"):
        device = b.heating_device if name == "heating_device_efficiency" else b.dhw_device
        if device.is_heat_pump:
            return heat_pump_cop_np(s["outdoor_dry_bulb_temperature"][sl],
                                    device.efficiency,
                                    device.target_heating_temperature, True)
        return np.full(n, device.efficiency, np.float32)
    if name == "indoor_dry_bulb_temperature_cooling_delta":
        return (s["indoor_dry_bulb_temperature"][sl]
                - s["indoor_dry_bulb_temperature_cooling_set_point"][sl])
    if name == "indoor_dry_bulb_temperature_heating_delta":
        return (s["indoor_dry_bulb_temperature"][sl]
                - s["indoor_dry_bulb_temperature_heating_set_point"][sl])
    if name in s:
        return s[name][sl]
    return np.zeros(n, np.float32)


def _obs_static(spec: DistrictSpec, layout: ObsLayout) -> np.ndarray:
    """(T, B, K_union) data-driven observation matrix. Charger and
    washing-machine columns (the JAX package's ``_ev_obs_columns``) need
    blocks the port does not carry yet."""
    if any(b.chargers or b.washing_machines for b in spec.buildings):
        raise NotImplementedError("observation columns of chargers and washing "
                                  "machines are not ported yet")
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)
    obs = np.zeros((spec.simulation_time_steps, spec.n_buildings,
                    len(layout.union_names)), np.float32)
    for bi, b in enumerate(spec.buildings):
        for ki, name in enumerate(layout.union_names):
            if name in b.active_observations:
                obs[:, bi, ki] = _obs_series(b, name, sl)
    return obs


def _episode_steps(spec: DistrictSpec) -> int:
    steps = spec.episode_time_steps
    if steps is None:
        return spec.simulation_time_steps
    if isinstance(steps, list):
        return int(steps[0][1] - steps[0][0] + 1)
    return int(steps)


def _reward_config(spec: DistrictSpec) -> Dict:
    """StaticConfig reward fields from the schema's ``reward_function``."""
    reward_block = spec.schema.get("reward_function") or {}
    raw_type = reward_block.get("type")
    raw_attrs = reward_block.get("attributes") or {}
    reward_per_building = None
    if isinstance(raw_type, dict):
        # MultiBuildingRewardFunction (reference citylearn.py:2108-2141):
        # per-building dotted paths with 'default' fallback (else the first
        # entry); attributes dict follows the same fallback
        default_type = raw_type.get("default")
        if default_type is None and raw_type:
            default_type = next(iter(raw_type.values()))
        default_attrs = raw_attrs.get("default")
        if default_attrs is None and raw_attrs:
            default_attrs = next(iter(raw_attrs.values()))
        per = []
        for b in spec.buildings:
            t = raw_type.get(b.name, default_type)
            if t is None:
                raise ValueError(f"no reward function for building {b.name!r} "
                                 "and no default provided")
            a = raw_attrs.get(b.name, default_attrs) or {}
            per.append((t.rsplit(".", 1)[-1],
                        float(a.get("exponent") or 1.0),
                        None if a.get("band") is None else float(a["band"]),
                        float(a.get("lower_exponent") or 2.0),
                        float(a.get("higher_exponent") or 2.0),
                        tuple(a.get("coefficients") or (1.0, 1.0))))
        reward_per_building = tuple(per)
        reward_type = "MultiBuildingRewardFunction"
        reward_attrs = {}
    else:
        reward_type = (raw_type or
                       "citylearn.reward_function.RewardFunction").rsplit(".", 1)[-1]
        reward_attrs = raw_attrs
    return dict(
        reward_type=reward_type,
        reward_exponent=float(reward_attrs.get("exponent") or 1.0),
        reward_band=(None if reward_attrs.get("band") is None
                     else float(reward_attrs["band"])),
        reward_lower_exponent=float(reward_attrs.get("lower_exponent") or 2.0),
        reward_higher_exponent=float(reward_attrs.get("higher_exponent") or 2.0),
        reward_coefficients=tuple(reward_attrs.get("coefficients") or (1.0, 1.0)),
        reward_per_building=reward_per_building,
    )


def pack(spec: DistrictSpec, device=None
         ) -> Tuple[StaticConfig, DistrictParams, ObsLayout]:
    """``(cfg, params, layout)`` of a compiled district, with every
    parameter tensor on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)

    solar = np.stack(
        [b.pv_nominal_power * b.series["solar_generation"][sl] / 1000.0
         for b in spec.buildings], axis=1).astype(np.float32)
    outage = np.stack([b.series["power_outage"][sl] if b.simulate_power_outage
                       else np.zeros_like(b.series["power_outage"][sl])
                       for b in spec.buildings], axis=1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)

    series = SeriesData(
        non_shiftable_load=t(_stack(spec, "non_shiftable_load")),
        cooling_demand=t(_stack(spec, "cooling_demand")),
        heating_demand=t(_stack(spec, "heating_demand")),
        dhw_demand=t(_stack(spec, "dhw_demand")),
        solar_generation=t(solar),
        outdoor_dry_bulb_temperature=t(_stack(spec, "outdoor_dry_bulb_temperature")),
        electricity_pricing=t(_stack(spec, "electricity_pricing")),
        carbon_intensity=t(_stack(spec, "carbon_intensity")),
        power_outage=t(outage),
        hvac_mode=t(_stack(spec, "hvac_mode", np.int32)),
        hour=t(_stack(spec, "hour", np.int32)),
        indoor_dry_bulb_temperature=t(_stack(spec, "indoor_dry_bulb_temperature")),
        indoor_dry_bulb_temperature_cooling_set_point=t(
            _stack(spec, "indoor_dry_bulb_temperature_cooling_set_point")),
        indoor_dry_bulb_temperature_heating_set_point=t(
            _stack(spec, "indoor_dry_bulb_temperature_heating_set_point")),
        comfort_band=t(_stack(spec, "comfort_band")),
        occupant_count=t(_stack(spec, "occupant_count")),
    )

    def block(cls, attr):
        """Stack one device's resolved attributes over the buildings."""
        vals = {f.name: np.asarray([getattr(getattr(b, attr), f.name) for b in spec.buildings])
                for f in dataclasses.fields(cls)}
        return cls(**{k: t(v if v.dtype == bool else v.astype(np.float32))
                      for k, v in vals.items()})


    cfg = StaticConfig(
        n_buildings=spec.n_buildings,
        time_steps=_episode_steps(spec),
        central_agent=spec.central_agent,
        seconds_per_time_step=spec.seconds_per_time_step,
        time_step_ratio=spec.time_step_ratio,
        simulate_power_outage=tuple(b.simulate_power_outage for b in spec.buildings),
        any_cooling=any(float(b.series["cooling_demand"][sl].max()) > 0
                        or b.cooling_storage.capacity > 0 for b in spec.buildings),
        any_heating=any(float(b.series["heating_demand"][sl].max()) > 0
                        or b.heating_storage.capacity > 0 for b in spec.buildings),
        any_dhw=any(float(b.series["dhw_demand"][sl].max()) > 0
                    or b.dhw_storage.capacity > 0 for b in spec.buildings),
        **_reward_config(spec),
    )
    layout = build_obs_layout(spec)
    params = DistrictParams(
        series=series, battery=block(BatteryParams, "battery"),
        **{name: block(HVACParams, name)
           for name in ("cooling_device", "heating_device", "dhw_device")},
        **{name: block(StorageTankParams, name)
           for name in ("cooling_storage", "heating_storage", "dhw_storage")},
        obs_static=t(_obs_static(spec, layout)))
    return cfg, params, layout


def params_from_numpy(tree: Dict[str, np.ndarray], device=None) -> DistrictParams:
    """:class:`DistrictParams` from a flat ``{"series.hour": array, ...}``
    dict keyed by field path — the JAX package's packed parameters
    carried across as numpy arrays. Keys the port does not read (the
    float64-parity provenance flags) are ignored; a missing key raises
    ``KeyError``."""
    dev = resolve_device(device)

    def build(cls, prefix=""):
        return cls(**{
            name: (build(kind, f"{prefix}{name}.") if dataclasses.is_dataclass(kind)
                   else torch.tensor(np.asarray(tree[f"{prefix}{name}"]), device=dev))
            for name, kind in get_type_hints(cls).items()})

    return build(DistrictParams)


def initial_state(cfg: StaticConfig, params: DistrictParams,
                  data_offset: int = 0) -> EnvState:
    """Episode-start state of one district (reference ``Building.reset``
    semantics: SOC index 0 = initial_soc, efficiency history truncated to
    its base, capacity history truncated to nominal capacity —
    ``building.py:2526-2564``, ``energy_model.py:797-803,1237-1242``)."""
    dev = params.device
    return EnvState(
        t=torch.tensor(0, dtype=torch.int32, device=dev),
        data_offset=torch.tensor(data_offset, dtype=torch.int32, device=dev),
        battery_soc=params.battery.initial_soc.clone(),
        battery_efficiency=params.battery.efficiency.clone(),
        battery_degraded_capacity=params.battery.capacity.clone(),
        cooling_storage_soc=params.cooling_storage.initial_soc.clone(),
        heating_storage_soc=params.heating_storage.initial_soc.clone(),
        dhw_storage_soc=params.dhw_storage.initial_soc.clone(),
    )
