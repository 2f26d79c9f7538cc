"""Observation/action space estimation (host-side numpy).

Mirrors ``Building.estimate_observation_space_limits`` /
``estimate_action_space`` (reference ``citylearn/building.py:1867-2282``)
over the *simulation* (not episode) range, including the
``observation_space_limit_delta`` buffer and default constants
(``building.py:1010-1022``: delta 0.0, max temperature delta 20.0,
demand factor 1.15).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from citylearn_tpu_torch.compiler import spec as spec_mod

OBSERVATION_SPACE_LIMIT_DELTA = 0.0
MAXIMUM_TEMPERATURE_DELTA = 20.0
DEMAND_OBSERVATION_LIMIT_FACTOR = 1.15
ZERO = spec_mod.ZERO_DIVISION_PLACEHOLDER


def heat_pump_cop_np(outdoor_dry_bulb_temperature: np.ndarray, efficiency: float,
                     target_temperature: float, heating: bool) -> np.ndarray:
    """Carnot-bounded COP, clamped to (0, 20] (reference ``energy_model.py:216-250``)."""
    t = np.asarray(outdoor_dry_bulb_temperature, dtype=np.float64)
    if heating:
        with np.errstate(divide="ignore", invalid="ignore"):
            cop = efficiency * (target_temperature + 273.15) / (target_temperature - t)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            cop = efficiency * (target_temperature + 273.15) / (t - target_temperature)
    cop = np.asarray(cop)
    cop[cop < 0] = 20
    cop[cop > 20] = 20
    cop[~np.isfinite(cop)] = 20
    return cop


def _hvac_input_power_np(device: "spec_mod.HVACDeviceSpec", output: np.ndarray,
                         outdoor_t: np.ndarray, heating: bool) -> np.ndarray:
    if device.is_heat_pump:
        target = device.target_heating_temperature if heating else device.target_cooling_temperature
        cop = heat_pump_cop_np(outdoor_t, device.efficiency, target, heating)
        return np.asarray(output) / cop
    return np.asarray(output) / device.efficiency


def _limits_data(b: "spec_mod.BuildingSpec", start: int, end: int) -> Dict[str, np.ndarray]:
    sl = slice(start, end + 1)
    data = {k: v[sl] for k, v in b.series.items()}
    # controlled-variable frozen copies (reference data.py:469-476)
    for k in ["indoor_dry_bulb_temperature", "cooling_demand", "heating_demand",
              "dhw_demand", "non_shiftable_load", "indoor_relative_humidity",
              "indoor_dry_bulb_temperature_cooling_set_point",
              "indoor_dry_bulb_temperature_heating_set_point"]:
        data[f"{k}_without_control"] = data[k]
    data["solar_generation"] = b.pv_nominal_power * b.series["solar_generation"][sl] / 1000.0
    return data


def estimate_observation_space_limits(
        b: "spec_mod.BuildingSpec", start: int, end: int,
        observation_names: List[str] = None,
) -> Tuple[Dict[str, float], Dict[str, float]]:
    data = _limits_data(b, start, end)
    names = b.active_observations if observation_names is None else observation_names
    low: Dict[str, float] = {}
    high: Dict[str, float] = {}
    outdoor_t = data["outdoor_dry_bulb_temperature"]

    total_charger_kw = sum(ch.max_charging_power or 0.0 for ch in b.chargers)
    for key in names:
        if key.startswith("charging_phase_one_hot_"):
            low[key], high[key] = 0.0, 1.0
        elif key == "charging_constraint_violation_kwh":
            low[key] = 0.0
            high[key] = total_charger_kw  # x seconds/3600, applied by caller ratio 1
        elif key == "charging_building_headroom_kw":
            cc = b.charging_constraints or {}
            v = float(cc.get("building_limit_kw") or 0.0)
            low[key], high[key] = v, v
        elif key.startswith("charging_phase_") and key.endswith("_headroom_kw"):
            pn = key[len("charging_phase_"):-len("_headroom_kw")]
            v = 0.0
            for phase in ((b.charging_constraints or {}).get("phases") or []):
                if phase.get("name") == pn and phase.get("limit_kw") is not None:
                    v = float(phase["limit_kw"])
            low[key], high[key] = v, v
        elif key == "net_electricity_consumption":
            lows = data["non_shiftable_load"] - (
                b.battery.nominal_power + data["solar_generation"])
            highs = (data["non_shiftable_load"] + b.cooling_device.nominal_power
                     + b.heating_device.nominal_power + b.dhw_device.nominal_power
                     + b.battery.nominal_power - data["solar_generation"])
            low[key] = min(float(lows.min()), 0.0)
            high[key] = float(highs.max())
        elif key == "net_electricity_consumption_without_storage":
            low[key] = min(low["net_electricity_consumption"] + b.battery.nominal_power, 0.0)
            high[key] = high["net_electricity_consumption"] - b.battery.nominal_power
        elif key == "net_electricity_consumption_without_storage_and_partial_load":
            low[key] = low["net_electricity_consumption_without_storage"]
            high[key] = high["net_electricity_consumption_without_storage"]
        elif key == "net_electricity_consumption_without_storage_and_partial_load_and_pv":
            low[key] = 0.0
            highs = (data["non_shiftable_load"] + b.cooling_device.nominal_power
                     + b.heating_device.nominal_power + b.dhw_device.nominal_power)
            high[key] = float(highs.max())
        elif key in ("cooling_storage_soc", "heating_storage_soc", "dhw_storage_soc",
                     "electrical_storage_soc"):
            low[key], high[key] = 0.0, 1.0
        elif key == "cooling_device_efficiency":
            cop = heat_pump_cop_np(outdoor_t, b.cooling_device.efficiency,
                                   b.cooling_device.target_cooling_temperature, False)
            low[key], high[key] = float(cop.min()), float(cop.max())
        elif key == "heating_device_efficiency":
            if b.heating_device.is_heat_pump:
                cop = heat_pump_cop_np(outdoor_t, b.heating_device.efficiency,
                                       b.heating_device.target_heating_temperature, True)
                low[key], high[key] = float(cop.min()), float(cop.max())
            else:
                low[key] = high[key] = b.heating_device.efficiency
        elif key == "dhw_device_efficiency":
            if b.dhw_device.is_heat_pump:
                cop = heat_pump_cop_np(outdoor_t, b.dhw_device.efficiency,
                                       b.dhw_device.target_heating_temperature, True)
                low[key], high[key] = float(cop.min()), float(cop.max())
            else:
                low[key] = high[key] = b.dhw_device.efficiency
        elif key == "indoor_dry_bulb_temperature":
            low[key] = float(data[key].min()) - MAXIMUM_TEMPERATURE_DELTA
            high[key] = float(data[key].max()) + MAXIMUM_TEMPERATURE_DELTA
        elif key in ("indoor_dry_bulb_temperature_cooling_delta",
                     "indoor_dry_bulb_temperature_heating_delta"):
            low[key] = -MAXIMUM_TEMPERATURE_DELTA
            high[key] = MAXIMUM_TEMPERATURE_DELTA
        elif key == "comfort_band":
            low[key] = 0.0
            high[key] = float(data[key].max())
        elif key in ("cooling_demand", "heating_demand", "dhw_demand"):
            low[key] = 0.0
            high[key] = float(data[key].max()) * DEMAND_OBSERVATION_LIMIT_FACTOR
        elif key == "cooling_electricity_consumption":
            low[key], high[key] = 0.0, b.cooling_device.nominal_power
        elif key == "heating_electricity_consumption":
            low[key], high[key] = 0.0, b.heating_device.nominal_power
        elif key == "dhw_electricity_consumption":
            low[key], high[key] = 0.0, b.dhw_device.nominal_power
        elif key == "cooling_storage_electricity_consumption":
            cons = _hvac_input_power_np(b.cooling_device, data["cooling_demand"], outdoor_t, False)
            low[key] = -float(cons.max())
            high[key] = b.cooling_device.nominal_power
        elif key == "heating_storage_electricity_consumption":
            cons = _hvac_input_power_np(b.heating_device, data["heating_demand"], outdoor_t, True)
            low[key] = -float(cons.max())
            high[key] = b.heating_device.nominal_power
        elif key == "dhw_storage_electricity_consumption":
            cons = _hvac_input_power_np(b.dhw_device, data["dhw_demand"], outdoor_t, True)
            low[key] = -float(cons.max())
            high[key] = b.dhw_device.nominal_power
        elif key == "electrical_storage_electricity_consumption":
            low[key] = -b.battery.nominal_power
            high[key] = b.battery.nominal_power
        elif key == "power_outage":
            low[key], high[key] = 0.0, 1.0
        # EV charger / washing machine expansions (building.py:1968-2010)
        elif "connected_state" in key or "_incoming_state" in key:
            low[key], high[key] = 0.0, 1.0
        elif "_departure_time" in key or "_estimated_arrival_time" in key:
            low[key], high[key] = -1.0, 24.0
        elif "_soc" in key and "_electric_vehicle" in key:
            low[key], high[key] = -0.1, 1.0
        elif "charger" in key:
            for ch in b.chargers:
                if key == f"connected_electric_vehicle_at_charger_{ch.charger_id}_battery_capacity":
                    low[key], high[key] = -1.0, 100.0
        elif "washing_machine" in key:
            for wm in b.washing_machines:
                if key in (f"{wm.name}_start_time_step", f"{wm.name}_end_time_step"):
                    low[key], high[key] = -1.0, 24.0
        else:
            low[key] = float(np.min(data[key]))
            high[key] = float(np.max(data[key]))

    low = {k: v - OBSERVATION_SPACE_LIMIT_DELTA for k, v in low.items()}
    high = {k: v + OBSERVATION_SPACE_LIMIT_DELTA for k, v in high.items()}
    return low, high


def estimate_action_space(b: "spec_mod.BuildingSpec", start: int, end: int
                          ) -> Tuple[List[float], List[float]]:
    """Reference ``Building.estimate_action_space`` (``building.py:2161-2282``)."""
    low: List[float] = []
    high: List[float] = []
    for key in b.active_actions:
        if key == "cooling_or_heating_device":
            low.append(-1.0 if b.cooling_device.nominal_power > ZERO else 0.0)
            high.append(1.0 if b.heating_device.nominal_power > ZERO else 0.0)
        elif key in ("cooling_device", "heating_device"):
            low.append(0.0)
            high.append(1.0)
        elif "electric_vehicle_storage" in key:
            for ch in b.chargers:
                if key == f"electric_vehicle_storage_{ch.charger_id}":
                    low.append(0.0 if ch.max_discharging_power == 0 else -1.0)
                    high.append(1.0)
        elif "washing_machine" in key:
            for wm in b.washing_machines:
                if key == wm.name:
                    low.append(0.0)
                    high.append(1.0)
        elif "storage" in key:
            if key == "electrical_storage":
                limit = 1.0
            else:
                if key == "cooling_storage":
                    capacity, power = b.cooling_storage.capacity, b.cooling_device.nominal_power
                elif key == "heating_storage":
                    capacity, power = b.heating_storage.capacity, b.heating_device.nominal_power
                elif key == "dhw_storage":
                    capacity, power = b.dhw_storage.capacity, b.dhw_device.nominal_power
                else:
                    raise ValueError(f"unknown action {key}")
                limit = power / max(capacity, ZERO)
            limit = min(limit, 1.0)
            low.append(-limit)
            high.append(limit)
        else:
            raise NotImplementedError(f"action space for {key} not yet supported")
    return low, high
