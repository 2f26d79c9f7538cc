"""Live building/device object views over the env's accumulated history.

The reference exposes mutable OOP objects (``citylearn.building.Building``
and its devices) whose per-episode series users read directly —
``env.buildings[0].net_electricity_consumption``,
``b.electrical_storage.soc`` and so on. In the port all of that state
lives in the step's struct-of-arrays history (:attr:`CityLearnEnv._history`,
filled from one host copy per step); these views re-expose it through the
reference's object surface.

Series length contract: every per-building series has length
``time_step + 1`` (reference ``tests/test_series_integrity.py:14-41``),
where the final row carries the reference's "unwritten current index"
semantics (zeros for consumption accumulators, raw-demand prefill for
``energy_from_*``; ``building.py:2554-2558``).

Reference: ``citylearn/citylearn.py:29-50`` (EvaluationCondition),
``citylearn/building.py`` (Building property surface),
``citylearn/energy_model.py`` (device property surface).
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, List

import numpy as np

from citylearn_tpu_torch.compiler.spaces import _hvac_input_power_np, heat_pump_cop_np
from citylearn_tpu_torch.spaces import box

if TYPE_CHECKING:  # pragma: no cover
    from citylearn_tpu_torch.envs.environment import CityLearnEnv


class EvaluationCondition(enum.Enum):
    """Baseline/control conditions for KPI normalization
    (reference ``citylearn.py:29-50``; member names preserved)."""

    WITH_STORAGE_AND_PV = ""
    WITHOUT_STORAGE_BUT_WITH_PV = "_without_storage"
    WITHOUT_STORAGE_AND_PV = "_without_storage_and_pv"

    # DynamicsBuilding conditions (value aliases are intentional,
    # mirroring the reference's aliased members)
    WITH_STORAGE_AND_PARTIAL_LOAD_AND_PV = ""
    WITHOUT_STORAGE_BUT_WITH_PARTIAL_LOAD_AND_PV = "_without_storage"
    WITHOUT_STORAGE_AND_PARTIAL_LOAD_BUT_WITH_PV = "_without_storage_and_partial_load"
    WITHOUT_STORAGE_AND_PARTIAL_LOAD_AND_PV = "_without_storage_and_partial_load_and_pv"


def _condition_value(condition) -> str:
    if condition is None:
        return None
    if isinstance(condition, EvaluationCondition):
        return condition.value
    return str(condition)


class _SpecDelegate:
    """Attribute fall-through to the resolved static spec dataclass."""

    def __init__(self, env: "CityLearnEnv", bi: int, spec):
        self._env = env
        self._bi = bi
        self._spec = spec

    def __getattr__(self, name):
        try:
            return getattr(self._spec, name)
        except AttributeError:
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}") from None

    def _hist(self, key: str) -> np.ndarray:
        env = self._env
        env._sync_unwritten_row()
        return env._history[key][: env.time_step + 1, self._bi].copy()


class StorageTankView(_SpecDelegate):
    """Thermal storage tank (reference ``energy_model.py:603-871``)."""

    def __init__(self, env, bi, spec, kind: str):
        super().__init__(env, bi, spec)
        self._kind = kind  # cooling|heating|dhw

    @property
    def soc(self) -> np.ndarray:
        return self._hist(f"{self._kind}_storage_soc")

    @property
    def energy_balance(self) -> np.ndarray:
        return self._hist(f"{self._kind}_storage_balance")

    @property
    def electricity_consumption(self) -> np.ndarray:
        """Device input power attributable to the tank's balance
        (reference ``building.py:1663-1783``)."""
        return self._hist(f"{self._kind}_storage_cons")


class BatteryView(_SpecDelegate):
    """Electrical storage (reference ``energy_model.py:872-1243``)."""

    @property
    def soc(self) -> np.ndarray:
        return self._hist("battery_soc")

    @property
    def energy_balance(self) -> np.ndarray:
        return self._hist("battery_balance")

    @property
    def electricity_consumption(self) -> np.ndarray:
        return self._hist("battery_cons")

    @property
    def degraded_capacity(self) -> float:
        """Current (per-cycle-degraded) capacity
        (reference ``energy_model.py:1130-1141``)."""
        env = self._env
        if env._state is None:
            return float(self._spec.capacity)
        # one read of the device state per call (not per step)
        return float(env._state.battery_degraded_capacity[0, self._bi])


class ChargerView:
    """Live drop-in for ``citylearn.electric_vehicle_charger.Charger``:
    static attributes from :class:`ChargerSpec`, per-episode series from the
    env's per-charger history (reference
    ``electric_vehicle_charger.py:320-349``)."""

    def __init__(self, env: "CityLearnEnv", ci: int, spec):
        self._env = env
        self._ci = ci
        self._spec = spec

    def __getattr__(self, name):
        try:
            return getattr(self._spec, name)
        except AttributeError:
            raise AttributeError(
                f"ChargerView has no attribute {name!r}") from None

    def _hist(self, key: str) -> np.ndarray:
        env = self._env
        env._sync_unwritten_row()
        return env._history[key][: env.time_step + 1, self._ci].copy()

    @property
    def electricity_consumption(self) -> np.ndarray:
        return self._hist("charger_cons")

    @property
    def past_charging_action_values_kwh(self) -> np.ndarray:
        return self._hist("charger_action_kwh")

class HVACDeviceView(_SpecDelegate):
    """HeatPump / ElectricHeater (reference ``energy_model.py:157-451``)."""

    def __init__(self, env, bi, spec, end_use: str):
        super().__init__(env, bi, spec)
        self._end_use = end_use  # cooling|heating|dhw

    @property
    def electricity_consumption(self) -> np.ndarray:
        return self._hist(f"{self._end_use}_cons")

    def get_cop(self, outdoor_dry_bulb_temperature, heating: bool):
        """Carnot-bounded COP for heat pumps, constant efficiency else
        (reference ``energy_model.py:216-251,378-404``)."""
        t = np.asarray(outdoor_dry_bulb_temperature, np.float64)
        if self._spec.is_heat_pump:
            return heat_pump_cop_np(
                t, self._spec.efficiency,
                self._spec.target_heating_temperature if heating
                else self._spec.target_cooling_temperature, heating)
        return np.full_like(t, self._spec.efficiency)

    def get_input_power(self, output_power, outdoor_dry_bulb_temperature,
                        heating: bool):
        return _hvac_input_power_np(
            self._spec, np.asarray(output_power, np.float64),
            np.asarray(outdoor_dry_bulb_temperature, np.float64), heating)


class PVView:
    """PV plant (reference ``energy_model.py:452-602``)."""

    def __init__(self, env, bi, nominal_power: float):
        self._env = env
        self._bi = bi
        self.nominal_power = float(nominal_power)

    def get_generation(self, inverter_ac_power_per_kw) -> np.ndarray:
        """``nominal_power * W_per_kW / 1000`` (reference
        ``energy_model.py:469-489``)."""
        return self.nominal_power * np.asarray(
            inverter_ac_power_per_kw, np.float64) / 1000.0

    @property
    def electricity_consumption(self) -> np.ndarray:
        env = self._env
        env._sync_unwritten_row()
        return env._history["solar"][: env.time_step + 1, self._bi].copy()


class _WindowedSeriesView:
    """Episode-window view over named input series — the reference's
    ``TimeSeriesData.__getattr__`` window slicing (``data.py:294-331``)."""

    def __init__(self, env: "CityLearnEnv", bi: int, names: List[str]):
        self._env = env
        self._bi = bi
        self._names = tuple(names)

    # fields the reference mutates in place on the energy_simulation object
    # during the episode (LSTM temperature prediction building.py:3000-3037,
    # partial-load demand 3080-3158, occupant setpoints 3248-3317): realized
    # values up to the current step, the raw data beyond it
    _CONTROLLED = {
        "indoor_dry_bulb_temperature": "indoor_temperature",
        "cooling_demand": "cooling_demand_actual",
        "heating_demand": "heating_demand_actual",
        "indoor_dry_bulb_temperature_cooling_set_point": "cooling_sp",
        "indoor_dry_bulb_temperature_heating_set_point": "heating_sp",
    }

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        b = self._env.spec.buildings[self._bi]
        if name not in b.series:
            raise AttributeError(
                f"{type(self).__name__} has no series {name!r}")
        ep = self._env.episode_tracker
        sl = slice(ep.episode_start_time_step, ep.episode_end_time_step + 1)
        data = b.series[name][sl]
        hist_key = self._CONTROLLED.get(name)
        if hist_key is not None and name in ENERGY_SIMULATION_FIELDS:
            env = self._env
            env._sync_unwritten_row()
            realized = env._history[hist_key][: env.time_step + 1, self._bi]
            data = np.array(data, copy=True)
            n = min(len(realized), len(data))
            data[:n] = realized[:n]
        return data

    def __dir__(self):
        return sorted(set(super().__dir__()) | set(self._names))


ENERGY_SIMULATION_FIELDS = (
    "month", "hour", "day_type", "daylight_savings_status",
    "indoor_dry_bulb_temperature", "average_unmet_cooling_setpoint_difference",
    "indoor_relative_humidity", "non_shiftable_load", "dhw_demand",
    "cooling_demand", "heating_demand", "solar_generation", "occupant_count",
    "indoor_dry_bulb_temperature_cooling_set_point",
    "indoor_dry_bulb_temperature_heating_set_point", "hvac_mode",
    "comfort_band", "power_outage")
WEATHER_FIELDS = tuple(
    f"{k}{s}" for k in ("outdoor_dry_bulb_temperature",
                        "outdoor_relative_humidity",
                        "diffuse_solar_irradiance",
                        "direct_solar_irradiance")
    for s in ("", "_predicted_1", "_predicted_2", "_predicted_3"))
PRICING_FIELDS = ("electricity_pricing", "electricity_pricing_predicted_1",
                  "electricity_pricing_predicted_2",
                  "electricity_pricing_predicted_3")
CARBON_FIELDS = ("carbon_intensity",)


class BuildingView(_SpecDelegate):
    """Live drop-in for ``citylearn.building.Building``: static attributes
    come from the resolved :class:`BuildingSpec`; per-episode series are
    materialized from the env's history arrays on access."""

    # ------------------------------------------------------------------
    # devices
    # ------------------------------------------------------------------
    @property
    def cooling_device(self) -> HVACDeviceView:
        return HVACDeviceView(self._env, self._bi, self._spec.cooling_device, "cooling")

    @property
    def heating_device(self) -> HVACDeviceView:
        return HVACDeviceView(self._env, self._bi, self._spec.heating_device, "heating")

    @property
    def dhw_device(self) -> HVACDeviceView:
        return HVACDeviceView(self._env, self._bi, self._spec.dhw_device, "dhw")

    @property
    def cooling_storage(self) -> StorageTankView:
        return StorageTankView(self._env, self._bi, self._spec.cooling_storage, "cooling")

    @property
    def heating_storage(self) -> StorageTankView:
        return StorageTankView(self._env, self._bi, self._spec.heating_storage, "heating")

    @property
    def dhw_storage(self) -> StorageTankView:
        return StorageTankView(self._env, self._bi, self._spec.dhw_storage, "dhw")

    @property
    def electrical_storage(self) -> BatteryView:
        return BatteryView(self._env, self._bi, self._spec.battery)

    @property
    def pv(self) -> PVView:
        return PVView(self._env, self._bi, self._spec.pv_nominal_power)

    @property
    def electric_vehicle_chargers(self) -> List["ChargerView"]:
        """Per-charger live views (reference ``building.py:225-228``)."""
        slots, _ = self._env._charger_action_slots
        return [ChargerView(self._env,
                            slots[f"electric_vehicle_storage_{ch.charger_id}"],
                            ch)
                for ch in self._spec.chargers]

    @property
    def chargers_electricity_consumption(self) -> np.ndarray:
        """Sum over this building's chargers (reference
        ``building.py:467-471``)."""
        return self._hist("chargers_cons")

    # ------------------------------------------------------------------
    # input-data views (reference TimeSeriesData containers)
    # ------------------------------------------------------------------
    @property
    def energy_simulation(self) -> _WindowedSeriesView:
        return _WindowedSeriesView(self._env, self._bi, ENERGY_SIMULATION_FIELDS)

    @property
    def weather(self) -> _WindowedSeriesView:
        return _WindowedSeriesView(self._env, self._bi, WEATHER_FIELDS)

    @property
    def pricing(self) -> _WindowedSeriesView:
        return _WindowedSeriesView(self._env, self._bi, PRICING_FIELDS)

    @property
    def carbon_intensity(self) -> _WindowedSeriesView:
        return _WindowedSeriesView(self._env, self._bi, CARBON_FIELDS)

    # ------------------------------------------------------------------
    # per-episode series (length time_step + 1)
    # ------------------------------------------------------------------
    @property
    def net_electricity_consumption(self) -> np.ndarray:
        return self._hist("net")

    @property
    def net_electricity_consumption_cost(self) -> np.ndarray:
        return self._hist("cost")

    @property
    def net_electricity_consumption_emission(self) -> np.ndarray:
        return self._hist("emission")

    def _counterfactual(self, condition: str) -> np.ndarray:
        return self._env._building_series(self._bi, condition)[0]

    @property
    def net_electricity_consumption_without_storage(self) -> np.ndarray:
        """Net minus all storage (incl. charger) consumption
        (reference ``building.py:345-366``)."""
        return self._counterfactual("_without_storage")

    @property
    def net_electricity_consumption_without_storage_and_pv(self) -> np.ndarray:
        return self._counterfactual("_without_storage_and_pv")

    @property
    def net_electricity_consumption_without_storage_and_partial_load(self) -> np.ndarray:
        """DynamicsBuilding counterfactual (reference ``building.py:2863-2933``)."""
        return self._counterfactual("_without_storage_and_partial_load")

    @property
    def net_electricity_consumption_without_storage_and_partial_load_and_pv(self) -> np.ndarray:
        return self._counterfactual("_without_storage_and_partial_load_and_pv")

    @property
    def cooling_electricity_consumption(self) -> np.ndarray:
        return self._hist("cooling_cons")

    @property
    def heating_electricity_consumption(self) -> np.ndarray:
        return self._hist("heating_cons")

    @property
    def dhw_electricity_consumption(self) -> np.ndarray:
        return self._hist("dhw_cons")

    @property
    def non_shiftable_load_electricity_consumption(self) -> np.ndarray:
        return self._hist("nsl_cons")

    @property
    def solar_generation(self) -> np.ndarray:
        """PV output as *negative* consumption (reference ``building.py:476``)."""
        return self._hist("solar")

    @property
    def cooling_demand(self) -> np.ndarray:
        """Delivered (possibly partial-load) cooling demand
        (reference mutated ``energy_simulation.cooling_demand``)."""
        return self._hist("cooling_demand_actual")

    @property
    def heating_demand(self) -> np.ndarray:
        return self._hist("heating_demand_actual")

    @property
    def dhw_demand(self) -> np.ndarray:
        env, bi = self._env, self._bi
        sl = slice(env.episode_tracker.episode_start_time_step,
                   env.episode_tracker.episode_start_time_step + env.time_step + 1)
        return self._spec.series["dhw_demand"][sl].astype(np.float32)

    @property
    def non_shiftable_load(self) -> np.ndarray:
        env = self._env
        sl = slice(env.episode_tracker.episode_start_time_step,
                   env.episode_tracker.episode_start_time_step + env.time_step + 1)
        return self._spec.series["non_shiftable_load"][sl].astype(np.float32)

    @property
    def energy_from_cooling_device(self) -> np.ndarray:
        return self._hist("cooling_demand_met")

    @property
    def energy_from_heating_device(self) -> np.ndarray:
        return self._hist("heating_demand_met")

    @property
    def energy_from_dhw_device(self) -> np.ndarray:
        return self._hist("dhw_demand_met")

    # ------------------------------------------------------------------
    # storage flow series (reference building.py:479-560): clipped
    # energy-balance polarities
    # ------------------------------------------------------------------
    @property
    def cooling_storage_electricity_consumption(self) -> np.ndarray:
        return self._hist("cooling_storage_cons")

    @property
    def heating_storage_electricity_consumption(self) -> np.ndarray:
        return self._hist("heating_storage_cons")

    @property
    def dhw_storage_electricity_consumption(self) -> np.ndarray:
        return self._hist("dhw_storage_cons")

    @property
    def electrical_storage_electricity_consumption(self) -> np.ndarray:
        return self._hist("battery_cons")

    @property
    def energy_from_cooling_storage(self) -> np.ndarray:
        return np.clip(self._hist("cooling_storage_balance"), None, 0) * -1

    @property
    def energy_from_heating_storage(self) -> np.ndarray:
        return np.clip(self._hist("heating_storage_balance"), None, 0) * -1

    @property
    def energy_from_dhw_storage(self) -> np.ndarray:
        return np.clip(self._hist("dhw_storage_balance"), None, 0) * -1

    @property
    def energy_from_electrical_storage(self) -> np.ndarray:
        return np.clip(self._hist("battery_balance"), None, 0) * -1

    @property
    def energy_from_cooling_device_to_cooling_storage(self) -> np.ndarray:
        return np.clip(self._hist("cooling_storage_balance"), 0, None)

    @property
    def energy_from_heating_device_to_heating_storage(self) -> np.ndarray:
        return np.clip(self._hist("heating_storage_balance"), 0, None)

    @property
    def energy_from_dhw_device_to_dhw_storage(self) -> np.ndarray:
        return np.clip(self._hist("dhw_storage_balance"), 0, None)

    @property
    def energy_to_electrical_storage(self) -> np.ndarray:
        return np.clip(self._hist("battery_balance"), 0, None)

    @property
    def energy_to_non_shiftable_load(self) -> np.ndarray:
        return self._hist("non_shiftable_load_met")

    # ------------------------------------------------------------------
    # device COP series (reference building.py:600-632: heat pumps only,
    # zeros for electric heaters)
    # ------------------------------------------------------------------
    def _cop_series(self, dev, heating: bool) -> np.ndarray:
        env = self._env
        n = env.time_step + 1
        sl = slice(env.episode_tracker.episode_start_time_step,
                   env.episode_tracker.episode_start_time_step + n)
        if not dev.is_heat_pump:
            return np.zeros(n, np.float32)
        t = self._spec.series["outdoor_dry_bulb_temperature"][sl].astype(np.float64)
        return heat_pump_cop_np(
            t, dev.efficiency,
            dev.target_heating_temperature if heating
            else dev.target_cooling_temperature, heating)

    @property
    def cooling_device_cop(self) -> np.ndarray:
        return self._cop_series(self._spec.cooling_device, False)

    @property
    def heating_device_cop(self) -> np.ndarray:
        return self._cop_series(self._spec.heating_device, True)

    @property
    def dhw_device_cop(self) -> np.ndarray:
        return self._cop_series(self._spec.dhw_device, True)

    # ------------------------------------------------------------------
    # ideal-load counterfactual series (reference building.py:2917-2933)
    # ------------------------------------------------------------------
    def _raw_window(self, name: str) -> np.ndarray:
        env = self._env
        sl = slice(env.episode_tracker.episode_start_time_step,
                   env.episode_tracker.episode_start_time_step
                   + env.time_step + 1)
        return self._spec.series[name][sl].astype(np.float32)

    @property
    def cooling_demand_without_partial_load(self) -> np.ndarray:
        return self._raw_window("cooling_demand")

    @property
    def heating_demand_without_partial_load(self) -> np.ndarray:
        return self._raw_window("heating_demand")

    @property
    def indoor_dry_bulb_temperature_without_partial_load(self) -> np.ndarray:
        return self._raw_window("indoor_dry_bulb_temperature")

    @property
    def indoor_dry_bulb_temperature(self) -> np.ndarray:
        """Realized indoor temperature (LSTM-predicted for dynamics
        buildings; the data series otherwise)."""
        return self._hist("indoor_temperature")

    @property
    def indoor_dry_bulb_temperature_cooling_set_point(self) -> np.ndarray:
        """Effective (occupant-mutated) cooling setpoint series."""
        return self._hist("cooling_sp")

    @property
    def indoor_dry_bulb_temperature_heating_set_point(self) -> np.ndarray:
        return self._hist("heating_sp")

    @property
    def power_outage_signal(self) -> np.ndarray:
        env = self._env
        return env._outage_np[: env.time_step + 1, self._bi].copy()

    # ------------------------------------------------------------------
    def observations(self, include_all: bool = False, normalize: bool = False,
                     periodic_normalization: bool = False) -> dict:
        """Current observation name -> value mapping
        (reference ``building.py:1115-1219``)."""
        env = self._env
        per_building = env._building_observations()
        names = self._spec.active_observations
        out = dict(zip(names, per_building[self._bi]))
        if not include_all:
            return out
        return out

    @property
    def observation_space(self):
        b = self._spec
        lo = np.array([b.observation_low[k] for k in b.active_observations],
                      np.float32)
        hi = np.array([b.observation_high[k] for k in b.active_observations],
                      np.float32)
        return box(lo, hi)

    @property
    def action_space(self):
        b = self._spec
        return box(np.asarray(b.action_low, np.float32), np.asarray(b.action_high, np.float32))

    def __repr__(self):
        return f"BuildingView({self._spec.name!r})"
