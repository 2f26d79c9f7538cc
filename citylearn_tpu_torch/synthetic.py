"""Seeded district datasets in the CityLearn schema format.

:func:`write_battery_pv_dataset` writes a ``schema.json`` and its CSVs in
the shape of the ``citylearn_challenge_2022_phase_1`` dataset: hourly
rows, buildings with a battery (explicit attributes and both curves, no
autosize) and a PV array (explicit nominal power), one weather,
carbon-intensity and pricing file shared by the district, and the
default ``RewardFunction``. :func:`write_thermal_dataset` writes the
shape of ``citylearn_challenge_2021``: the same plus cooling and DHW
demand, a cooling heat pump, a DHW heater or heat pump, and cooling and
DHW storage tanks. The series are smooth daily and seasonal profiles
with seeded noise; they stand in for the bundled CityLearn data when it
is not installed.
"""

from __future__ import annotations

import json
import os

import numpy as np

OBSERVATIONS = [
    "month", "day_type", "hour", "outdoor_dry_bulb_temperature",
    "outdoor_dry_bulb_temperature_predicted_1",
    "outdoor_dry_bulb_temperature_predicted_2",
    "outdoor_dry_bulb_temperature_predicted_3",
    "outdoor_relative_humidity", "diffuse_solar_irradiance",
    "direct_solar_irradiance", "carbon_intensity", "non_shiftable_load",
    "solar_generation", "electrical_storage_soc",
    "net_electricity_consumption", "electricity_pricing",
    "electricity_pricing_predicted_1", "electricity_pricing_predicted_2",
    "electricity_pricing_predicted_3",
]
SHARED = {
    "month", "day_type", "hour", "outdoor_dry_bulb_temperature",
    "outdoor_relative_humidity", "diffuse_solar_irradiance",
    "direct_solar_irradiance", "carbon_intensity", "electricity_pricing",
    "outdoor_dry_bulb_temperature_predicted_1",
    "outdoor_dry_bulb_temperature_predicted_2",
    "outdoor_dry_bulb_temperature_predicted_3",
    "electricity_pricing_predicted_1", "electricity_pricing_predicted_2",
    "electricity_pricing_predicted_3",
}
ACTIONS = ["cooling_storage", "heating_storage", "dhw_storage",
           "electrical_storage"]


def _write_csv(path: str, columns: dict):
    """Columns of ints or floats; floats with 6 significant digits so that
    every CSV reader parses them to the same float64."""
    names = list(columns)
    cols = [np.asarray(columns[k]) for k in names]
    fmt = ["%d" if np.issubdtype(c.dtype, np.integer) else "%.6g" for c in cols]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(cols[0])):
            f.write(",".join(fm % c[i] for fm, c in zip(fmt, cols)) + "\n")


def _calendar(n_rows: int):
    t = np.arange(n_rows)
    hour = t % 24 + 1                                   # 1-24
    day = t // 24
    month = np.minimum(day % 365 // 31, 11) + 1
    day_type = day % 7 + 1                              # 1-7
    return hour, day, month, day_type


def _write_shared_files(root: str, n_rows: int, rng: np.random.RandomState):
    """Write the district's weather, carbon-intensity and pricing CSVs.
    Returns the calendar and the profiles the building files build on."""
    os.makedirs(root, exist_ok=True)
    hour, day, month, day_type = _calendar(n_rows)
    h = hour - 1
    season = np.cos(2 * np.pi * (day - 200) / 365)      # 1 in mid-summer
    daylight = np.clip(np.sin(np.pi * (h - 6) / 13), 0, None)

    temp = 15 + 10 * season + 5 * np.sin(np.pi * (h - 9) / 12) + rng.normal(0, 1, n_rows)
    humidity = np.clip(60 - 15 * np.sin(np.pi * (h - 9) / 12) + rng.normal(0, 5, n_rows), 5, 100)
    direct = np.clip(700 * daylight * (0.8 + 0.2 * season) + rng.normal(0, 30, n_rows), 0, None) * (daylight > 0)
    diffuse = np.clip(150 * daylight + rng.normal(0, 10, n_rows), 0, None) * (daylight > 0)
    weather = {"outdoor_dry_bulb_temperature": temp, "outdoor_relative_humidity": humidity,
               "diffuse_solar_irradiance": diffuse, "direct_solar_irradiance": direct}
    for base in list(weather):
        for i, lead in zip((1, 2, 3), (6, 12, 24)):
            weather[f"{base}_predicted_{i}"] = np.roll(weather[base], -lead)
    _write_csv(os.path.join(root, "weather.csv"), weather)

    carbon = 0.15 + 0.05 * np.cos(2 * np.pi * (h - 19) / 24) + rng.normal(0, 0.005, n_rows)
    _write_csv(os.path.join(root, "carbon_intensity.csv"),
               {"carbon_intensity": np.clip(carbon, 0.05, 0.5)})

    price = np.where((h >= 16) & (h < 21), 0.54, np.where((h >= 9) & (h < 16), 0.40, 0.22))
    pricing = {"electricity_pricing": price}
    for i, lead in zip((1, 2, 3), (6, 12, 24)):
        pricing[f"electricity_pricing_predicted_{i}"] = np.roll(price, -lead)
    _write_csv(os.path.join(root, "pricing.csv"), pricing)
    return dict(hour=hour, month=month, day_type=day_type, h=h, season=season,
                temp=temp, irradiance=np.clip(direct + diffuse, 0, None))


def _load_and_solar(rng: np.random.RandomState, cal: dict, n_rows: int):
    """One building's non-shiftable load and its PV output per kW of
    nominal power, in W (the compiler scales by nominal_power / 1000)."""
    h, season = cal["h"], cal["season"]
    base = rng.uniform(0.5, 1.5)
    peak = rng.uniform(1.0, 3.0)
    load = (base + peak * np.exp(-((h - 19) / 2.5) ** 2)
            + 0.5 * peak * np.exp(-((h - 8) / 1.5) ** 2)
            + 0.3 * (1 + season) + rng.gamma(2.0, 0.1, n_rows))
    return load, cal["irradiance"] * rng.uniform(0.18, 0.22)


def _battery_and_pv(rng: np.random.RandomState) -> dict:
    """Explicit (no autosize) battery and PV blocks of one building."""
    capacity = float(np.round(rng.uniform(4.0, 10.0), 2))
    eff = float(np.round(rng.uniform(0.88, 0.95), 3))
    return {
        "electrical_storage": {
            "type": "citylearn.energy_model.Battery",
            "autosize": False,
            "attributes": {
                "capacity": capacity,
                "efficiency": eff,
                "capacity_loss_coefficient": 1e-05,
                "loss_coefficient": 0.0,
                "nominal_power": float(np.round(rng.uniform(3.0, 6.0), 2)),
                "initial_soc": float(np.round(rng.uniform(0.0, 0.5), 2)),
                "power_efficiency_curve": [[0, 0.83], [0.3, 0.83], [0.7, 0.9],
                                           [0.8, 0.9], [1, 0.85]],
                "capacity_power_curve": [[0.0, 1], [0.8, 1], [1.0, 0.2]],
            },
        },
        "pv": {
            "type": "citylearn.energy_model.PV",
            "autosize": False,
            "attributes": {"nominal_power": float(np.round(rng.uniform(2.0, 8.0), 2))},
        },
    }


def _building_entry(name: str, devices: dict) -> dict:
    return {"include": True, "energy_simulation": f"{name}.csv", "weather": "weather.csv",
            "carbon_intensity": "carbon_intensity.csv", "pricing": "pricing.csv",
            "inactive_observations": [], "inactive_actions": [], **devices}


def _write_schema(root: str, n_rows: int, seed: int, observations, active_actions,
                  buildings: dict) -> str:
    schema = {
        "random_seed": seed,
        "root_directory": None,
        "central_agent": False,
        "simulation_start_time_step": 0,
        "simulation_end_time_step": n_rows - 1,
        "episode_time_steps": None,
        "rolling_episode_split": False,
        "random_episode_split": False,
        "seconds_per_time_step": 3600,
        "observations": {k: {"active": True, "shared_in_central_agent": k in SHARED}
                         for k in observations},
        "actions": {k: {"active": k in active_actions} for k in ACTIONS},
        "agent": {"type": "citylearn.agents.base.BaselineAgent", "attributes": {}},
        "reward_function": {"type": "citylearn.reward_function.RewardFunction",
                            "attributes": None},
        "buildings": buildings,
    }
    path = os.path.join(root, "schema.json")
    with open(path, "w") as f:
        json.dump(schema, f, indent=2)
    return path


def write_battery_pv_dataset(root: str, n_buildings: int = 5, n_rows: int = 8760,
                             seed: int = 0) -> str:
    """Write the dataset under ``root`` and return the path of its
    ``schema.json``. The same arguments always write the same files."""
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "non_shiftable_load": load, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)
        buildings[name] = _building_entry(name, _battery_and_pv(rng))
    return _write_schema(root, n_rows, seed, OBSERVATIONS, {"electrical_storage"}, buildings)


def write_thermal_dataset(root: str, n_buildings: int = 9, n_rows: int = 8760,
                          seed: int = 0, heating: bool = False) -> str:
    """Write a thermal-storage district under ``root`` and return the path
    of its ``schema.json``. The same arguments always write the same files.

    Every building has cooling demand (highest on summer afternoons, none
    on the coldest nights) met by a heat pump, DHW
    demand, a cooling tank, a battery and PV, all with explicit
    attributes. The district is heterogeneous as the 2021 set is: the DHW
    device is an electric heater, except a heat pump in every third
    building; building 2 has no DHW tank (the compiler's zero-capacity
    default), building 3 has finite tank power caps, and building 4 an
    undersized cooling heat pump that saturates on hot afternoons.

    With ``heating=False`` there is no heating end use at all, as in
    ``citylearn_challenge_2021``. The reference converts the DHW storage
    action through the *heating* tank's capacity, which is then 0, so DHW
    tanks only lose their initial charge. ``heating=True`` adds winter
    heating demand (never in a row with cooling demand), a heating device
    (an electric heater in building 2, else a heat pump) and a heating
    tank, which also makes the DHW tanks controllable.
    """
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)
    h, season, temp = cal["h"], cal["season"], cal["temp"]
    r2 = lambda lo, hi: float(np.round(rng.uniform(lo, hi), 2))

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        afternoon = 0.4 + 0.6 * np.exp(-((h - 15) / 4.0) ** 2)
        cooling = np.clip((temp - 5) * rng.uniform(0.15, 0.3) * afternoon
                          + rng.normal(0, 0.1, n_rows), 0, None)
        dhw = np.clip(rng.uniform(0.3, 0.9) * (np.exp(-((h - 7) / 1.5) ** 2)
                                              + 0.7 * np.exp(-((h - 20) / 2.0) ** 2))
                      + rng.normal(0, 0.03, n_rows), 0, None)
        heat = np.clip((10 - temp) * rng.uniform(0.2, 0.4) + rng.normal(0, 0.1, n_rows), 0, None)
        heat = heat * (cooling == 0) if heating else np.zeros(n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "indoor_dry_bulb_temperature": 22 + 2 * season + rng.normal(0, 0.3, n_rows),
                  "non_shiftable_load": load, "dhw_demand": dhw, "cooling_demand": cooling,
                  "heating_demand": heat, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)

        tank = lambda capacity, caps=False: {
            "type": "citylearn.energy_model.StorageTank",
            "autosize": False,
            "attributes": {"capacity": capacity, "efficiency": r2(0.9, 0.98),
                           "loss_coefficient": float(np.round(rng.uniform(0.002, 0.008), 4)),
                           "initial_soc": r2(0.1, 0.6),
                           **({"max_input_power": r2(0.8, 1.5), "max_output_power": r2(0.8, 1.5)}
                              if caps else {})}}
        heat_pump = lambda power: {
            "type": "citylearn.energy_model.HeatPump",
            "autosize": False,
            "attributes": {"nominal_power": power, "efficiency": r2(0.2, 0.3),
                           "target_cooling_temperature": r2(7.0, 10.0),
                           "target_heating_temperature": r2(45.0, 50.0)}}
        heater = lambda power: {
            "type": "citylearn.energy_model.ElectricHeater",
            "autosize": False,
            "attributes": {"nominal_power": power, "efficiency": r2(0.9, 0.99)}}

        devices = _battery_and_pv(rng)
        devices["cooling_device"] = heat_pump(0.6 if b == 4 else r2(3.0, 5.0))
        devices["dhw_device"] = (heat_pump if b % 3 == 2 else heater)(r2(2.0, 4.0))
        sized = lambda lo, hi, demand: float(np.round(rng.uniform(lo, hi) * demand.max(), 2))
        devices["cooling_storage"] = tank(sized(1.5, 3.0, cooling), caps=b == 3)
        if b != 2:
            devices["dhw_storage"] = tank(sized(1.5, 3.0, dhw), caps=b == 3)
        if heating:
            devices["heating_device"] = (heater if b == 2 else heat_pump)(r2(3.0, 6.0))
            devices["heating_storage"] = tank(sized(1.0, 2.0, heat))
        buildings[name] = _building_entry(name, devices)

    observations = OBSERVATIONS + ["indoor_dry_bulb_temperature", "cooling_storage_soc",
                                   "dhw_storage_soc"] + (["heating_storage_soc"] if heating else [])
    actions = {"cooling_storage", "dhw_storage", "electrical_storage"} \
        | ({"heating_storage"} if heating else set())
    return _write_schema(root, n_rows, seed, observations, actions, buildings)
