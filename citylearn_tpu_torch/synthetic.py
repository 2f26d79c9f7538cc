"""Seeded battery+PV district dataset in the CityLearn schema format.

Writes a ``schema.json`` and its CSVs in the shape of the
``citylearn_challenge_2022_phase_1`` dataset: hourly rows, buildings
with a battery (explicit attributes and both curves, no autosize) and a
PV array (explicit nominal power), one weather, carbon-intensity and
pricing file shared by the district, and the default ``RewardFunction``.
The series are smooth daily and seasonal profiles with seeded noise;
they stand in for the bundled CityLearn data when it is not installed.
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


def write_battery_pv_dataset(root: str, n_buildings: int = 5, n_rows: int = 8760,
                             seed: int = 0) -> str:
    """Write the dataset under ``root`` and return the path of its
    ``schema.json``. The same arguments always write the same files."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
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

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        base = rng.uniform(0.5, 1.5)
        peak = rng.uniform(1.0, 3.0)
        load = (base + peak * np.exp(-((h - 19) / 2.5) ** 2)
                + 0.5 * peak * np.exp(-((h - 8) / 1.5) ** 2)
                + 0.3 * (1 + season) + rng.gamma(2.0, 0.1, n_rows))
        # PV output per kW of nominal power, in W (the compiler scales by
        # nominal_power / 1000)
        solar = np.clip(direct + diffuse, 0, None) * rng.uniform(0.18, 0.22)
        energy = {"month": month, "hour": hour, "day_type": day_type,
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "non_shiftable_load": load, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)
        capacity = float(np.round(rng.uniform(4.0, 10.0), 2))
        eff = float(np.round(rng.uniform(0.88, 0.95), 3))
        buildings[name] = {
            "include": True,
            "energy_simulation": f"{name}.csv",
            "weather": "weather.csv",
            "carbon_intensity": "carbon_intensity.csv",
            "pricing": "pricing.csv",
            "inactive_observations": [],
            "inactive_actions": [],
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
                         for k in OBSERVATIONS},
        "actions": {k: {"active": k == "electrical_storage"} for k in ACTIONS},
        "agent": {"type": "citylearn.agents.base.BaselineAgent", "attributes": {}},
        "reward_function": {"type": "citylearn.reward_function.RewardFunction",
                            "attributes": None},
        "buildings": buildings,
    }
    path = os.path.join(root, "schema.json")
    with open(path, "w") as f:
        json.dump(schema, f, indent=2)
    return path

