"""Seeded district datasets in the CityLearn schema format.

:func:`write_battery_pv_dataset` writes a ``schema.json`` and its CSVs in
the shape of the ``citylearn_challenge_2022_phase_1`` dataset: hourly
rows, buildings with a battery (explicit attributes and both curves, no
autosize) and a PV array (explicit nominal power), one weather,
carbon-intensity and pricing file shared by the district, and the
default ``RewardFunction``. :func:`write_thermal_dataset` writes the
shape of ``citylearn_challenge_2021``: the same plus cooling and DHW
demand, a cooling heat pump, a DHW heater or heat pump, and cooling and
DHW storage tanks. :func:`write_ev_dataset` writes the shape of
``citylearn_challenge_2022_phase_all_plus_evs``: battery+PV buildings
plus EV chargers with their schedule files, electric vehicles, washing
machines, the EV reward function and, on request, charging constraints.
:func:`write_lstm_dataset` writes the shape of
``citylearn_challenge_2023_phase_1``: buildings whose indoor temperature
follows an LSTM model (weights in a ``.pth`` file beside the CSVs), a
cooling heat pump under the ``cooling_device`` action, DHW heater and
tank, battery and PV, the ``ComfortReward`` and, on request, power
outages.
:func:`write_epw` writes an hourly EnergyPlus weather file and
:func:`write_battery_choices` a ``battery_choices.yaml`` of manufacturer
battery models, the two inputs of the PV and battery autosize.
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
                temp=temp, irradiance=np.clip(direct + diffuse, 0, None),
                direct=direct, diffuse=diffuse)


def _quarter_hours(energy: dict, n_rows: int) -> dict:
    """The building columns relabelled as 15-minute rows: ``hour`` advances
    every fourth row and a ``minutes`` column follows it, so that the
    compiler derives a time-step ratio of 4 against hourly steps."""
    t = np.arange(n_rows)
    out = {}
    for k, v in energy.items():
        out[k] = (t // 4) % 24 + 1 if k == "hour" else v
        if k == "hour":
            out["minutes"] = (t % 4) * 15
    return out


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
                  buildings: dict, action_names=ACTIONS, reward_function: dict = None,
                  extra: dict = None) -> str:
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
        "actions": {k: {"active": k in active_actions} for k in action_names},
        "agent": {"type": "citylearn.agents.base.BaselineAgent", "attributes": {}},
        "reward_function": reward_function or {
            "type": "citylearn.reward_function.RewardFunction", "attributes": None},
        "buildings": buildings,
        **(extra or {}),
    }
    path = os.path.join(root, "schema.json")
    with open(path, "w") as f:
        json.dump(schema, f, indent=2)
    return path


def write_battery_pv_dataset(root: str, n_buildings: int = 5, n_rows: int = 8760,
                             seed: int = 0, minutes: bool = False) -> str:
    """Write the dataset under ``root`` and return the path of its
    ``schema.json``. The same arguments always write the same files.
    ``minutes=True`` labels the rows as 15-minute steps (an ``hour`` that
    advances every fourth row and a ``minutes`` column), which hourly
    steps read at a time-step ratio of 4."""
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "non_shiftable_load": load, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"),
                   _quarter_hours(energy, n_rows) if minutes else energy)
        buildings[name] = _building_entry(name, _battery_and_pv(rng))
    return _write_schema(root, n_rows, seed, OBSERVATIONS, {"electrical_storage"}, buildings)


def write_thermal_dataset(root: str, n_buildings: int = 9, n_rows: int = 8760,
                          seed: int = 0, heating: bool = False, minutes: bool = False) -> str:
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
    tank, which also makes the DHW tanks controllable. ``minutes=True``
    labels the rows as 15-minute steps, as :func:`write_battery_pv_dataset`
    does.
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
        _write_csv(os.path.join(root, f"{name}.csv"),
                   _quarter_hours(energy, n_rows) if minutes else energy)

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


CHARGER_OBSERVATIONS = [
    "electric_vehicle_charger_connected_state",
    "connected_electric_vehicle_at_charger_departure_time",
    "connected_electric_vehicle_at_charger_required_soc_departure",
    "connected_electric_vehicle_at_charger_soc",
    "connected_electric_vehicle_at_charger_battery_capacity",
    "electric_vehicle_charger_incoming_state",
    "incoming_electric_vehicle_at_charger_estimated_arrival_time",
    "incoming_electric_vehicle_at_charger_estimated_soc_arrival",
]
WASHING_MACHINE_OBSERVATIONS = ["washing_machine_start_time_step",
                                "washing_machine_end_time_step"]
EV_REWARD_WEIGHTS = {"no_car_charging": -5.0, "battery_limits": -2.0, "soc_impossible": -10.0,
                     "soc_under": -5.0, "close_soc": 10.0, "self_ev_consumption": 5.0,
                     "extra_self_production": 5.0}


def _write_cells(path: str, columns: dict):
    """Columns of ready-made cells (strings; "" is an empty cell)."""
    names = list(columns)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in zip(*(columns[k] for k in names)):
            f.write(",".join(row) + "\n")


def _charger_schedule(rng: np.random.RandomState, c: int, n_rows: int, n_docking: int,
                      ev_capacity: list) -> dict:
    """One charger's schedule file. Each day the charger may host one EV,
    ``(c + day) % n_docking``, from an evening hour (16:00-20:00) to a
    morning hour of the next day (05:00-09:00): every stay ends before
    any stay of the next day starts and chargers of one day host
    distinct EVs, so no EV is ever at two chargers in one row. State 1
    marks the connected rows (the last one has 0 hours to departure),
    state 2 the two rows before an announced arrival, state 3 the rest."""
    g = lambda x: "%.6g" % x
    blank = lambda: [""] * n_rows
    state = ["3"] * n_rows
    ev_id, cap, soc, dep, req, eta, est = (blank() for _ in range(7))
    arrive_hour, depart_hour = 16 + c % 5, 5 + (3 * c) % 5
    for day in range(n_rows // 24 + 1):
        skipped, announced = rng.rand() < 0.15, rng.rand() < 0.7
        arrival_soc, required = rng.uniform(20, 60), rng.uniform(70, 95)
        if skipped:
            continue
        v = (c + day) % n_docking
        first, last = day * 24 + arrive_hour, (day + 1) * 24 + depart_hour
        for t in range(first - 2, min(last + 1, n_rows)):
            ev_id[t] = f"EV_{v + 1}"
            if t < first:
                if not announced:
                    ev_id[t] = ""
                    continue
                state[t] = "2"
                eta[t], est[t] = "%d" % (first - t), g(arrival_soc)
            else:
                state[t] = "1"
                frac = (t - first) / (last - first)
                cap[t] = g(ev_capacity[v])
                soc[t] = g(ev_capacity[v] * (arrival_soc + (required - arrival_soc) * frac) / 100)
                dep[t], req[t] = "%d" % (last - t), g(required)
    return {"electric_vehicle_charger_state": state, "electric_vehicle_id": ev_id,
            "electric_vehicle_battery_capacity_khw": cap, "current_soc": soc,
            "electric_vehicle_departure_time": dep,
            "electric_vehicle_required_soc_departure": req,
            "electric_vehicle_estimated_arrival_time": eta,
            "electric_vehicle_estimated_soc_arrival": est}


def write_ev_dataset(root: str, n_buildings: int = 17, n_chargers: int = 8, n_evs: int = 15,
                     n_washing_machines: int = 1, n_rows: int = 8760, seed: int = 0,
                     constraints: bool = False) -> str:
    """Write an EV district under ``root`` and return the path of its
    ``schema.json``. The same arguments always write the same files.

    Buildings are battery+PV buildings as :func:`write_battery_pv_dataset`
    writes them. Chargers 0 and 1 stand on building 0, the others on
    buildings 2, 4, 6, ...; building 1 has none. Charger 0 has
    power-dependent charge and discharge efficiency curves, charger 1
    non-zero minimum powers in both directions, every third charger cannot
    discharge. Up to three EVs never dock (their SOC only drifts); the
    others rotate over the chargers day by day (see
    :func:`_charger_schedule`), some arrivals announced by incoming rows
    and some not, so both ways of forcing the arrival SOC occur. Washing
    machines stand on buildings 1, 3, ...; each day has one start/end
    window, written as row indices. The reward is the
    ``Electric_Vehicles_Reward_Function`` with explicit weights.

    ``constraints=True`` adds charging constraints: building 0 gets a
    building limit and one phase per charger, building 2 a building limit
    alone, all below the chargers' maximum power, so that the limits bind
    under a plan that charges hard."""
    if n_buildings < 3 or n_chargers < 2 or n_evs < n_chargers:
        raise ValueError("an EV district needs 3 buildings, 2 chargers and at least as "
                         "many EVs as chargers")
    charger_building = [0 if c < 2 else min(2 * (c - 1), n_buildings - 1)
                        for c in range(n_chargers)]
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)
    r2 = lambda lo, hi: float(np.round(rng.uniform(lo, hi), 2))

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "non_shiftable_load": load, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)
        buildings[name] = _building_entry(name, _battery_and_pv(rng))

    electric_vehicles = {}
    for v in range(n_evs):
        electric_vehicles[f"EV_{v + 1}"] = {"include": True, "battery": {
            "type": "citylearn.energy_model.Battery",
            "attributes": {"capacity": r2(40.0, 80.0), "nominal_power": r2(11.0, 50.0),
                           "initial_soc": r2(0.2, 0.8), "depth_of_discharge": r2(0.7, 0.9),
                           "efficiency": r2(0.9, 0.97), "loss_coefficient": 0.0,
                           "capacity_loss_coefficient": 1e-05}}}
    ev_capacity = [e["battery"]["attributes"]["capacity"] for e in electric_vehicles.values()]
    n_docking = n_evs - min(3, n_evs - n_chargers)

    for c in range(n_chargers):
        cid = f"charger_{charger_building[c] + 1}_{c + 1}"
        _write_cells(os.path.join(root, f"{cid}.csv"),
                     _charger_schedule(rng, c, n_rows, n_docking, ev_capacity))
        attrs = {"efficiency": r2(0.9, 0.98), "max_charging_power": r2(6.0, 11.0),
                 "min_charging_power": 0.0,
                 "max_discharging_power": 0.0 if c % 3 == 2 else r2(5.0, 9.0),
                 "min_discharging_power": 0.0}
        if c == 0:
            attrs["charge_efficiency_curve"] = [[0, 0.83], [0.3, 0.9], [0.7, 0.95], [1, 0.9]]
            attrs["discharge_efficiency_curve"] = [[0, 0.8], [0.5, 0.93], [1, 0.88]]
        if c == 1:
            attrs["min_charging_power"], attrs["min_discharging_power"] = 0.5, 0.4
        buildings[f"Building_{charger_building[c] + 1}"].setdefault("chargers", {})[cid] = {
            "type": "citylearn.electric_vehicle_charger.Charger",
            "charger_simulation": f"{cid}.csv", "attributes": attrs}

    hour = cal["hour"]
    for w in range(n_washing_machines):
        name = f"washing_machine_{w + 1}"
        first = (np.arange(n_rows) // 24) * 24 + 17 + w % 3
        window = (hour >= 12) & (hour <= 22)
        profile = "[%s]" % ", ".join("%.6g" % x for x in np.round(rng.uniform(0.3, 1.5, 3), 2))
        _write_cells(os.path.join(root, f"{name}.csv"), {
            "wm_start_time_step": ["%d" % (s if on else -1) for s, on in zip(first, window)],
            "wm_end_time_step": ["%d" % (s + 3 if on else -1) for s, on in zip(first, window)],
            "load_profile": [f'"{profile}"' if on else "" for on in window]})
        buildings[f"Building_{(2 * w + 1) % n_buildings + 1}"].setdefault(
            "washing_machines", {})[name] = {
                "type": "citylearn.energy_model.WashingMachine",
                "washing_machine_energy_simulation": f"{name}.csv"}

    reward_attributes = {"weights": EV_REWARD_WEIGHTS}
    if constraints:
        on_first = [cid for cid in buildings["Building_1"]["chargers"]]
        buildings["Building_1"]["charging_constraints"] = {
            "building_limit_kw": 6.0,
            "phases": [{"name": f"L{i + 1}", "limit_kw": 4.0 + i, "chargers": [cid]}
                       for i, cid in enumerate(on_first)],
            "observations": {"phase_encoding": True, "headroom": True, "violation": True}}
        buildings["Building_3"]["charging_constraints"] = {"building_limit_kw": 3.0}
        reward_attributes["charging_constraint_penalty_coefficient"] = 2.0

    observations = OBSERVATIONS + CHARGER_OBSERVATIONS + WASHING_MACHINE_OBSERVATIONS
    actions = ACTIONS + ["electric_vehicle_storage", "washing_machine"]
    return _write_schema(
        root, n_rows, seed, observations,
        {"electrical_storage", "electric_vehicle_storage", "washing_machine"}, buildings,
        action_names=actions,
        reward_function={
            "type": "citylearn.reward_function.Electric_Vehicles_Reward_Function",
            "attributes": reward_attributes},
        extra={"electric_vehicles_def": electric_vehicles})


#: input channels of the LSTM temperature model, in the order of the
#: 2023 datasets' ``input_observation_names``
LSTM_INPUTS = [
    "direct_solar_irradiance", "diffuse_solar_irradiance", "outdoor_dry_bulb_temperature",
    "occupant_count", "cooling_demand", "month_sin", "month_cos", "hour_sin", "hour_cos",
    "day_type_sin", "day_type_cos", "indoor_dry_bulb_temperature",
]
LSTM_OBSERVATIONS = [
    "indoor_dry_bulb_temperature", "indoor_dry_bulb_temperature_cooling_set_point",
    "indoor_dry_bulb_temperature_cooling_delta", "cooling_demand", "dhw_demand",
    "occupant_count", "hvac_mode", "comfort_band", "power_outage", "dhw_storage_soc",
]
LSTM_ACTIONS = ACTIONS + ["cooling_device", "heating_device", "cooling_or_heating_device"]
#: normalization range of the indoor-temperature channel, in degrees C
LSTM_TEMPERATURE_RANGE = (15.0, 32.0)


def _write_lstm_weights(path: str, rng: np.random.RandomState, n_inputs: int,
                        hidden_size: int, num_layers: int):
    """One building's LSTM state dict, under the keys of
    ``torch.nn.LSTM`` (``l_lstm``) and its linear head (``l_linear``),
    drawn from ``rng``. The head's bias puts the prediction near the
    cooling set point and its weights spread it by a few degrees either
    way, so that predicted temperatures fall on both sides of every
    threshold of the comfort reward."""
    import torch

    k = 1.0 / np.sqrt(hidden_size)
    draw = lambda shape, scale=1.0: torch.from_numpy(
        rng.uniform(-k * scale, k * scale, shape).astype(np.float32))
    state = {}
    for layer in range(num_layers):
        width = n_inputs if layer == 0 else hidden_size
        state[f"l_lstm.weight_ih_l{layer}"] = draw((4 * hidden_size, width), 2.0)
        state[f"l_lstm.weight_hh_l{layer}"] = draw((4 * hidden_size, hidden_size))
        state[f"l_lstm.bias_ih_l{layer}"] = draw((4 * hidden_size,))
        state[f"l_lstm.bias_hh_l{layer}"] = draw((4 * hidden_size,))
    state["l_linear.weight"] = draw((1, hidden_size), 1.5)
    state["l_linear.bias"] = torch.tensor([float(np.round(rng.uniform(0.45, 0.6), 3))])
    torch.save(state, path)


def write_lstm_dataset(root: str, n_buildings: int = 3, n_rows: int = 8760, seed: int = 0,
                       hidden_size: int = 8, num_layers: int = 2, lookback: int = 12,
                       outage: bool = False, heterogeneous: bool = False,
                       stochastic_outage: bool = False) -> str:
    """Write an LSTM-dynamics district under ``root`` and return the path
    of its ``schema.json``. The same arguments always write the same files.

    Every building is an ``LSTMDynamicsBuilding``: a ``dynamics`` block
    names the ``.pth`` file of its LSTM (``num_layers`` layers of
    ``hidden_size`` units over a window of ``lookback`` steps of the 12
    channels :data:`LSTM_INPUTS`), whose predicted indoor temperature the
    ``ComfortReward`` reads. The cooling heat pump runs under the
    ``cooling_device`` action (partial load), DHW is an electric heater
    with a tank, and there is a battery and PV; there is no heating demand
    and no heating device or tank. ``hvac_mode`` is 1 (cooling) except on
    days of heating (2), automatic (3) and, for some hours, off (0).

    ``heterogeneous=True`` appends one building with a single layer of 50
    units and gives building 2 a cooling tank under the ``cooling_storage``
    action, which the others list as inactive. ``outage=True`` writes a
    ``power_outage`` column with events by day and by night, several of
    them inside the first 168 rows, and sets ``simulate_power_outage``;
    ``stochastic_outage=True`` names the seeded
    ``ReliabilityMetricsPowerOutage`` model instead of the column."""
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)
    h, season, temp = cal["h"], cal["season"], cal["temp"]
    day = np.arange(n_rows) // 24
    r2 = lambda lo, hi: float(np.round(rng.uniform(lo, hi), 2))
    shapes = [(hidden_size, num_layers)] * n_buildings + ([(50, 1)] if heterogeneous else [])
    tank_at = 1 if heterogeneous else None

    mode = np.ones(n_rows, np.int64)
    mode[day % 9 == 2] = 3
    mode[day % 9 == 4] = 2
    mode[(day % 9 == 6) & (h >= 8) & (h < 16)] = 0
    # set points step from day to day, so that the predicted temperature
    # falls in every interval the comfort reward tells apart
    cooling_sp = np.where((h >= 7) & (h < 22), 24.0, 25.0) \
        + np.array([0.0, -3.0, 2.0, -1.0, 0.0])[day % 5]
    heating_sp = 20.0 + np.array([0.0, 3.0, 5.0, 1.5, -1.0])[(day // 2) % 5]
    irradiance = {"direct_solar_irradiance": cal["direct"],
                  "diffuse_solar_irradiance": cal["diffuse"]}

    buildings = {}
    for b, (hidden, layers) in enumerate(shapes):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        afternoon = 0.4 + 0.6 * np.exp(-((h - 15) / 4.0) ** 2)
        cooling = np.clip((temp - 5) * rng.uniform(0.15, 0.3) * afternoon
                          + rng.normal(0, 0.1, n_rows), 0, None)
        dhw = np.clip(rng.uniform(0.3, 0.9) * (np.exp(-((h - 7) / 1.5) ** 2)
                                              + 0.7 * np.exp(-((h - 20) / 2.0) ** 2))
                      + rng.normal(0, 0.03, n_rows), 0, None)
        occupants = np.where((h >= 8) & (h < 17) & (cal["day_type"] <= 5), 1,
                             rng.randint(1, 4, n_rows)).astype(np.int64)
        indoor = 23.5 + 1.5 * season + rng.normal(0, 0.4, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "indoor_dry_bulb_temperature": indoor,
                  "non_shiftable_load": load, "dhw_demand": dhw, "cooling_demand": cooling,
                  "heating_demand": np.zeros(n_rows), "solar_generation": solar,
                  "occupant_count": occupants,
                  "indoor_dry_bulb_temperature_cooling_set_point": cooling_sp,
                  "indoor_dry_bulb_temperature_heating_set_point": heating_sp,
                  "hvac_mode": mode}
        if outage:
            # one event every fifth day alternating between midday and
            # night, plus three inside the first week
            signal = np.zeros(n_rows, np.int64)
            starts = [26 + b, 82 + 2 * b, 131 + b] + [
                d * 24 + (11 if d % 2 else 1) + b for d in range(9, n_rows // 24, 5)]
            for i, s in enumerate(starts):
                signal[s:s + 3 + (i + b) % 6] = 1
            energy["power_outage"] = signal[:n_rows]
        _write_csv(os.path.join(root, f"{name}.csv"), energy)

        _write_lstm_weights(os.path.join(root, f"{name}.pth"), np.random.RandomState(
            [seed, b, hidden, layers]), len(LSTM_INPUTS), hidden, layers)
        # the periodic channels' ranges over a whole period, whatever part
        # of it the rows cover: a channel with equal bounds divides by zero
        cooling_power = r2(1.5, 2.5)
        periodic = {k: np.arange(1, n + 1) / n
                    for k, n in (("month", 12), ("hour", 24), ("day_type", 7))}
        ranges = {"outdoor_dry_bulb_temperature": (temp.min(), temp.max()),
                  "occupant_count": (0.0, 3.0),
                  # the most the heat pump can deliver, at the largest COP
                  "cooling_demand": (0.0, 20.0 * cooling_power),
                  "indoor_dry_bulb_temperature": LSTM_TEMPERATURE_RANGE,
                  **{k: (0.0, v.max()) for k, v in irradiance.items()},
                  **{f"{k}_{fn.__name__}": (fn(2 * np.pi * v).min(), fn(2 * np.pi * v).max())
                     for k, v in periodic.items() for fn in (np.sin, np.cos)}}
        lo, hi = zip(*(ranges[k] for k in LSTM_INPUTS))
        g6 = lambda xs: [float("%.6g" % x) for x in xs]

        devices = _battery_and_pv(rng)
        devices["cooling_device"] = {
            "type": "citylearn.energy_model.HeatPump", "autosize": False,
            "attributes": {"nominal_power": cooling_power, "efficiency": r2(0.2, 0.3),
                           "target_cooling_temperature": r2(7.0, 10.0),
                           "target_heating_temperature": r2(45.0, 50.0)}}
        devices["dhw_device"] = {
            "type": "citylearn.energy_model.ElectricHeater", "autosize": False,
            "attributes": {"nominal_power": r2(2.0, 4.0), "efficiency": r2(0.9, 0.99)}}
        tank = lambda capacity: {
            "type": "citylearn.energy_model.StorageTank", "autosize": False,
            "attributes": {"capacity": capacity, "efficiency": r2(0.9, 0.98),
                           "loss_coefficient": float(np.round(rng.uniform(0.002, 0.008), 4)),
                           "initial_soc": r2(0.1, 0.6)}}
        devices["dhw_storage"] = tank(float(np.round(rng.uniform(1.5, 3.0) * dhw.max(), 2)))
        if b == tank_at:
            devices["cooling_storage"] = tank(
                float(np.round(rng.uniform(1.5, 3.0) * cooling.max(), 2)))
        entry = _building_entry(name, devices)
        entry["type"] = "citylearn.building.LSTMDynamicsBuilding"
        if heterogeneous and b != tank_at:
            entry["inactive_actions"] = ["cooling_storage"]
        entry["dynamics"] = {
            "type": "citylearn.dynamics.LSTMDynamics",
            "attributes": {"input_size": len(LSTM_INPUTS), "hidden_size": hidden,
                           "num_layers": layers, "dropout": 0.0, "lookback": lookback,
                           "filename": f"{name}.pth",
                           "input_normalization_minimum": g6(lo),
                           "input_normalization_maximum": g6(hi),
                           "input_observation_names": LSTM_INPUTS}}
        if outage or stochastic_outage:
            entry["power_outage"] = {"simulate_power_outage": True}
        if stochastic_outage:
            entry["power_outage"].update(
                stochastic_power_outage=True,
                stochastic_power_outage_model={
                    "type": "citylearn.power_outage.ReliabilityMetricsPowerOutage",
                    "attributes": {"random_seed": seed + b, "saifi": 150.0, "caidi": 240.0}})
        buildings[name] = entry

    observations = OBSERVATIONS + LSTM_OBSERVATIONS \
        + (["cooling_storage_soc"] if heterogeneous else [])
    actions = {"cooling_device", "dhw_storage", "electrical_storage"} \
        | ({"cooling_storage"} if heterogeneous else set())
    return _write_schema(
        root, n_rows, seed, observations, actions, buildings, action_names=LSTM_ACTIONS,
        reward_function={"type": "citylearn.reward_function.ComfortReward",
                         "attributes": {"band": 2.0, "lower_exponent": 2.0,
                                        "higher_exponent": 3.0}})


#: the hidden sizes of the neighborhood writer's LSTMs, by building
NEIGHBORHOOD_HIDDEN = (8, 16, 24, 32)
NEIGHBORHOOD_OBSERVATIONS = [
    "indoor_dry_bulb_temperature", "indoor_dry_bulb_temperature_cooling_set_point",
    "indoor_dry_bulb_temperature_heating_set_point", "cooling_demand", "heating_demand",
    "dhw_demand", "occupant_count", "hvac_mode", "comfort_band", "dhw_storage_soc",
]


def _write_occupant_parameters(path: str, rng: np.random.RandomState, n_rows: int, h):
    """One building's logistic interaction parameters: the probability
    ``1 / (1 + exp(-(a + b T)))`` of asking for a warmer or a cooler set
    point at indoor temperature T, strongest in the morning and the
    evening."""
    active = 0.5 + np.exp(-((h - 7) / 2.0) ** 2) + np.exp(-((h - 19) / 2.0) ** 2)
    b_inc = -rng.uniform(0.3, 0.5)
    b_dec = rng.uniform(0.3, 0.5)
    _write_csv(path, {
        "a_increase": -b_inc * 19.0 - 2.5 + active + rng.normal(0, 0.2, n_rows),
        "b_increase": np.full(n_rows, b_inc),
        "a_decrease": -b_dec * 26.0 - 2.5 + active + rng.normal(0, 0.2, n_rows),
        "b_decrease": np.full(n_rows, b_dec)})


def write_neighborhood_dataset(root: str, n_buildings: int = 100, n_rows: int = 8760,
                               seed: int = 0, quebec: bool = False) -> str:
    """Write a neighborhood district under ``root`` and return the path of
    its ``schema.json``. The same arguments always write the same files.

    The default is the shape of the EULP county neighborhoods
    (``ca_alameda_county_neighborhood`` as the JAX package's bench runs it):
    ``LSTMDynamicsBuilding``s whose LSTMs differ from building to building
    (hidden sizes :data:`NEIGHBORHOOD_HIDDEN` in turn, one or two layers, a
    shared lookback of 12; buildings read the cooling demand, the heating
    demand or both among their channels), a cooling and a heating heat pump
    (an electric heater in every fifth building) under the signed
    ``cooling_or_heating_device`` action, a DHW heater and tank, no cooling
    or heating tank, a battery under ``electrical_storage`` and PV, and the
    default ``RewardFunction``. ``hvac_mode`` is 1 in summer, 2 in winter
    and 3 between, with hours of 0.

    ``quebec=True`` writes the shape of the quebec neighborhoods instead
    (whose sets hold 20 buildings):
    ``n_buildings`` ``LogisticRegressionOccupantInteractionBuilding``s
    reading the heating demand, a heat pump under the ``heating_device``
    action, a DHW heater and tank, no battery and no PV, the
    ``ComfortReward``, and an occupant per building whose parameter file is
    written and whose two decision-tree files are not: the compiler then
    stands in an inert tree."""
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)
    h, season, temp = cal["h"], cal["season"], cal["temp"]
    day = np.arange(n_rows) // 24
    r2 = lambda lo, hi: float(np.round(rng.uniform(lo, hi), 2))

    # summer cools, winter heats, the seasons between do both
    mode = np.where(season > 0.3, 1, np.where(season < -0.3, 2, 3)).astype(np.int64)
    mode[(day % 11 == 5) & (h >= 9) & (h < 15)] = 0
    if quebec:
        mode = np.where(season > 0.6, 3, 2).astype(np.int64)
        mode[(day % 11 == 5) & (h >= 9) & (h < 15)] = 0
    cooling_sp = np.where((h >= 7) & (h < 22), 24.0, 26.0) \
        + np.array([0.0, -2.0, 1.0, -1.0, 0.0])[day % 5]
    heating_sp = np.where((h >= 7) & (h < 22), 21.0, 18.0) \
        + np.array([0.0, 2.0, -1.0, 1.0, 0.0])[(day // 2) % 5]
    irradiance = {"direct_solar_irradiance": cal["direct"],
                  "diffuse_solar_irradiance": cal["diffuse"]}

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        hidden = NEIGHBORHOOD_HIDDEN[(b // 3) % len(NEIGHBORHOOD_HIDDEN)]
        layers = 1 + b % 2
        demand_channels = (("heating_demand",) if quebec else
                           (("cooling_demand",), ("heating_demand",),
                            ("cooling_demand", "heating_demand"))[b % 3])
        inputs = [c for c in LSTM_INPUTS if c != "cooling_demand"]
        inputs[4:4] = list(demand_channels)
        load, solar = _load_and_solar(rng, cal, n_rows)
        afternoon = 0.4 + 0.6 * np.exp(-((h - 15) / 4.0) ** 2)
        cooling = np.clip((temp - 12) * rng.uniform(0.15, 0.3) * afternoon
                          + rng.normal(0, 0.1, n_rows), 0, None)
        heat = np.clip((16 - temp) * rng.uniform(0.2, 0.4) + rng.normal(0, 0.1, n_rows), 0, None)
        if quebec:
            cooling = np.zeros(n_rows)
        heat = heat * (cooling == 0)             # never both in one step
        dhw = np.clip(rng.uniform(0.3, 0.9) * (np.exp(-((h - 7) / 1.5) ** 2)
                                              + 0.7 * np.exp(-((h - 20) / 2.0) ** 2))
                      + rng.normal(0, 0.03, n_rows), 0, None)
        occupants = np.where((h >= 8) & (h < 17) & (cal["day_type"] <= 5), 1,
                             rng.randint(1, 4, n_rows)).astype(np.int64)
        indoor = 21.5 + 2.5 * season + rng.normal(0, 0.4, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "indoor_dry_bulb_temperature": indoor,
                  "non_shiftable_load": load, "dhw_demand": dhw, "cooling_demand": cooling,
                  "heating_demand": heat, "solar_generation": solar if not quebec
                  else np.zeros(n_rows),
                  "occupant_count": occupants,
                  "indoor_dry_bulb_temperature_cooling_set_point": cooling_sp,
                  "indoor_dry_bulb_temperature_heating_set_point": heating_sp,
                  "hvac_mode": mode}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)
        _write_lstm_weights(os.path.join(root, f"{name}.pth"), np.random.RandomState(
            [seed, b, hidden, layers]), len(inputs), hidden, layers)

        cooling_power, heating_power = r2(1.5, 2.5), r2(2.0, 4.0)
        periodic = {k: np.arange(1, n + 1) / n
                    for k, n in (("month", 12), ("hour", 24), ("day_type", 7))}
        # the demand channels' ranges: the most each heat pump can deliver,
        # at the largest COP
        ranges = {"outdoor_dry_bulb_temperature": (temp.min(), temp.max()),
                  "occupant_count": (0.0, 3.0),
                  "cooling_demand": (0.0, 20.0 * cooling_power),
                  "heating_demand": (0.0, 20.0 * heating_power),
                  "indoor_dry_bulb_temperature": LSTM_TEMPERATURE_RANGE,
                  **{k: (0.0, v.max()) for k, v in irradiance.items()},
                  **{f"{k}_{fn.__name__}": (fn(2 * np.pi * v).min(), fn(2 * np.pi * v).max())
                     for k, v in periodic.items() for fn in (np.sin, np.cos)}}
        lo, hi = zip(*(ranges[k] for k in inputs))
        g6 = lambda xs: [float("%.6g" % x) for x in xs]

        heat_pump = lambda power: {
            "type": "citylearn.energy_model.HeatPump", "autosize": False,
            "attributes": {"nominal_power": power, "efficiency": r2(0.2, 0.3),
                           "target_cooling_temperature": r2(7.0, 10.0),
                           "target_heating_temperature": r2(45.0, 50.0)}}
        heater = lambda power: {
            "type": "citylearn.energy_model.ElectricHeater", "autosize": False,
            "attributes": {"nominal_power": power, "efficiency": r2(0.9, 0.99)}}
        devices = {} if quebec else _battery_and_pv(rng)
        if not quebec:
            devices["cooling_device"] = heat_pump(cooling_power)
        devices["heating_device"] = (heater if b % 5 == 4 and not quebec
                                     else heat_pump)(heating_power)
        devices["dhw_device"] = heater(r2(2.0, 4.0))
        devices["dhw_storage"] = {
            "type": "citylearn.energy_model.StorageTank", "autosize": False,
            "attributes": {"capacity": float(np.round(rng.uniform(1.5, 3.0) * dhw.max(), 2)),
                           "efficiency": r2(0.9, 0.98),
                           "loss_coefficient": float(np.round(rng.uniform(0.002, 0.008), 4)),
                           "initial_soc": r2(0.3, 0.9)}}
        entry = _building_entry(name, devices)
        entry["type"] = ("citylearn.building.LogisticRegressionOccupantInteractionBuilding"
                         if quebec else "citylearn.building.LSTMDynamicsBuilding")
        entry["dynamics"] = {
            "type": "citylearn.dynamics.LSTMDynamics",
            "attributes": {"input_size": len(inputs), "hidden_size": hidden,
                           "num_layers": layers, "dropout": 0.0, "lookback": 12,
                           "filename": f"{name}.pth",
                           "input_normalization_minimum": g6(lo),
                           "input_normalization_maximum": g6(hi),
                           "input_observation_names": inputs}}
        if quebec:
            _write_occupant_parameters(os.path.join(root, f"{name}_occupant_parameters.csv"),
                                       rng, n_rows, h)
            entry["set_point_hold_time_steps"] = 4
            entry["occupant"] = {
                "type": "citylearn.occupant.LogisticRegressionOccupant",
                "parameters_filename": f"{name}_occupant_parameters.csv",
                "attributes": {"setpoint_increase_model_filename":
                               f"{name}_setpoint_increase.pkl",
                               "setpoint_decrease_model_filename":
                               f"{name}_setpoint_decrease.pkl",
                               "delta_output_map": {"0": 0.5, "1": 1.5}}}
        buildings[name] = entry

    if quebec:
        return _write_schema(
            root, n_rows, seed, OBSERVATIONS + NEIGHBORHOOD_OBSERVATIONS, {"heating_device"},
            buildings, action_names=LSTM_ACTIONS,
            reward_function={"type": "citylearn.reward_function.ComfortReward",
                             "attributes": {"band": 2.0}},
            extra={"central_agent": True})
    return _write_schema(root, n_rows, seed, OBSERVATIONS + NEIGHBORHOOD_OBSERVATIONS,
                         {"cooling_or_heating_device", "electrical_storage"}, buildings,
                         action_names=LSTM_ACTIONS)


def write_epw(path: str, seed: int = 0, latitude: float = 37.67, longitude: float = -122.12,
              timezone: float = -8.0, elevation: float = 10.0) -> str:
    """Write a seeded hourly EnergyPlus weather file (EPW) of one
    non-leap year to ``path`` and return it: the eight header records
    (``LOCATION`` with the site's latitude, longitude, time zone and
    elevation first), then 8760 data records of 35 fields, hour-ending
    1-24. Dry-bulb temperature (field 6), global horizontal (13), direct
    normal (14) and diffuse horizontal (15) irradiance follow the sun's
    elevation at the site under seeded cloud cover; wind speed (21) is
    seeded. The same arguments always write the same file."""
    rng = np.random.RandomState(seed)
    n = 8760
    t = np.arange(n)
    day, hour = t // 24, t % 24 + 1
    month_days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    month = np.repeat(np.arange(1, 13), month_days)[day]
    dom = day - np.concatenate(([0], np.cumsum(month_days)))[month - 1] + 1
    # the sun at mid-hour (declination and hour angle; no equation of time)
    decl = np.radians(23.45) * np.sin(2 * np.pi * (284 + day + 1) / 365)
    solar_time = hour - 0.5 + (longitude - 15.0 * timezone) / 15.0
    ha = np.radians(15.0 * (solar_time - 12.0))
    lat = np.radians(latitude)
    cos_zen = np.sin(lat) * np.sin(decl) + np.cos(lat) * np.cos(decl) * np.cos(ha)
    up = np.clip(cos_zen, 0.0, None)
    clear = np.repeat(rng.uniform(0.35, 1.0, n // 24), 24)            # daily cloud cover
    dni = np.round(900.0 * clear * up ** 0.3 * (up > 0.02))
    dhi = np.round((60.0 + 120.0 * (1.0 - clear)) * up ** 0.8 * (up > 0))
    ghi = np.round(dni * up + dhi)
    season = np.cos(2 * np.pi * (day - 200) / 365)
    temp = np.round(14.0 + 6.0 * season + 4.0 * np.sin(2 * np.pi * (hour - 9) / 24)
                    + rng.normal(0, 1.0, n), 1)
    dew = np.round(temp - rng.uniform(2.0, 8.0, n), 1)
    rh = np.clip(np.round(100.0 - 4.0 * (temp - dew)), 5, 100)
    wind = np.round(rng.gamma(2.0, 1.5, n), 1)
    header = [
        f"LOCATION,Synthetic,CA,USA,synthetic,000000,{latitude:.2f},{longitude:.2f},"
        f"{timezone:.1f},{elevation:.1f}",
        "DESIGN CONDITIONS,0", "TYPICAL/EXTREME PERIODS,0", "GROUND TEMPERATURES,0",
        "HOLIDAYS/DAYLIGHT SAVINGS,No,0,0,0", "COMMENTS 1,seeded synthetic weather",
        "COMMENTS 2,", "DATA PERIODS,1,1,Data,Sunday, 1/ 1,12/31"]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for i in range(n):
            fields = [2001, month[i], dom[i], hour[i], 60, "?9?9?9?9E0?9?9?9?9?9?9?9?9?9?9?9?9",
                      f"{temp[i]:.1f}", f"{dew[i]:.1f}", f"{rh[i]:.0f}", 101300, 0, 1415, 300,
                      f"{ghi[i]:.0f}", f"{dni[i]:.0f}", f"{dhi[i]:.0f}", 0, 0, 0, 0, 180,
                      f"{wind[i]:.1f}", 5, 5, 9999, 77777, 9, 999999999, 0, 0.1, 0, 88, 0.2,
                      0, 1]
            f.write(",".join(str(v) for v in fields) + "\n")
    return path


def write_battery_choices(directory: str, seed: int = 0, n_models: int = 8) -> str:
    """Write ``battery_choices.yaml`` under ``directory`` and return its
    path: ``n_models`` seeded manufacturer models in the reference's shape
    ``{model: {attributes: {capacity, nominal_power, depth_of_discharge,
    efficiency, loss_coefficient, capacity_loss_coefficient}}}``, in
    plain YAML text (no YAML library needed to write it). Nominal powers
    span 1-5 kW, so that a household's daily peak of 2-5 kW picks among
    several."""
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "battery_choices.yaml")
    with open(path, "w") as f:
        for m in range(n_models):
            attrs = {
                "capacity": round(float(rng.uniform(2.0, 16.0)), 1),
                "nominal_power": round(float(rng.uniform(1.0, 5.0)), 1),
                "depth_of_discharge": round(float(rng.uniform(0.8, 1.0)), 2),
                "efficiency": round(float(rng.uniform(0.88, 0.97)), 3),
                "loss_coefficient": round(float(rng.uniform(0.001, 0.009)), 4),
                "capacity_loss_coefficient": round(float(rng.uniform(1e-5, 1e-4)), 6),
            }
            f.write(f"Model_{m + 1}:\n  attributes:\n")
            for k, v in attrs.items():
                f.write(f"    {k}: {v:.6f}\n")
    return path
