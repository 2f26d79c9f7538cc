"""Frozen copy of the port's seeded dataset writers: the battery+PV
district (``citylearn_challenge_2022_phase_1``'s shape) and the
LSTM-dynamics district (``citylearn_challenge_2023_phase_1``'s shape).

Copied unchanged from ``citylearn_tpu_torch/synthetic.py`` at commit
9d3dc9dcb87c1d4e04504b157550827e94518679 (the 15-minute relabelling of
``minutes=True`` left out), so that the benchmark's inputs stay the same
whatever later changes make to the program's writers.
``benchmark/tests/test_benchmark_frozen.py`` holds the copy byte-equal to
the program's writers at a small size.
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


