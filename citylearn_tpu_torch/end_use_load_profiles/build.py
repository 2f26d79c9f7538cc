"""End-to-end dataset-generation pipeline (reference
``citylearn/end_use_load_profiles/neighborhood.py:149`` ``Neighborhood.build``
+ ``simulate.py``), around an injectable building simulator.

The reference drives EnergyPlus through ``doe_xstock``, an external,
offline toolchain. Every surrounding stage is here with the reference's
semantics, on dicts of numpy columns:

- stochastic partial-load multipliers (``simulate.py:168-173``) and the
  single-load-per-timestep rule (``simulate.py:195-200``),
- predicted-weather expansion with shifted, noise-perturbed channels
  (``neighborhood.py:571-609``),
- elbow-criterion KMeans clustering (the numpy :class:`.clustering.KMeans`)
  + frequency-weighted building sampling (``clustering.py:13-120``,
  ``neighborhood.py:780-829``),
- LSTM dynamics training on the card (settings.yaml ``lstm.train.config``)
  and emission of CityLearn-compatible building CSVs, 16-channel weather
  CSV, torch-layout ``.pth`` weights and an ``LSTMDynamicsBuilding``
  schema,
- a simulation smoke test of the generated dataset in the port's
  ``CityLearnEnv``.

The EnergyPlus stage itself is a :class:`BuildingSimulator` protocol;
:class:`RCSimulator` is a synthetic 1R1C-thermal backend (for tests and
machines without EnergyPlus), and :class:`.energyplus.EnergyPlusSimulator`
drives a real EnergyPlus where one is installed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

import numpy as np

Table = Dict[str, np.ndarray]

# reference citylearn/misc/settings.yaml lstm.train.config
LSTM_CONFIG = dict(lookback=13, hidden=4, num_layers=2, epochs=144,
                   batch_size=168, lr=0.008)

LSTM_CHANNELS = [
    "direct_solar_irradiance", "diffuse_solar_irradiance",
    "outdoor_dry_bulb_temperature",
    "indoor_dry_bulb_temperature_cooling_set_point", "occupant_count",
    "cooling_demand", "month_sin", "month_cos", "hour_sin", "hour_cos",
    "day_type_sin", "day_type_cos", "indoor_dry_bulb_temperature",
]


def write_table(path: str, table: Table):
    """Write ``table`` as a CSV with a header, its columns in order: ints
    as integers, floats by their shortest round-trip text in their own
    dtype (what pandas' ``to_csv`` writes), so that a reader gets the
    same values back."""
    names = list(table)
    cols = []
    for k in names:
        v = np.asarray(table[k])
        cols.append([str(int(x)) for x in v] if np.issubdtype(v.dtype, np.integer)
                    else [str(x) for x in v])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in zip(*cols):
            f.write(",".join(row) + "\n")


# ----------------------------------------------------------------------
# stage primitives (reference semantics)
# ----------------------------------------------------------------------

def get_multipliers(size: int, random_seed: int = 0, minimum: float = 0.3,
                    maximum: float = 1.7, probability: float = 0.6) -> np.ndarray:
    """Stochastic partial-load multipliers (``simulate.py:168-173``):
    U(min, max) per step, reset to 1.0 with probability 1 - p."""
    nprs = np.random.RandomState(random_seed)
    data = nprs.uniform(minimum, maximum, size)
    data[nprs.random(size) > probability] = 1.0
    return data


def single_load_per_time_step(cooling: np.ndarray, heating: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference zeroes the smaller of simultaneous loads
    (``simulate.py:195-200``, ``allow_multi_load_time_step=False``)."""
    cooling = np.asarray(cooling, float).copy()
    heating = np.asarray(heating, float).copy()
    heating[cooling > heating] = 0.0
    cooling[heating > cooling] = 0.0
    return cooling, heating


def expand_weather(weather: Table, shifts: Tuple[int, int, int] = (6, 12, 24),
                   accuracy: Mapping[str, Tuple[float, float, float]] = None,
                   random_seed: int = 0) -> Table:
    """Add the ``_predicted_{1,2,3}`` forecast channels
    (``neighborhood.py:571-609``): roll by -shift, additive noise for
    temperature, multiplicative for the other channels, reference clips.
    Every column comes back float32."""
    data = dict(weather)
    columns = list(data)
    accuracy = accuracy or {
        c: ((0.3, 0.65, 1.35) if c == "outdoor_dry_bulb_temperature"
            else (0.025, 0.05, 0.1)) for c in columns}
    for c in columns:
        for i, (s, a) in enumerate(zip(shifts, accuracy[c])):
            arr = np.roll(np.asarray(data[c]), shift=-s)
            nprs = np.random.RandomState(random_seed)
            col = f"{c}_predicted_{i + 1}"
            if c == "outdoor_dry_bulb_temperature":
                data[col] = arr + nprs.uniform(-a, a, len(arr))
            else:
                data[col] = np.clip(arr + arr * nprs.uniform(-a, a, len(arr)), 0.0, None)
                if c == "outdoor_relative_humidity":
                    data[col] = np.clip(data[col], None, 100.0)
    return {k: np.asarray(v).astype(np.float32) for k, v in data.items()}


def optimal_clusters(profiles: np.ndarray, maximum_clusters: int = None,
                     sse_minimum_percent_change: float = 10.0,
                     random_seed: int = 0) -> Tuple[int, Table, np.ndarray]:
    """Elbow-criterion KMeans (``clustering.py:59-120``): MinMax-scale,
    fit k = 2..max, pick the first k whose SSE improvement drops below
    ``sse_minimum_percent_change`` percent. Returns ``(k, scores, labels)``
    with ``scores`` the columns ``clusters`` and ``sum_of_square_error``."""
    from citylearn_tpu_torch.end_use_load_profiles.clustering import KMeans

    X = np.asarray(profiles, float)
    lo, hi = X.min(axis=0), X.max(axis=0)
    X = (X - lo) / np.where(hi > lo, hi - lo, 1.0)
    maximum_clusters = (math.ceil(len(X) / 2) if maximum_clusters is None
                        else maximum_clusters)
    ks, sse, labels = [], [], {}
    for k in range(2, maximum_clusters + 1):
        km = KMeans(n_clusters=k, random_state=random_seed, n_init=10).fit(X)
        ks.append(k)
        sse.append(km.inertia_)
        labels[k] = km.labels_
    best, prev = ks[0], sse[0]
    for k, e in zip(ks[1:], sse[1:]):
        change = (prev - e) / max(prev, 1e-12) * 100.0
        if change < sse_minimum_percent_change:
            break
        best, prev = k, e
    scores = {"clusters": np.asarray(ks), "sum_of_square_error": np.asarray(sse)}
    return int(best), scores, labels[int(best)]


def sample_buildings(profiles: np.ndarray, bldg_ids: Sequence[int],
                     sample_count: int = 100, cluster: bool = True,
                     random_seed: int = 0) -> Tuple[List[int], List[int], dict]:
    """Frequency-weighted sampling with replacement
    (``neighborhood.py:780-829``): cluster (optionally), weight each
    building by its cluster size, sample ``sample_count`` ids. pandas'
    ``sample(weights=..., replace=True, random_state=seed)`` is the same
    ``RandomState(seed).choice`` over the normalized weights."""
    ids = list(bldg_ids)
    sample_metadata = None
    if cluster and len(ids) > 3:
        k, scores, labels = optimal_clusters(profiles, random_seed=random_seed)
        sample_metadata = {"optimal_clusters": k, "scores": scores, "labels": labels}
        labels = np.asarray(labels)
    else:
        labels = np.zeros(len(ids), np.int64)
    counts = np.array([(labels == lab).sum() for lab in labels], np.float64)
    picked = np.random.RandomState(random_seed).choice(
        len(ids), size=sample_count, replace=True, p=counts / counts.sum())
    return ([ids[i] for i in picked], [labels[i].item() for i in picked],
            sample_metadata)


# ----------------------------------------------------------------------
# simulator protocol + synthetic backend
# ----------------------------------------------------------------------

class BuildingSimulator(Protocol):
    """The EnergyPlus-stage contract. ``simulate_ideal`` returns the
    hourly ideal-loads run; ``simulate_partial`` re-runs with prescribed
    HVAC energy (the reference's OtherEquipment injection,
    ``simulate.py:106-166``) and returns the resulting free-response.
    Frames are dicts of numpy columns."""

    def weather(self, n_time_steps: int) -> Table: ...

    def simulate_ideal(self, bldg_id: int, n_time_steps: int) -> Table: ...

    def simulate_partial(self, bldg_id: int, cooling_kwh: np.ndarray,
                         heating_kwh: np.ndarray) -> Table: ...


@dataclasses.dataclass
class RCSimulator:
    """Synthetic 1R1C thermal backend: a first-order RC zone driven by a
    seeded synthetic year. Stands in for EnergyPlus where the binary is
    unavailable; the pipeline treats it exactly like the real backend."""

    random_seed: int = 0
    setpoint: float = 23.9

    def _params(self, bldg_id: int):
        rs = np.random.RandomState(self.random_seed * 100003 + bldg_id)
        return dict(
            R=rs.uniform(2.0, 6.0),          # K/kW
            C=rs.uniform(2.0, 8.0),          # kWh/K
            solar_gain=rs.uniform(0.002, 0.01),   # K gain per W/m^2 / C
            base_load=rs.uniform(0.2, 0.8),  # kWh non-shiftable baseline
            occupants=rs.randint(1, 5),
        )

    def weather(self, n_time_steps: int) -> Table:
        rs = np.random.RandomState(self.random_seed + 7919)
        t = np.arange(n_time_steps)
        hour = t % 24
        day = t // 24
        season = 10.0 * np.sin(2 * np.pi * (day - 80) / 365.0)
        diurnal = 6.0 * np.sin(2 * np.pi * (hour - 9) / 24.0)
        temp = 18.0 + season + diurnal + rs.normal(0, 1.0, n_time_steps)
        elev = np.clip(np.sin(2 * np.pi * (hour - 6) / 24.0), 0, None)
        direct = 900.0 * elev ** 1.5 * rs.uniform(0.6, 1.0, n_time_steps)
        diffuse = 250.0 * elev * rs.uniform(0.7, 1.0, n_time_steps)
        rh = np.clip(70 - (temp - 18.0) * 2 + rs.normal(0, 5, n_time_steps), 10, 100)
        return {
            "outdoor_dry_bulb_temperature": temp.astype(np.float32),
            "outdoor_relative_humidity": rh.astype(np.float32),
            "diffuse_solar_irradiance": diffuse.astype(np.float32),
            "direct_solar_irradiance": direct.astype(np.float32),
        }

    def _frame(self, n, temps, cooling, p, w) -> Table:
        t = np.arange(n)
        hour = t % 24 + 1
        day = t // 24
        occ = ((hour < 9) | (hour > 17)).astype(float) * p["occupants"]
        return {
            "month": np.minimum(day // 30 + 1, 12).astype(np.int32),
            "hour": hour.astype(np.int32),
            "day_type": (day % 7 + 1).astype(np.int32),
            "indoor_dry_bulb_temperature": np.asarray(temps, np.float32),
            "non_shiftable_load": (p["base_load"]
                                   * (1 + 0.5 * occ / max(p["occupants"], 1))
                                   ).astype(np.float32),
            "dhw_demand": np.zeros(n, np.float32),
            "cooling_demand": np.asarray(cooling, np.float32),
            "heating_demand": np.zeros(n, np.float32),
            "solar_generation": (w["direct_solar_irradiance"] * 0.9).astype(np.float32),
            "occupant_count": occ.astype(np.float32),
            "indoor_dry_bulb_temperature_cooling_set_point":
                np.full(n, self.setpoint, np.float32),
            "indoor_dry_bulb_temperature_heating_set_point":
                np.full(n, 15.0, np.float32),
            "hvac_mode": np.ones(n, np.int32),
            "comfort_band": np.full(n, 2.0, np.float32),
        }

    def simulate_ideal(self, bldg_id: int, n_time_steps: int) -> Table:
        p = self._params(bldg_id)
        w = self.weather(n_time_steps)
        out_t = w["outdoor_dry_bulb_temperature"]
        irr = w["direct_solar_irradiance"]
        n = n_time_steps
        T = np.empty(n)
        cooling = np.zeros(n)
        T[0] = self.setpoint
        cop = 3.0
        for t in range(n - 1):
            free = T[t] + ((out_t[t] - T[t]) / p["R"]
                           + p["solar_gain"] * irr[t] * p["R"]) / p["C"]
            if free > self.setpoint:
                cooling[t + 1] = (free - self.setpoint) * p["C"] / cop
                T[t + 1] = self.setpoint
            else:
                T[t + 1] = free
        return self._frame(n, T, cooling * cop, p, w)

    def simulate_partial(self, bldg_id: int, cooling_kwh: np.ndarray,
                         heating_kwh: np.ndarray) -> Table:
        p = self._params(bldg_id)
        n = len(cooling_kwh)
        w = self.weather(n)
        out_t = w["outdoor_dry_bulb_temperature"]
        irr = w["direct_solar_irradiance"]
        T = np.empty(n)
        T[0] = self.setpoint
        for t in range(n - 1):
            T[t + 1] = T[t] + ((out_t[t] - T[t]) / p["R"]
                               + p["solar_gain"] * irr[t] * p["R"]
                               - cooling_kwh[t] + heating_kwh[t]) / p["C"]
        return self._frame(n, T, cooling_kwh, p, w)


# ----------------------------------------------------------------------
# the build pipeline
# ----------------------------------------------------------------------

def _lstm_features(frame: Table, weather: Table) -> np.ndarray:
    col = lambda table, k: np.asarray(table[k], float)
    month, hour, day = col(frame, "month"), col(frame, "hour"), col(frame, "day_type")
    cols = {
        "direct_solar_irradiance": col(weather, "direct_solar_irradiance"),
        "diffuse_solar_irradiance": col(weather, "diffuse_solar_irradiance"),
        "outdoor_dry_bulb_temperature": col(weather, "outdoor_dry_bulb_temperature"),
        "indoor_dry_bulb_temperature_cooling_set_point":
            col(frame, "indoor_dry_bulb_temperature_cooling_set_point"),
        "occupant_count": col(frame, "occupant_count"),
        "cooling_demand": col(frame, "cooling_demand"),
        "month_sin": np.sin(2 * np.pi * month / 12),
        "month_cos": np.cos(2 * np.pi * month / 12),
        "hour_sin": np.sin(2 * np.pi * hour / 24),
        "hour_cos": np.cos(2 * np.pi * hour / 24),
        "day_type_sin": np.sin(2 * np.pi * day / 7),
        "day_type_cos": np.cos(2 * np.pi * day / 7),
        "indoor_dry_bulb_temperature": col(frame, "indoor_dry_bulb_temperature"),
    }
    return np.stack([cols[c] for c in LSTM_CHANNELS], axis=1)


@dataclasses.dataclass
class NeighborhoodBuild:
    schema_filepath: str
    bldg_ids: List[int]
    sample_cluster_labels: Optional[List[int]]
    lstm_models: Optional[List[dict]]
    #: the smoke run's ``CityLearnEnv.evaluate_rows()``
    citylearn_simulation_test_evaluation: Optional[List[dict]]


def build(simulator: BuildingSimulator, output_directory: str,
          bldg_ids: Optional[Sequence[int]] = None,
          candidate_ids: Optional[Sequence[int]] = None,
          sample_count: int = 3, n_time_steps: int = 720,
          partial_loads_simulations: int = 2,
          include_lstm_models: bool = True,
          test_citylearn_simulation: bool = True,
          lstm_kwargs: Optional[dict] = None,
          random_seed: int = 0, device=None) -> NeighborhoodBuild:
    """The reference ``Neighborhood.build`` flow (``neighborhood.py:149``):
    sample -> simulate ideal + stochastic partial loads -> train LSTMs ->
    emit dataset (CSVs + .pth + schema) -> smoke-test in ``CityLearnEnv``.
    The LSTMs train and the smoke test runs on ``device`` (the card by
    default)."""
    import torch

    from citylearn_tpu_torch import resolve_device
    from citylearn_tpu_torch.end_use_load_profiles.lstm import train_lstm

    device = resolve_device(device)
    os.makedirs(output_directory, exist_ok=True)
    labels = None
    if bldg_ids is None:
        candidate_ids = list(candidate_ids
                             if candidate_ids is not None else range(8))
        profiles = np.stack([
            simulator.simulate_ideal(i, min(n_time_steps, 168))["cooling_demand"]
            for i in candidate_ids])
        bldg_ids, labels, _ = sample_buildings(
            profiles, candidate_ids, sample_count=sample_count,
            random_seed=random_seed)

    weather = expand_weather(simulator.weather(n_time_steps),
                             random_seed=random_seed)
    write_table(os.path.join(output_directory, "weather.csv"), weather)

    lstm_cfg = {**LSTM_CONFIG, **(lstm_kwargs or {})}
    lookback = lstm_cfg.pop("lookback")
    lstm_models = [] if include_lstm_models else None
    buildings_schema: Dict[str, dict] = {}

    for i, bldg_id in enumerate(bldg_ids):
        name = f"Building_{i + 1}"
        ideal = simulator.simulate_ideal(bldg_id, n_time_steps)
        write_table(os.path.join(output_directory, f"{name}.csv"), ideal)

        block = {
            "include": True,
            "type": "citylearn.citylearn.Building",
            "energy_simulation": f"{name}.csv",
            "weather": "weather.csv",
            "inactive_observations": [], "inactive_actions": [],
            "cooling_device": {
                "type": "citylearn.energy_model.HeatPump", "autosize": False,
                "attributes": {"nominal_power":
                               float(np.max(ideal["cooling_demand"])) / 2.0 + 1.0,
                               "efficiency": 0.25,
                               "target_cooling_temperature": 8.0}},
            "electrical_storage": {
                "type": "citylearn.energy_model.Battery", "autosize": False,
                "attributes": {"capacity": 6.4, "nominal_power": 5.0,
                               "efficiency": 0.9, "loss_coefficient": 0.0,
                               "capacity_loss_coefficient": 1e-5}},
            "pv": {"type": "citylearn.energy_model.PV", "autosize": False,
                   "attributes": {"nominal_power": 4.0}},
        }

        if include_lstm_models:
            # stochastic partial-load references (simulate.py:106-173)
            frames = []
            for j in range(partial_loads_simulations):
                mult = get_multipliers(n_time_steps,
                                       random_seed=random_seed * 1000 + i * 10 + j)
                cool, heat = single_load_per_time_step(
                    np.asarray(ideal["cooling_demand"]) * mult,
                    np.asarray(ideal["heating_demand"]) * mult)
                frames.append(simulator.simulate_partial(bldg_id, cool, heat))
            per_frame = [_lstm_features(f, weather) for f in frames]
            all_feats = np.concatenate(per_frame)
            lo, hi = all_feats.min(axis=0), all_feats.max(axis=0)
            hi = np.where(hi > lo, hi, lo + 1.0)
            # per-segment normalized features + next-step-temperature
            # targets (the temp channel is last in LSTM_CHANNELS); windows
            # are built within each partial-load run so nothing spans the
            # boundary between independent simulations
            seg_feats, seg_targets = [], []
            for f in per_frame:
                norm = (f - lo) / (hi - lo)
                seg_feats.append(norm[:-1])
                seg_targets.append(norm[1:, -1])
            state = train_lstm(seg_feats, seg_targets, lookback=lookback,
                               seed=random_seed, device=device, **lstm_cfg)
            pth = os.path.join(output_directory, f"{name}.pth")
            torch.save({k: torch.tensor(v) for k, v in state.items()}, pth)
            lstm_models.append(state)
            block["type"] = "citylearn.citylearn.LSTMDynamicsBuilding"
            block["dynamics"] = {
                "type": "citylearn.dynamics.LSTMDynamics",
                "attributes": {
                    "input_size": len(LSTM_CHANNELS),
                    "hidden_size": lstm_cfg.get("hidden", 4),
                    "num_layers": lstm_cfg.get("num_layers", 2),
                    "lookback": lookback,
                    "filename": f"{name}.pth",
                    "input_normalization_minimum": [float(x) for x in lo],
                    "input_normalization_maximum": [float(x) for x in hi],
                    "input_observation_names": list(LSTM_CHANNELS),
                }}
        buildings_schema[name] = block

    schema = {
        "random_seed": random_seed,
        "root_directory": output_directory,
        "central_agent": False,
        "simulation_start_time_step": 0,
        "simulation_end_time_step": n_time_steps - 1,
        "episode_time_steps": None,
        "rolling_episode_split": False, "random_episode_split": False,
        "seconds_per_time_step": 3600,
        "observations": {k: {"active": True, "shared_in_central_agent": s}
                         for k, s in [
                             ("month", True), ("day_type", True), ("hour", True),
                             ("outdoor_dry_bulb_temperature", True),
                             ("indoor_dry_bulb_temperature", False),
                             ("non_shiftable_load", False),
                             ("solar_generation", False),
                             ("electrical_storage_soc", False),
                             ("net_electricity_consumption", False),
                             ("cooling_demand", False),
                             ("occupant_count", False)]},
        "actions": {"cooling_storage": {"active": False},
                    "heating_storage": {"active": False},
                    "dhw_storage": {"active": False},
                    "electrical_storage": {"active": True},
                    "cooling_device": {"active": include_lstm_models}},
        "agent": {"type": "citylearn.agents.rbc.BasicRBC", "attributes": {}},
        "reward_function": {"type": "citylearn.reward_function.RewardFunction",
                            "attributes": None},
        "buildings": buildings_schema,
    }
    schema_filepath = os.path.join(output_directory, "schema.json")
    with open(schema_filepath, "w") as f:
        json.dump(schema, f, indent=2)

    evaluation = None
    if test_citylearn_simulation:
        from citylearn_tpu_torch.envs.environment import CityLearnEnv

        env = CityLearnEnv(schema_filepath, episode_time_steps=min(48, n_time_steps),
                           device=device)
        env.reset()
        while not env.terminated:
            env.step([[0.0] * s.shape[0] for s in env.action_space])
        evaluation = env.evaluate_rows()

    return NeighborhoodBuild(
        schema_filepath=schema_filepath, bldg_ids=list(bldg_ids),
        sample_cluster_labels=labels, lstm_models=lstm_models,
        citylearn_simulation_test_evaluation=evaluation)
