"""Dataset-generation pipeline (reference
``citylearn/end_use_load_profiles/neighborhood.py``).

The reference pipeline is: sample EULP buildings -> EnergyPlus ideal +
partial-load simulations (via ``doe_xstock``/OpenStudio) -> KMeans
clustering -> LSTM dynamics training -> schema + CSV emission. EnergyPlus
and doe_xstock are external, offline dependencies; this module implements
every stage that does not require them (clustering, LSTM training on the
card, schema emission) and accepts pre-simulated time series where the
reference would call EnergyPlus.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Mapping, Optional

import numpy as np


class Neighborhood:
    def __init__(self, energyplus_available: bool = False):
        self.energyplus_available = energyplus_available

    # ------------------------------------------------------------------
    def cluster_buildings(self, load_profiles: np.ndarray, n_clusters: int,
                          seed: int = 0) -> np.ndarray:
        """KMeans clustering of candidate building load profiles
        (reference ``end_use_load_profiles/clustering.py:13``)."""
        from citylearn_tpu_torch.end_use_load_profiles.clustering import KMeans

        km = KMeans(n_clusters=n_clusters, random_state=seed, n_init=10)
        return km.fit_predict(np.asarray(load_profiles))

    def train_dynamics_model(self, features: np.ndarray, indoor_temperature:
                             np.ndarray, lookback: int = 12, **kwargs):
        """Train the LSTM temperature model from (pre-simulated) ideal +
        partial-load results (reference ``lstm_model/model_generation.py:9``);
        ``device=`` among ``kwargs`` (the card by default)."""
        from citylearn_tpu_torch.end_use_load_profiles.lstm import train_lstm

        return train_lstm(features, indoor_temperature, lookback=lookback,
                          **kwargs)

    def set_schema(self, output_directory: str, building_csvs: Mapping[str, str],
                   weather_csv: str, pricing_csv: Optional[str] = None,
                   carbon_csv: Optional[str] = None, seconds_per_time_step:
                   float = 3600.0, random_seed: int = 0,
                   simulation_end_time_step: Optional[int] = None,
                   template: Optional[dict] = None) -> str:
        """Emit a CityLearn-compatible ``schema.json`` for generated data
        (reference ``neighborhood.py:381``)."""
        with open(os.path.join(output_directory, next(iter(building_csvs.values()))),
                  newline="") as f:
            n_rows = sum(1 for _ in csv.reader(f)) - 1
        end = (n_rows - 1 if simulation_end_time_step is None
               else simulation_end_time_step)
        schema = template or {
            "random_seed": random_seed,
            "root_directory": None,
            "central_agent": False,
            "simulation_start_time_step": 0,
            "simulation_end_time_step": end,
            "episode_time_steps": None,
            "rolling_episode_split": False,
            "random_episode_split": False,
            "seconds_per_time_step": seconds_per_time_step,
            "observations": {k: {"active": True, "shared_in_central_agent": s}
                             for k, s in [("month", True), ("day_type", True),
                                          ("hour", True),
                                          ("outdoor_dry_bulb_temperature", True),
                                          ("non_shiftable_load", False),
                                          ("solar_generation", False),
                                          ("electrical_storage_soc", False),
                                          ("net_electricity_consumption", False),
                                          ("electricity_pricing", True),
                                          ("carbon_intensity", True)]},
            "actions": {"cooling_storage": {"active": False},
                        "heating_storage": {"active": False},
                        "dhw_storage": {"active": False},
                        "electrical_storage": {"active": True}},
            "agent": {"type": "citylearn_tpu.agents.rbc.BasicRBC",
                      "attributes": {}},
            "reward_function": {
                "type": "citylearn.reward_function.RewardFunction",
                "attributes": None},
            "buildings": {},
        }
        for name, path in building_csvs.items():
            schema["buildings"][name] = {
                "include": True,
                "energy_simulation": path,
                "weather": weather_csv,
                **({"pricing": pricing_csv} if pricing_csv else {}),
                **({"carbon_intensity": carbon_csv} if carbon_csv else {}),
                "inactive_observations": [],
                "inactive_actions": [],
                "electrical_storage": {
                    "type": "citylearn.energy_model.Battery",
                    "autosize": False,
                    "attributes": {"capacity": 6.4, "nominal_power": 5.0,
                                   "efficiency": 0.9, "loss_coefficient": 0.0,
                                   "capacity_loss_coefficient": 1e-5}},
                "pv": {"type": "citylearn.energy_model.PV", "autosize": False,
                       "attributes": {"nominal_power": 4.0}},
            }
        path = os.path.join(output_directory, "schema.json")
        with open(path, "w") as f:
            json.dump(schema, f, indent=2)
        return path

    def build(self, output_directory: str, simulator=None, **kwargs):
        """End-to-end dataset generation (reference ``neighborhood.py:149``):
        sample buildings -> ideal + stochastic partial-load simulations ->
        LSTM dynamics training -> dataset + schema emission -> CityLearn
        smoke test (``device=`` among ``kwargs``: the card by default).
        ``simulator`` is the EnergyPlus-stage backend
        (:class:`citylearn_tpu_torch.end_use_load_profiles.build.BuildingSimulator`);
        defaults to the synthetic RC-thermal backend when EnergyPlus is
        unavailable."""
        from citylearn_tpu_torch.end_use_load_profiles.build import RCSimulator, build

        if simulator is None:
            simulator = RCSimulator(
                random_seed=int(kwargs.get("random_seed", 0)))
        return build(simulator, output_directory, **kwargs)
