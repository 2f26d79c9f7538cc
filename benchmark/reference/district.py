"""A battery+PV district read straight from its ``schema.json`` and CSVs:
the series, the battery parameters, the action bounds and the trainer's
encoded observation table.

Semantics are CityLearn's (``citylearn/building.py``, ``energy_model.py``,
``rlc.py``'s encoders) as the synthetic battery+PV district uses them: one
``electrical_storage`` action a building, explicit battery attributes and
curves, a PV array of explicit nominal power and hourly rows.
"""

from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

PERIODIC = {"month": 12.0, "hour": 24.0}
ONEHOT = {"day_type": (1, 2, 3, 4, 5, 6, 7, 8), "daylight_savings_status": (0, 1)}
# observations whose value in the trainer's data-driven row is 0 (state,
# not data), and the one the trainer's encoder drops
STATE_OBSERVATIONS = {"electrical_storage_soc", "net_electricity_consumption"}
REMOVED = {"net_electricity_consumption"}
UNIT_BOUNDS = {"electrical_storage_soc"}


def read_csv(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        rows = list(csv.reader(f))
    return {name: np.array([float(r[i]) for r in rows[1:]])
            for i, name in enumerate(rows[0])}


@dataclass
class Building:
    name: str
    data: Dict[str, np.ndarray]      # every column the building reads, float64
    capacity: float
    nominal_power: float
    efficiency: float
    loss_coefficient: float
    initial_soc: float
    depth_of_discharge: float
    capacity_loss_coefficient: float
    pec: np.ndarray                  # (n, 2) power efficiency curve knots
    cpc: np.ndarray                  # (n, 2) capacity power curve knots
    pv_nominal_power: float


@dataclass
class District:
    buildings: List[Building]
    observations: List[str]          # active, in the schema's order
    start: int
    end: int
    seconds_per_time_step: float

    @property
    def n_rows(self) -> int:
        return self.end - self.start + 1


def load(schema_path: str) -> District:
    root = os.path.dirname(schema_path)
    with open(schema_path) as f:
        schema = json.load(f)
    observations = [k for k, v in schema["observations"].items() if v["active"]]
    start, end = schema["simulation_start_time_step"], schema["simulation_end_time_step"]
    buildings = []
    for name, entry in schema["buildings"].items():
        if not entry.get("include", True):
            continue
        data = {}
        for key in ("energy_simulation", "weather", "carbon_intensity", "pricing"):
            data.update(read_csv(os.path.join(root, entry[key])))
        attrs = entry["electrical_storage"]["attributes"]
        buildings.append(Building(
            name=name, data=data, capacity=float(attrs["capacity"]),
            nominal_power=float(attrs["nominal_power"]), efficiency=float(attrs["efficiency"]),
            loss_coefficient=float(attrs["loss_coefficient"]),
            initial_soc=float(attrs["initial_soc"]),
            depth_of_discharge=float(attrs.get("depth_of_discharge", 1.0)),
            capacity_loss_coefficient=float(attrs["capacity_loss_coefficient"]),
            pec=np.asarray(attrs["power_efficiency_curve"], np.float64),
            cpc=np.asarray(attrs["capacity_power_curve"], np.float64),
            pv_nominal_power=float(entry["pv"]["attributes"]["nominal_power"])))
    return District(buildings, observations, start, end, float(schema["seconds_per_time_step"]))


def series(b: Building, name: str, start: int, end: int) -> np.ndarray:
    """Observation or physics input ``name`` over the simulation rows, float64:
    PV output is the CSV's W per kW times the nominal power."""
    if name == "solar_generation":
        return np.abs(b.pv_nominal_power * b.data["solar_generation"][start:end + 1] / 1000.0)
    if name in STATE_OBSERVATIONS:
        return np.zeros(end - start + 1)
    return b.data[name][start:end + 1]


def encoded_width(observations: List[str]) -> int:
    n = 0
    for name in observations:
        if name in REMOVED:
            continue
        n += 2 if name in PERIODIC else len(ONEHOT[name]) if name in ONEHOT else 1
    return n


def observation_table(d: District, device) -> torch.Tensor:
    """(T, B * K) float32: every building's encoded observation row at each
    simulation row, buildings side by side, as the trainer's policy reads
    it (periodic sin and cos, one-hot day type, min-max over the simulation
    rows; state observations read 0)."""
    cols = []
    for b in d.buildings:
        for name in d.observations:
            if name in REMOVED:
                continue
            x = torch.tensor(series(b, name, d.start, d.end), dtype=torch.float32, device=device)
            if name in PERIODIC:
                ang = 2 * math.pi * x / PERIODIC[name]
                cols += [torch.sin(ang), torch.cos(ang)]
            elif name in ONEHOT:
                cols += [(x == c).float() for c in ONEHOT[name]]
            else:
                if name in UNIT_BOUNDS:
                    lo, hi = 0.0, 1.0
                else:
                    raw = series(b, name, d.start, d.end)
                    lo, hi = float(raw.min()), float(raw.max())
                lo32, hi32 = np.float32(lo), np.float32(hi)
                cols.append(torch.zeros_like(x) if lo32 == hi32
                            else (x - float(lo32)) / (float(hi32) - float(lo32)))
    return torch.stack(cols, 1)


def physics_series(d: District, device):
    """(T, B) float32 non-shiftable load and PV output."""
    f = lambda name: torch.tensor(np.stack([series(b, name, d.start, d.end)
                                            for b in d.buildings], 1),
                                  dtype=torch.float32, device=device)
    return f("non_shiftable_load"), f("solar_generation")
