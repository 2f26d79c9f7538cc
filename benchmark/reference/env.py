"""One episode of CityLearn's Gym env on a battery+PV district, worked out
from the dataset files and the actions: every step's observations and
rewards, and the energy KPIs of ``evaluate`` at the episode's end.

Semantics are CityLearn's (``citylearn/citylearn.py``, ``building.py``,
``reward_function.py``, ``cost_function.py``) as the port keeps them for
this district: an episode starts at the first simulation row and takes
``T - 1`` steps; an observation reads the data row of the current step,
where a state observation (the battery's SOC, the net consumption) still
holds its value from reset, except at reset itself (the initial SOC, and
the load less PV); the first step counts the load three times and the
battery's balance twice; the reward is ``-max(net, 0)``; the KPIs compare
the control against the same district without storage, the district's
control series one row shorter than the baseline's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import battery as battery_model
from benchmark.reference import district as district_model

BUILDING_KPIS = ("electricity_consumption_total", "zero_net_energy", "carbon_emissions_total",
                 "cost_total")
DISTRICT_KPIS = ("ramping_average", "daily_one_minus_load_factor_average",
                 "monthly_one_minus_load_factor_average", "daily_peak_average",
                 "all_time_peak_average")


def observations(d: district_model.District) -> np.ndarray:
    """(T, B, K) raw observations at each row of an episode, float32 values."""
    out = np.zeros((d.n_rows, len(d.buildings), len(d.observations)), np.float32)
    for bi, b in enumerate(d.buildings):
        for k, name in enumerate(d.observations):
            out[:, bi, k] = district_model.series(b, name, d.start, d.end)
        nsl = b.data["non_shiftable_load"][d.start]
        pv = b.pv_nominal_power * b.data["solar_generation"][d.start] / 1000.0
        at_reset = {"electrical_storage_soc": b.initial_soc, "net_electricity_consumption": nsl - pv}
        for k, name in enumerate(d.observations):
            if name in at_reset:
                out[0, bi, k] = at_reset[name]
    return out


def episode(d: district_model.District, actions: np.ndarray, dtype=torch.float32,
            fault: str = None) -> Dict[str, np.ndarray]:
    """Run one episode under ``actions`` (T - 1, B) on the CPU in ``dtype``.
    Returns the rewards (T - 1, B) and the env's history rows (T, B) of
    net consumption, battery consumption, PV, cost and emission, the last
    row unwritten (zeros)."""
    T, B = d.n_rows, len(d.buildings)
    S = T - 1
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), dtype=dtype)
    nsl, solar = (f(x.cpu().numpy()) for x in district_model.physics_series(d, "cpu"))
    price = f(np.stack([b.data["electricity_pricing"][d.start:d.end + 1] for b in d.buildings], 1))
    carbon = f(np.stack([b.data["carbon_intensity"][d.start:d.end + 1] for b in d.buildings], 1))
    bat = battery_model.Batteries.of(d.buildings, "cpu", dtype)
    hours = d.seconds_per_time_step / 3600.0
    soc, eff, deg = bat.initial_soc[None], bat.efficiency[None], bat.capacity[None]
    acts = f(actions)
    hist = {k: torch.zeros((T, B), dtype=dtype) for k in ("net", "battery", "solar", "cost", "emission")}
    rewards = torch.zeros((S, B), dtype=dtype)
    for t in range(S):
        energy = acts[t][None] * bat.nominal_power * hours
        new = battery_model.charge(bat, soc, eff, deg, energy)
        if fault != "frozen_state":
            soc, eff, deg = new[:3]
        balance = new[3][0]
        first = 3.0 if t == 0 else 1.0
        stored = balance * (2.0 if t == 0 else 1.0)
        net = first * nsl[t] + stored - solar[t]
        hist["net"][t], hist["battery"][t], hist["solar"][t] = net, stored, -solar[t]
        hist["cost"][t] = net * price[t]
        hist["emission"][t] = torch.clamp(net * carbon[t], min=0.0)
        rewards[t] = -torch.clamp(net, min=0.0)
    if fault == "altered_answer":
        rewards[:, 0] = -rewards[:, 0]
    out = {k: v.double().numpy() for k, v in hist.items()}
    out.update(rewards=rewards.double().numpy(), price=price.double().numpy(),
               carbon=carbon.double().numpy())
    return out


def _div(control: float, baseline: float):
    if not np.isfinite(control):
        control = 0.0
    if not np.isfinite(baseline):
        baseline = 0.0
    if baseline == 0.0:
        return 1.0 if control == 0.0 else None
    return control / baseline


def _load_factor(x: np.ndarray, window: int) -> float:
    vals = []
    for g in range(0, len(x), window):
        seg = x[g:g + window]
        with np.errstate(divide="ignore", invalid="ignore"):
            vals.append(1.0 - seg.mean() / seg.max())
    vals = [v for v in vals if np.isfinite(v)]
    return float(np.mean(vals)) if vals else float("nan")


def _peak(x: np.ndarray, window: int) -> float:
    return float(np.mean([x[g:g + window].max() for g in range(0, len(x), window)]))


def kpis(d: district_model.District, run: Dict[str, np.ndarray], names) -> Dict[str, float]:
    """The energy KPIs of ``evaluate`` at the episode's end, control over
    the district without storage: ``<building>|<kpi>`` and ``District|<kpi>``."""
    T = d.n_rows
    net, storage = run["net"], run["battery"]
    base = net - storage
    price, carbon = run["price"], run["carbon"]
    pos = lambda x: np.clip(x, 0, None).sum(0)
    out = {}
    ctl = {"electricity_consumption_total": pos(net), "zero_net_energy": net.sum(0),
           "carbon_emissions_total": pos(run["emission"]), "cost_total": pos(run["cost"])}
    ref = {"electricity_consumption_total": pos(base), "zero_net_energy": base.sum(0),
           "carbon_emissions_total": pos(np.clip(base * carbon, 0, None)),
           "cost_total": pos(base * price)}
    for k in BUILDING_KPIS:
        for bi, name in enumerate(names):
            out[f"{name}|{k}"] = _div(float(ctl[k][bi]), float(ref[k][bi]))
    dc, db = net.sum(1)[:T - 1], base.sum(1)
    ramp = lambda x: float(np.clip(np.diff(x), 0, None).sum())
    district = {"ramping_average": (ramp(dc), ramp(db)),
                "daily_one_minus_load_factor_average": (_load_factor(dc, 24), _load_factor(db, 24)),
                "monthly_one_minus_load_factor_average": (_load_factor(dc, 730),
                                                          _load_factor(db, 730)),
                "daily_peak_average": (_peak(dc, 24), _peak(db, 24)),
                "all_time_peak_average": (_peak(dc, T), _peak(db, T))}
    for k, (c, b) in district.items():
        out[f"District|{k}"] = _div(c, b)
    return out
