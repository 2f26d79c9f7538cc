"""An EV district (CityLearn 2.x's ``citylearn_challenge_2022_phase_all_plus_evs``:
battery+PV buildings with EV chargers, electric vehicles and a washing
machine) read straight from its ``schema.json`` and CSVs, and one hour of
it for a batch of D districts in float32: the buildings' batteries and PV,
the chargers and the EV batteries they charge or discharge, the EVs' state
of charge between stays, the washing machines, each building's net
consumption and the ``Electric_Vehicles_Reward_Function``.

Semantics are CityLearn's as ``SURVEY.md`` records them (A.1 for the
observations, A.2 for the actions, A.5 for the device defaults, A.8 for the
quirks), with the code they cite:

- chargers (``electric_vehicle_charger.py:163-223, 252-329``): an action
  ``a`` in [-1, 1] asks for ``a`` of the charger's maximum charging (a > 0)
  or discharging power for the hour, held between the minimum and the
  maximum power; the charger's efficiency is its charge or discharge
  efficiency curve read at ``|a|`` (``numpy.interp``: constant beyond its
  knots), its scalar efficiency where the schema gives no curve; the EV's
  battery is asked for ``energy * efficiency`` when charging and
  ``energy / efficiency`` when discharging, with no conversion by the
  time-step ratio, and the charger draws the battery's balance over the
  efficiency (charging) or times it (discharging). Only a non-zero action
  at a charger with an EV connected moves anything;
- the EV batteries (``energy_model.py:872-1141``, ``Battery``): the
  building battery's model (:mod:`benchmark.reference.battery`), with the
  EV's depth of discharge. A schema that gives an EV battery no curves
  gets CityLearn's default ones (``energy_model.py:977-1003``), each point
  the first draw of ``RandomState(random_seed).uniform(lo, hi)`` with the
  schema's ``random_seed`` (``citylearn.py:2558-2594``);
- the EVs' state of charge between stays (``citylearn.py:1353-1475``): at
  each hour, first every EV that is at no charger (``t`` neither the first
  nor the last hour) is either about to arrive, its SOC set to the
  charger's estimated arrival SOC, or drifts by a factor ``normal(1.0,
  0.2)`` clipped to [0.6, 1.4], its SOC then clipped to [0, 1]; then every
  charger whose EV has just connected sets that EV's SOC to the estimated
  arrival SOC announced the hour before, else to the schedule's current
  SOC. A charge reads the SOC of the hour before (the first hour: the
  SOC the events set), and an EV at a charger that moved nothing ends the
  hour at 0 (the SOC history is zero-filled, ``energy_model.py:662-666,
  1046-1047``);
- the washing machines (``energy_model.py:1289-1334``): a positive action
  inside the hour's start/end window, at a machine not yet started in
  that window, books the whole load profile at that hour (cut at the
  episode's end); a window that differs from the hour before re-arms the
  machine;
- net consumption (``building.py:1566-1812, 2615-2703``): the
  non-shiftable load, the battery's balance, minus PV, plus the chargers'
  and the machines' consumption; at the episode's first hour the load is
  booked three times and the battery twice (``building.py:2526-2564``);
- ``Electric_Vehicles_Reward_Function`` (``reward_function.py:389-517``):
  each building's ``MARL`` value only scales the shaping, by ``1 / (1 +
  |MARL|)``; every charger with an EV connected adds the battery-limits,
  impossible-SOC, under-SOC, close-SOC, self-consumption and
  extra-self-production terms by the schema's weights (a charger with no
  EV computes its ``no_car_charging`` term and then skips it,
  ``reward_function.py:459-463``, so it adds nothing); a building without
  chargers gets 0;
- the observations the batched trainer's policy reads (``rlc.py``'s
  encoders, ``building.py:1221-1331, 1867-2106``): the 2022 set as
  :func:`benchmark.reference.district.observation_table` encodes it, then
  per charger its connected and incoming EVs' schedule (sentinels state 0,
  times -1, SOC -0.1, capacity -1 where none), the connected EV's SOC as
  the arrival SOC the events set at that hour (0 where none is set), and
  each machine's start and end step; min-max scaled by the space's fixed
  limits; buildings padded with zeros to the widest.

Departures from CityLearn, each true of this deployment and stated in its
configuration's ``assumed``:

- the charger schedules, the EVs' SOC events and drift draws, the required
  SOCs and hours to departure, and the machines' windows and loads are
  read at the episode's own hour ``t`` from the first ``episode_time_steps``
  rows of the data, whatever the episode's window, while the observations
  and the buildings' series are read at the window's rows ``offset + t``:
  the port does so (``core/params.py::_pack_evs``,
  ``compiler/events.py::resolve_ev_events``), and under shifted windows its
  physics follows the first month's charger schedule while its agents
  observe the window's;
- the drift factors come from ``numpy.random.RandomState(random_seed)``,
  one draw an undocked EV an hour in EV order, where CityLearn draws them
  from the global generator, which no seed reproduces (A.8 item 3);
- no charging constraints (the dataset predates them), no power outage,
  hourly steps (``time_step_ratio`` 1).
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import battery as battery_model
from benchmark.reference import district as district_model

WEIGHTS = ("no_car_charging", "battery_limits", "soc_impossible", "soc_under", "close_soc",
           "self_ev_consumption", "extra_self_production")
DEFAULT_WEIGHTS = dict(zip(WEIGHTS, (-5.0, -2.0, -10.0, -5.0, 10.0, 5.0, 5.0)))
# the per-charger observations in the order CityLearn expands them, and
# each one's (low, high) space limits (building.py:1968-2010)
CHARGER_OBSERVATIONS = {
    "electric_vehicle_charger_connected_state": (0.0, 1.0),
    "connected_electric_vehicle_at_charger_departure_time": (-1.0, 24.0),
    "connected_electric_vehicle_at_charger_required_soc_departure": (-0.1, 1.0),
    "connected_electric_vehicle_at_charger_soc": (-0.1, 1.0),
    "connected_electric_vehicle_at_charger_battery_capacity": (-1.0, 100.0),
    "electric_vehicle_charger_incoming_state": (0.0, 1.0),
    "incoming_electric_vehicle_at_charger_estimated_arrival_time": (-1.0, 24.0),
    "incoming_electric_vehicle_at_charger_estimated_soc_arrival": (-0.1, 1.0),
}
MACHINE_OBSERVATIONS = {"washing_machine_start_time_step": (-1.0, 24.0),
                        "washing_machine_end_time_step": (-1.0, 24.0)}
FAULTS = ("scalar_efficiency", "arrival_unforced", "machine_unloaded", "close_soc_dropped")


@dataclass
class Schedule:
    """One charger's schedule over the simulation rows (numpy, float64
    where not integer)."""
    state: np.ndarray          # int: 1 an EV connected, 2 one incoming, else 3
    connected: np.ndarray      # int: the connected EV's index, -1 where none
    incoming: np.ndarray       # int: the incoming EV's index, -1 where none
    capacity: np.ndarray       # kWh of the connected EV, NaN where none
    current_soc: np.ndarray    # fraction, NaN where none
    departure: np.ndarray      # int hours to departure, -1 where none
    required_soc: np.ndarray   # fraction, -0.1 where none
    arrival: np.ndarray        # int hours to arrival, -1 where none
    arrival_soc: np.ndarray    # estimated arrival SOC, fraction, -0.1 where none


@dataclass
class Charger:
    name: str
    building: int
    efficiency: float
    charge_curve: Optional[np.ndarray]        # (n, 2) knots, or None
    discharge_curve: Optional[np.ndarray]
    max_charging_power: float
    min_charging_power: float
    max_discharging_power: float
    min_discharging_power: float
    schedule: Schedule


@dataclass
class Machine:
    name: str
    building: int
    start: np.ndarray          # int, -1 where no window
    end: np.ndarray
    profiles: List[np.ndarray]  # the load profile of each row (empty where none)


@dataclass
class EV:
    """An EV's battery, with the field names :class:`battery_model.Batteries`
    reads."""
    name: str
    capacity: float
    nominal_power: float
    efficiency: float
    loss_coefficient: float
    initial_soc: float
    depth_of_discharge: float
    capacity_loss_coefficient: float
    pec: np.ndarray
    cpc: np.ndarray


@dataclass
class State:
    """One episode's position and what it carries, for D districts."""
    offset: torch.Tensor       # (D,) int64 first data row of the episode
    t: int                     # hours into the episode (every district alike)
    soc: torch.Tensor          # (D, B) the buildings' batteries
    eff: torch.Tensor
    deg: torch.Tensor
    ev_soc: torch.Tensor       # (D, V) the EVs' batteries
    ev_eff: torch.Tensor
    ev_deg: torch.Tensor
    wm: torch.Tensor           # (D, W) bool: started in its current window


@dataclass
class Out:
    reward: torch.Tensor       # (D, B) the EV reward
    net: torch.Tensor          # (D, B) net electricity consumption
    chargers: torch.Tensor     # (D, B) the chargers' consumption
    machines: torch.Tensor     # (D, B) the machines' consumption


@dataclass
class District:
    base: district_model.District     # the battery+PV buildings
    chargers: List[Charger]
    evs: List[EV]
    machines: List[Machine]
    actions: List[List[str]]          # each building's actions, in the agent's order
    observations: List[List[str]]     # each building's observations after the 2022 set
    episode_steps: int
    random_seed: int
    weights: Dict[str, float]
    device: torch.device
    nsl: torch.Tensor = None          # (T, B) float32
    solar: torch.Tensor = None
    batteries: battery_model.Batteries = None     # (B,)
    ev_batteries: battery_model.Batteries = None  # (V,)
    tables: Dict[str, torch.Tensor] = None        # the episode's tables, (T_ep, C/V/W)

    @property
    def n_buildings(self) -> int:
        return len(self.base.buildings)

    @property
    def n_slots(self) -> int:
        return max(len(a) for a in self.actions)

    @property
    def hours(self) -> float:
        return self.base.seconds_per_time_step / 3600.0


# --- reading the schema -----------------------------------------------------------

def _cells(path: str) -> Dict[str, List[str]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {name: [r[i] for r in rows[1:]] for i, name in enumerate(rows[0])}


def _number(cell: str) -> float:
    return float(cell) if cell.strip() else float("nan")


def _schedule(path: str, rows: slice, ev_index: Dict[str, int]) -> Schedule:
    """A charger's CSV (CityLearn's ``ChargerSimulation``, ``data.py:663-768``):
    SOCs in percent (the connected EV's current SOC in kWh), ids resolved
    to EV indices, no noise."""
    c = {k: v[rows] for k, v in _cells(path).items()}
    num = lambda key: np.array([_number(x) for x in c[key]])
    state = np.array([int(x) for x in c["electric_vehicle_charger_state"]])
    ids = np.array([ev_index.get(x.strip(), -1) for x in c["electric_vehicle_id"]])
    percent = lambda key: np.where(np.isnan(num(key)), -0.1, np.clip(num(key) / 100.0, 0.0, 1.0))
    capacity = num("electric_vehicle_battery_capacity_khw")
    with np.errstate(invalid="ignore"):
        current = np.clip(num("current_soc") / capacity, 0.0, 1.0)
    hours = lambda key: np.where(np.isnan(num(key)), -1, num(key)).astype(np.int64)
    return Schedule(state=state, connected=np.where(state == 1, ids, -1),
                    incoming=np.where(state == 2, ids, -1), capacity=capacity,
                    current_soc=current, departure=hours("electric_vehicle_departure_time"),
                    required_soc=percent("electric_vehicle_required_soc_departure"),
                    arrival=hours("electric_vehicle_estimated_arrival_time"),
                    arrival_soc=percent("electric_vehicle_estimated_soc_arrival"))


def _machine(name: str, building: int, path: str, rows: slice) -> Machine:
    c = {k: v[rows] for k, v in _cells(path).items()}
    step = lambda key: np.array([int(float(x)) if x.strip() else -1 for x in c[key]])
    profiles = [np.asarray(json.loads(x), np.float64) if x.strip() else np.zeros(0)
                for x in c["load_profile"]]
    return Machine(name, building, step("wm_start_time_step"), step("wm_end_time_step"),
                   profiles)


def default_curves(efficiency: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """CityLearn's default power-efficiency and capacity-power curves of a
    battery (``energy_model.py:977-1003``), each point the first draw of a
    fresh ``RandomState(seed).uniform``."""
    u = lambda lo, hi: float(np.random.RandomState(seed).uniform(lo, hi))
    e = efficiency
    pec = [[0.0, u(e * 0.85, e * 0.90)], [u(0.25, 0.35), u(e * 0.90, e * 0.95)],
           [u(0.65, 0.75), u(e * 0.98, e * 1.0)], [u(0.75, 0.85), e],
           [1.0, u(e * 0.95, e * 0.98)]]
    cpc = [[0.0, u(0.95, 1.0)], [u(0.75, 0.85), u(0.90, 0.95)], [1.0, u(0.20, 0.30)]]
    return np.asarray(pec, np.float64), np.asarray(cpc, np.float64)


def load(schema_path: str, device, episode_steps: int) -> District:
    root = os.path.dirname(schema_path)
    with open(schema_path) as f:
        schema = json.load(f)
    base = district_model.load(schema_path)
    ev_keys = set(CHARGER_OBSERVATIONS) | set(MACHINE_OBSERVATIONS)
    base.observations = [k for k in base.observations if k not in ev_keys]
    active = lambda key: [k for k, v in schema[key].items() if v["active"]]
    obs, acts = set(active("observations")), set(active("actions"))
    rows = slice(base.start, base.end + 1)
    seed = int(schema.get("random_seed") or 0)

    evs = []
    for name, e in (schema.get("electric_vehicles_def") or {}).items():
        if not e.get("include", True):
            continue
        a = e["battery"]["attributes"]
        pec, cpc = default_curves(float(a["efficiency"]), seed)
        evs.append(EV(name, float(a["capacity"]), float(a["nominal_power"]),
                      float(a["efficiency"]), float(a.get("loss_coefficient", 0.0)),
                      float(a["initial_soc"]), float(a["depth_of_discharge"]),
                      float(a["capacity_loss_coefficient"]),
                      np.asarray(a["power_efficiency_curve"], np.float64)
                      if "power_efficiency_curve" in a else pec,
                      np.asarray(a["capacity_power_curve"], np.float64)
                      if "capacity_power_curve" in a else cpc))
    ev_index = {e.name: i for i, e in enumerate(evs)}

    chargers, machines, actions, observations = [], [], [], []
    included = [(n, e) for n, e in schema["buildings"].items() if e.get("include", True)]
    for bi, (_, e) in enumerate(included):
        acts_b = ["electrical_storage"] if "electrical_storage" in acts else []
        obs_b = []
        for cid, ch in (e.get("chargers") or {}).items():
            a = ch.get("attributes") or {}
            curve = lambda key: np.asarray(a[key], np.float64) if a.get(key) else None
            chargers.append(Charger(
                cid, bi, float(a.get("efficiency") or 1.0), curve("charge_efficiency_curve"),
                curve("discharge_efficiency_curve"),
                float(a.get("max_charging_power", 50.0)), float(a.get("min_charging_power") or 0.0),
                float(a.get("max_discharging_power", 50.0)),
                float(a.get("min_discharging_power") or 0.0),
                _schedule(os.path.join(root, ch["charger_simulation"]), rows, ev_index)))
            if "electric_vehicle_storage" in acts:
                acts_b.append(f"electric_vehicle_storage_{cid}")
            obs_b += [(key, cid) for key in CHARGER_OBSERVATIONS if key in obs]
        for name, wm in (e.get("washing_machines") or {}).items():
            machines.append(_machine(name, bi, os.path.join(
                root, wm["washing_machine_energy_simulation"]), rows))
            if "washing_machine" in acts:
                acts_b.append(name)
            obs_b += [(key, name) for key in MACHINE_OBSERVATIONS if key in obs]
        actions.append(acts_b)
        observations.append(obs_b)

    if any(a[:1] != ["electrical_storage"] for a in actions):
        raise ValueError("the reference takes districts whose buildings all act on a battery first")
    weights = dict(DEFAULT_WEIGHTS)
    weights.update(((schema.get("reward_function") or {}).get("attributes") or {}).get("weights")
                   or {})
    d = District(base, chargers, evs, machines, actions, observations, int(episode_steps), seed,
                 weights, torch.device(device))
    _prepare(d)
    return d


# --- the SOC events ---------------------------------------------------------------

def soc_events(d: District, n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The EVs' SOC events of the first ``n_steps`` hours, replayed hour by
    hour as CityLearn's ``next_time_step`` runs them
    (``citylearn.py:1353-1475``): (force, drift), each (n_steps, V)
    float32, NaN where the hour sets no SOC (force) or the EV does not
    drift (drift)."""
    V = len(d.evs)
    force = np.full((n_steps, V), np.nan, np.float32)
    drift = np.full((n_steps, V), np.nan, np.float32)
    rng = np.random.RandomState(d.random_seed)
    sched = [c.schedule for c in d.chargers]
    valid = lambda x: bool(0.0 <= x <= 1.0)          # NaN is not

    for t in range(n_steps):
        if 0 < t < n_steps - 1:
            # EVs at no charger: arriving next hour, or drifting
            for v in range(V):
                docked, arrival = False, None
                for s in sched:
                    if s.connected[t] == v:
                        docked = True
                        break
                    if s.connected[t + 1] == v and s.state[t] != 1:
                        docked = True
                        announced = s.incoming[t] == v
                        arrival = s.arrival_soc[t if announced else t + 1]
                        break
                if not docked:
                    drift[t, v] = np.clip(rng.normal(1.0, 0.2), 0.6, 1.4)
                elif arrival is not None and valid(arrival):
                    force[t, v] = arrival
        # EVs that have just connected
        for s in sched:
            v = s.connected[t]
            if v < 0 or (t > 0 and s.connected[t - 1] == v):
                continue
            announced = t > 0 and s.incoming[t - 1] == v
            soc = s.arrival_soc[t - 1 if announced else t]
            if not valid(soc):
                soc = s.current_soc[t]
            if valid(soc):
                force[t, v], drift[t, v] = soc, np.nan
    return force, drift


# --- device tables ----------------------------------------------------------------

def _prepare(d: District):
    dev, T = d.device, d.episode_steps
    d.nsl, d.solar = district_model.physics_series(d.base, dev)
    d.batteries = battery_model.Batteries.of(d.base.buildings, dev)
    d.ev_batteries = battery_model.Batteries.of(d.evs, dev)
    force, drift = soc_events(d, T)
    col = lambda f, dtype=torch.float32: torch.tensor(
        np.stack([f(c.schedule)[:T] for c in d.chargers], 1), dtype=dtype, device=dev)
    loads = []
    for m in d.machines:
        load = np.zeros(T, np.float32)
        for t in range(min(T, len(m.profiles))):
            load[t] = float(np.sum(m.profiles[t][:max(0, T - t)]))
        loads.append(load)
    mcol = lambda f: torch.tensor(np.stack([f(m)[:T] for m in d.machines], 1),
                                  dtype=torch.int64, device=dev)
    d.tables = {
        "connected": col(lambda s: s.connected, torch.int64),
        "required_soc": col(lambda s: s.required_soc),
        "departure": col(lambda s: s.departure),
        "force": torch.tensor(force, device=dev), "drift": torch.tensor(drift, device=dev),
        "wm_start": mcol(lambda m: m.start), "wm_end": mcol(lambda m: m.end),
        "wm_load": torch.tensor(np.stack(loads, 1), device=dev),
    }


def _per_charger(d: District, key: str) -> torch.Tensor:
    return torch.tensor([getattr(c, key) for c in d.chargers], dtype=torch.float32,
                        device=d.device)


def _interp(q: torch.Tensor, knots: np.ndarray) -> torch.Tensor:
    """``numpy.interp(q, x, y)`` in float32 on one curve's knots."""
    x = [float(np.float32(v)) for v in knots[:, 0]]
    y = [float(np.float32(v)) for v in knots[:, 1]]
    out = torch.full_like(q, y[0])
    for i in range(len(x) - 1):
        if x[i + 1] > x[i]:
            seg = y[i] + ((q - x[i]) / (x[i + 1] - x[i])) * (y[i + 1] - y[i])
            out = torch.where((q >= x[i]) & (q < x[i + 1]), seg, out)
    return torch.where(q >= x[-1], torch.full_like(q, y[-1]), out)


def charger_efficiency(d: District, a: torch.Tensor, fault: str = None) -> torch.Tensor:
    """(D, C) efficiency of each charger at action ``a``: its charge curve
    (a > 0) or discharge curve at ``|a|``, its scalar efficiency where the
    schema gives no curve (or, as the fault ``scalar_efficiency``, always)."""
    cols = []
    for c, ch in enumerate(d.chargers):
        q = torch.abs(a[:, c])
        scalar = torch.full_like(q, float(np.float32(ch.efficiency)))
        if fault == "scalar_efficiency":
            cols.append(scalar)
            continue
        up = scalar if ch.charge_curve is None else _interp(q, ch.charge_curve)
        down = scalar if ch.discharge_curve is None else _interp(q, ch.discharge_curve)
        cols.append(torch.where(a[:, c] > 0, up, down))
    return torch.stack(cols, 1)


# --- the observations and actions -------------------------------------------------

def _observation_column(d: District, b: int, key: str, name: str, force_full) -> np.ndarray:
    if key in MACHINE_OBSERVATIONS:
        m = next(m for m in d.machines if m.name == name)
        return (m.start if key.endswith("start_time_step") else m.end).astype(np.float64)
    c = next(i for i, c in enumerate(d.chargers) if c.name == name)
    s = d.chargers[c].schedule
    conn, inc = s.connected >= 0, s.incoming >= 0
    if key == "electric_vehicle_charger_connected_state":
        return conn.astype(np.float64)
    if key == "electric_vehicle_charger_incoming_state":
        return inc.astype(np.float64)
    if key.endswith("_departure_time"):
        return np.where(conn, s.departure, -1.0)
    if key.endswith("_required_soc_departure"):
        return np.where(conn, s.required_soc, -0.1)
    if key.endswith("_battery_capacity"):
        return np.where(conn, s.capacity, -1.0)
    if key.endswith("_estimated_arrival_time"):
        return np.where(inc, s.arrival, -1.0)
    if key.endswith("_estimated_soc_arrival"):
        return np.where(inc, s.arrival_soc, -0.1)
    # the connected EV's SOC as the hour's events set it (0 where none)
    forced = force_full[np.arange(len(conn)), np.clip(s.connected, 0, None)]
    return np.where(conn, np.where(np.isfinite(forced), forced, 0.0), -0.1)


def observation_table(d: District) -> torch.Tensor:
    """(T, B * K) float32: every building's encoded observation row at each
    simulation row, the 2022 set then its chargers' and machines', zeros
    to the widest building, buildings side by side."""
    T, B, dev = d.base.n_rows, d.n_buildings, d.device
    base = district_model.observation_table(d.base, dev).view(T, B, -1)
    force_full, _ = soc_events(d, T)
    rows = []
    for b in range(B):
        cols = [base[:, b]]
        for key, name in d.observations[b]:
            lo, hi = CHARGER_OBSERVATIONS.get(key) or MACHINE_OBSERVATIONS[key]
            x = torch.tensor(_observation_column(d, b, key, name, force_full),
                             dtype=torch.float32, device=dev)
            lo32, hi32 = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (lo, hi))
            cols.append(((x - lo32) / (hi32 - lo32))[:, None])
        rows.append(torch.cat(cols, 1))
    K = max(r.shape[1] for r in rows)
    padded = [torch.cat([r, torch.zeros(T, K - r.shape[1], device=dev)], 1) for r in rows]
    return torch.stack(padded, 1).reshape(T, B * K)


def action_bounds(d: District) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, M) low, high and mask of each building's actions, padded slots
    0 (``building.py:2161-2282``): the battery's in [-1, 1], a charger's in
    [-1, 1] ([0, 1] where it cannot discharge), a machine's in [0, 1]."""
    B, M = d.n_buildings, d.n_slots
    low, high, mask = (torch.zeros(B, M, device=d.device) for _ in range(3))
    by_name = {f"electric_vehicle_storage_{c.name}": c for c in d.chargers}
    for b, names in enumerate(d.actions):
        for m, name in enumerate(names):
            mask[b, m], high[b, m] = 1.0, 1.0
            if name == "electrical_storage":
                low[b, m] = -1.0
            elif name in by_name:
                low[b, m] = 0.0 if by_name[name].max_discharging_power == 0 else -1.0
    return low, high, mask


def _slot(d: District, name: str) -> Tuple[int, int]:
    return next((b, names.index(name)) for b, names in enumerate(d.actions) if name in names)


# --- one hour ---------------------------------------------------------------------

def initial(d: District, offset: torch.Tensor) -> State:
    """An episode's start from data rows ``offset`` (D,)."""
    D, W = offset.shape[0], len(d.machines)
    tile = lambda v: v[None].expand(D, v.shape[0]).clone()
    bat, ev = d.batteries, d.ev_batteries
    return State(offset=offset.long(), t=0, soc=tile(bat.initial_soc), eff=tile(bat.efficiency),
                 deg=tile(bat.capacity), ev_soc=tile(ev.initial_soc), ev_eff=tile(ev.efficiency),
                 ev_deg=tile(ev.capacity),
                 wm=torch.zeros(D, W, dtype=torch.bool, device=d.device))


def _by_building(d: District, x: torch.Tensor, of: List[int]) -> torch.Tensor:
    """(D, n) values of devices standing on buildings ``of`` summed to (D, B)."""
    out = torch.zeros(x.shape[0], d.n_buildings, device=x.device)
    for i, b in enumerate(of):
        out[:, b] = out[:, b] + x[:, i]
    return out


def ev_reward(d: District, t: int, net: torch.Tensor, soc_before: torch.Tensor,
              soc_after: torch.Tensor, a_ch: torch.Tensor, fault: str = None) -> torch.Tensor:
    """``Electric_Vehicles_Reward_Function`` (D, B) at episode hour ``t``:
    the buildings' net consumption ``net`` (D, B), the EVs' SOC before and
    after the hour (D, V) and the chargers' actions (D, C). The fault
    ``close_soc_dropped`` weighs the close-SOC terms 0."""
    w, tb = d.weights, d.tables
    if fault == "close_soc_dropped":
        w = dict(w, close_soc=0.0)
    neg = -net
    marl = torch.sign(neg) * 0.01 * (neg ** 2) * torch.clamp(net.sum(-1, keepdim=True), min=0.0)
    bidx = torch.tensor([c.building for c in d.chargers], device=net.device)
    mult = (1.0 / (1.0 + torch.abs(marl)))[:, bidx]                      # (D, C)
    conn = tb["connected"][t]
    v = torch.clamp(conn, min=0)
    ev = d.ev_batteries
    cap, dod = ev.capacity[v], ev.depth_of_discharge[v]
    prev = ev.initial_soc[v].expand_as(mult) if t == 0 else soc_before[:, v]
    now = soc_after[:, v]
    maxc, maxd = _per_charger(d, "max_charging_power"), _per_charger(d, "max_discharging_power")
    last = torch.where(a_ch != 0, charger_energy(d, a_ch), torch.zeros_like(a_ch))
    zero = torch.zeros_like(mult)
    term = lambda cond, weight: torch.where(cond, weight * mult, zero)

    energy = prev * cap + last
    limits = term((energy > cap) | (energy < (1.0 - dod) * cap), w["battery_limits"])
    diff = now - tb["required_soc"][t]
    diff_kwh = diff * cap
    hours = tb["departure"][t]
    reach_up, reach_down = maxc * hours, maxd * hours
    impossible = term(diff_kwh > reach_up, w["soc_impossible"])
    leaving = hours == 0
    under = torch.where(leaving & (-0.25 < diff) & (diff <= -0.10), 2 * w["soc_under"] * mult,
                        term(leaving & (diff <= -0.25), w["soc_under"] ** 2))
    close = term(leaving & (-0.10 < diff) & (diff <= 0.10), w["close_soc"])
    close = close + torch.where(torch.abs(diff_kwh) <= torch.maximum(reach_up, reach_down),
                                w["close_soc"] * mult * (1.0 / (hours + 0.1)), zero)
    net_b = net[:, bidx]
    extra = torch.where((last > 0) & (net_b < 0), w["extra_self_production"] * mult,
                        term((last < 0) & (net_b < 0), -0.5 * w["extra_self_production"]))
    own = torch.where((last < 0) & (net_b > 0), w["self_ev_consumption"] * mult,
                      term((last > 0) & (net_b > 0), -0.5 * w["self_ev_consumption"]))
    per_charger = torch.where(conn >= 0, limits + impossible + under + close + extra + own, zero)
    return _by_building(d, per_charger, [c.building for c in d.chargers])


def charger_energy(d: District, a: torch.Tensor) -> torch.Tensor:
    """(D, C) kWh each charger asks for at action ``a``, within its
    minimum and maximum power."""
    maxc, minc = _per_charger(d, "max_charging_power"), _per_charger(d, "min_charging_power")
    maxd, mind = _per_charger(d, "max_discharging_power"), _per_charger(d, "min_discharging_power")
    up = torch.maximum(torch.minimum(a * maxc * d.hours, maxc), minc)
    down = torch.maximum(torch.minimum(a * maxd * d.hours, -mind), -maxd)
    return torch.where(a > 0, up, down)


def _chargers(d: District, s: State, a: torch.Tensor, fault: str = None):
    """The hour's SOC events and charges: the EVs' new (soc, eff, deg)
    (D, V) and each charger's consumption (D, C)."""
    tb, ev = d.tables, d.ev_batteries
    t = s.t
    force, drift = tb["force"][t], tb["drift"][t]                        # (V,)
    if fault == "arrival_unforced":
        force = torch.full_like(force, float("nan"))
    rest = ev.initial_soc.expand_as(s.ev_soc) if t == 0 else torch.zeros_like(s.ev_soc)
    drifted = torch.clamp(s.ev_soc * drift, 0.0, 1.0)
    evented = torch.where(torch.isfinite(force), force,
                          torch.where(torch.isfinite(drift), drifted, rest))
    read = evented if t == 0 else s.ev_soc

    conn = tb["connected"][t]
    v = torch.clamp(conn, min=0)
    eff = charger_efficiency(d, a, fault)
    energy = charger_energy(d, a)
    request = torch.where(a > 0, energy * eff, energy / eff)
    at = battery_model.Batteries(
        capacity=ev.capacity[v], nominal_power=ev.nominal_power[v],
        loss_coefficient=ev.loss_coefficient[v], depth_of_discharge=ev.depth_of_discharge[v],
        capacity_loss_coefficient=ev.capacity_loss_coefficient[v], efficiency=ev.efficiency[v],
        initial_soc=ev.initial_soc[v], pec=tuple(x[v] for x in ev.pec),
        cpc=tuple(x[v] for x in ev.cpc))
    soc, bat_eff, deg, balance = battery_model.charge(at, read[:, v], s.ev_eff[:, v],
                                                      s.ev_deg[:, v], request)
    moved = (a != 0) & (conn >= 0)
    zero = torch.zeros_like(a)
    balance = torch.where(moved, balance, zero)
    consumption = torch.where(moved, torch.where(balance >= 0, balance / eff, balance * eff),
                              zero)
    new_soc, new_eff, new_deg = evented.clone(), s.ev_eff.clone(), s.ev_deg.clone()
    for c in range(len(d.chargers)):
        if int(conn[c]) < 0:
            continue
        k, hit = int(conn[c]), moved[:, c]
        new_soc[:, k] = torch.where(hit, soc[:, c], new_soc[:, k])
        new_eff[:, k] = torch.where(hit, bat_eff[:, c], new_eff[:, k])
        new_deg[:, k] = torch.where(hit, deg[:, c], new_deg[:, k])
    return new_soc, new_eff, new_deg, consumption


def _machines(d: District, s: State, a: torch.Tensor, fault: str = None):
    """The machines' consumption (D, W) and whether each has started in
    its window (D, W)."""
    tb, t = d.tables, s.t
    start, end = tb["wm_start"][t], tb["wm_end"][t]                      # (W,)
    started = s.wm
    if t > 0:
        moved = (tb["wm_start"][t - 1] != start) | (tb["wm_end"][t - 1] != end)
        started = started & ~moved
    runs = ~started & (a > 0) & (start != -1) & (end != -1) & (start <= t) & (t <= end)
    load = tb["wm_load"][t].expand_as(a)
    if fault == "machine_unloaded":
        load = torch.zeros_like(load)
    return torch.where(runs, load, torch.zeros_like(load)), started | runs


def step(d: District, s: State, actions: torch.Tensor, fault: str = None) -> Tuple[State, Out]:
    """One hour of every district under ``actions`` (D, B, M), each
    building's in the order of :attr:`District.actions`. ``fault`` is one
    of :data:`FAULTS`: the chargers' efficiency curves read as their
    scalar, no arrival SOC set, the machines' load dropped, the reward's
    close-SOC terms dropped."""
    rows = s.offset + s.t
    nsl, solar = d.nsl[rows], d.solar[rows]
    pick = lambda names: torch.stack([actions[:, b, m] for b, m in
                                      (_slot(d, n) for n in names)], 1)
    a_bat = actions[:, :, 0]                 # every building's first action
    a_ch = pick([f"electric_vehicle_storage_{c.name}" for c in d.chargers])
    a_wm = pick([m.name for m in d.machines])

    energy = a_bat * d.batteries.nominal_power * d.hours
    soc, eff, deg, bat_balance = battery_model.charge(d.batteries, s.soc, s.eff, s.deg, energy)
    ev_soc, ev_eff, ev_deg, ch_cons = _chargers(d, s, a_ch, fault)
    wm_cons, wm = _machines(d, s, a_wm, fault)
    chargers = _by_building(d, ch_cons, [c.building for c in d.chargers])
    machines = _by_building(d, wm_cons, [m.building for m in d.machines])
    if s.t == 0:
        load, battery = 3.0 * nsl, 2.0 * bat_balance
    else:
        load, battery = nsl, bat_balance
    net = load + battery - solar + chargers + machines
    new = State(offset=s.offset, t=s.t + 1, soc=soc, eff=eff, deg=deg, ev_soc=ev_soc,
                ev_eff=ev_eff, ev_deg=ev_deg, wm=wm)
    reward = ev_reward(d, s.t, net, s.ev_soc, ev_soc, a_ch, fault)
    return new, Out(reward=reward, net=net, chargers=chargers, machines=machines)
