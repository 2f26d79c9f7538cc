"""An LSTM-dynamics district (the 2023 CityLearn Challenge's
``LSTMDynamicsBuilding``s) read straight from its ``schema.json``, CSVs
and ``.pth`` files, and one hour of it for a (D, B) batch of districts and
buildings in float32: partial-load cooling, the DHW heater and tank, the
battery, PV, the LSTM's indoor temperature and the ``ComfortReward``.

Semantics are CityLearn's as ``SURVEY.md`` records them:

- partial load (``building.py:3080-3158``): once the LSTM's window has
  filled (``t >= lookback + 1``) the ``cooling_device`` action sets the
  electric power the heat pump may draw, and the cooling demand becomes
  what the heat pump delivers from it, ``min(action * nominal power,
  nominal power) * COP``, in ``hvac_mode`` 1 (cooling) or 3 (auto), else 0;
  before, the data's ideal demand;
- the heat pump's Carnot COP, ``efficiency * (target + 273.15) /
  (outdoor - target)``, set to 20 where it is negative, above 20 or not
  finite (``energy_model.py:216-250``); a device's output is capped by
  its nominal power less what it has drawn this hour
  (``energy_model.py:121-124, 252-281``);
- the end uses in priority order (``building.py:1566-1812``): a
  discharging battery first, then cooling (device), DHW (a discharging
  tank before its heater, a charging one after it), the non-shiftable
  load, then a charging battery. The DHW tank's request is its action
  times the *heating* tank's capacity (``building.py:1765``, a shipped
  quirk: 0 here, as the district has no heating tank);
- the storage tank and battery (``energy_model.py:603-871, 1027-1141``):
  standby loss, round-trip efficiency split, the capacity clamp; the
  battery is :mod:`benchmark.reference.battery`;
- at the episode's first hour the devices' consumption is booked three
  times and the battery's twice (``building.py:2526-2564, 2615-2652``),
  and the heat pump's cap is lowered by the ideal demand's consumption;
- the LSTM (``dynamics.py``, ``building.py:2935-3078``): each hour the
  channels that the dataset's ``dynamics`` block names,
  min-max normalized by its ``input_normalization_minimum`` /
  ``maximum``, are appended to a window of ``lookback + 1`` hours; the
  cooling-demand channel is this hour's delivered cooling and the
  indoor-temperature channel the data's. Once ``t >= lookback`` a
  ``torch.nn.LSTM`` of ``num_layers`` x ``hidden_size`` runs over the
  last ``lookback`` hours (the temperature channel over the first
  ``lookback``, one hour older: ``building.py:3039-3055``) from the hidden
  state carried since the episode began, a linear head predicts the
  normalized temperature, which replaces the window's newest temperature
  entry, and the hidden state is carried on; before, the data's
  temperature stands and nothing is carried. Every episode starts from a
  zero window and a zero hidden state (the model is reloaded at reset);
- ``ComfortReward`` (``reward_function.py:216-340``) on the predicted
  temperature, with the schema's band and exponents;
- the observations the batched trainer's policy reads (``rlc.py``'s
  encoders, ``building.py:1336-1481, 1867-2160``): each active
  observation's data-driven value (a state observation, an SOC or the
  net consumption, reads 0; ``net_electricity_consumption`` is dropped),
  periodic ones as sine and cosine, ``day_type`` one-hot, the rest min-max
  scaled by the observation space's limits.

Departures from CityLearn, each true of this district only: there is no
heating demand, heating device or heating tank, so every heating
quantity is 0 and is left out; no power outage is
simulated, so the flexibility cap is +inf; the tanks' input and output
powers are unbounded (the schema sets none); hours are whole, so
``time_step_ratio`` is 1 and left out; the LSTM's cell is written out as
``torch.nn.LSTM``'s equations (gate order i, f, g, o, separate input and
hidden biases) so that the control can round its products to TF32.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import battery as battery_model
from benchmark.reference.district import ONEHOT, PERIODIC, read_csv

ZERO = battery_model.ZERO
# CityLearn's observation-space constants (building.py:1010-1022)
MAX_TEMPERATURE_DELTA = 20.0
DEMAND_LIMIT_FACTOR = 1.15
DEFAULT_COMFORT_BAND = 2.0          # data.py's default where the CSV has none
STATE_OBSERVATIONS = {"electrical_storage_soc", "dhw_storage_soc", "cooling_storage_soc",
                      "heating_storage_soc", "net_electricity_consumption"}
DROPPED = {"net_electricity_consumption"}
CHANNEL_PERIOD = {"month": 12.0, "hour": 24.0, "day_type": 7.0}


@dataclass
class Building:
    name: str
    data: Dict[str, np.ndarray]           # the CSV columns, float64
    # battery (field names as reference.battery.Batteries reads them)
    capacity: float
    nominal_power: float
    efficiency: float
    loss_coefficient: float
    initial_soc: float
    depth_of_discharge: float
    capacity_loss_coefficient: float
    pec: np.ndarray
    cpc: np.ndarray
    pv_nominal_power: float
    cooling: Dict[str, float]             # heat pump: nominal_power, efficiency, target_cooling_temperature
    dhw_heater: Dict[str, float]          # electric heater: nominal_power, efficiency
    dhw_tank: Dict[str, float]            # capacity, efficiency, loss_coefficient, initial_soc
    heating_tank_capacity: float
    lstm: Dict[str, object]               # the dynamics block's attributes and the .pth state dict
    actions: List[str]
    observations: List[str]


@dataclass
class Model:
    """Every building's LSTM weights stacked on a leading building axis."""
    w_ih: List[torch.Tensor]              # per layer (B, 4H, F or H)
    w_hh: List[torch.Tensor]              # per layer (B, 4H, H)
    b_ih: List[torch.Tensor]              # per layer (B, 4H)
    b_hh: List[torch.Tensor]
    lin_w: torch.Tensor                   # (B, 1, H)
    lin_b: torch.Tensor                   # (B,)
    lo: torch.Tensor                      # (B, F) normalization minimum
    hi: torch.Tensor                      # (B, F) normalization maximum
    lookback: int
    temp_channel: int
    cooling_channel: int


@dataclass
class State:
    """One episode's position and what it carries, for D districts."""
    offset: torch.Tensor                  # (D,) int64 first data row of the episode
    t: int                                # hours into the episode (every district alike)
    soc: torch.Tensor                     # (D, B) battery
    eff: torch.Tensor
    deg: torch.Tensor
    dhw_soc: torch.Tensor                 # (D, B)
    h: torch.Tensor                       # (L, B, D, H) the LSTM's hidden state
    c: torch.Tensor
    window: torch.Tensor                  # (B, D, lookback + 1, F) normalized channels


@dataclass
class Out:
    reward: torch.Tensor                  # (D, B) ComfortReward
    temperature: torch.Tensor             # (D, B) indoor temperature (predicted once warm)
    net: torch.Tensor                     # (D, B) net electricity consumption
    cooling_demand: torch.Tensor          # (D, B) the demand the partial load set
    cooling: torch.Tensor                 # (D, B) cooling delivered
    heating: torch.Tensor                 # (D, B) the reward's heating flag


@dataclass
class District:
    buildings: List[Building]
    start: int
    end: int
    seconds_per_time_step: float
    reward: Dict[str, float]
    device: torch.device
    series: Dict[str, torch.Tensor] = field(default_factory=dict)   # (T, B) float32
    channels: torch.Tensor = None         # (T, B, F) normalized channels from the data
    model: Model = None
    batteries: battery_model.Batteries = None
    params: Dict[str, torch.Tensor] = field(default_factory=dict)   # (B,) device parameters

    @property
    def n_rows(self) -> int:
        return self.end - self.start + 1

    @property
    def action_names(self) -> List[str]:
        return self.buildings[0].actions


def load(schema_path: str, device) -> District:
    root = os.path.dirname(schema_path)
    with open(schema_path) as f:
        schema = json.load(f)
    actions = [k for k, v in schema["actions"].items() if v["active"]]
    observations = [k for k, v in schema["observations"].items() if v["active"]]
    start, end = schema["simulation_start_time_step"], schema["simulation_end_time_step"]
    buildings = []
    for name, e in schema["buildings"].items():
        if not e.get("include", True):
            continue
        data = {}
        for key in ("energy_simulation", "weather", "carbon_intensity", "pricing"):
            data.update(read_csv(os.path.join(root, e[key])))
        attrs = lambda block: e.get(block, {}).get("attributes", {}) or {}
        bat = attrs("electrical_storage")
        dyn = dict(e["dynamics"]["attributes"])
        dyn["state_dict"] = torch.load(os.path.join(root, dyn["filename"]), map_location="cpu")
        buildings.append(Building(
            name=name, data=data, capacity=float(bat["capacity"]),
            nominal_power=float(bat["nominal_power"]), efficiency=float(bat["efficiency"]),
            loss_coefficient=float(bat["loss_coefficient"]), initial_soc=float(bat["initial_soc"]),
            depth_of_discharge=float(bat.get("depth_of_discharge", 1.0)),
            capacity_loss_coefficient=float(bat["capacity_loss_coefficient"]),
            pec=np.asarray(bat["power_efficiency_curve"], np.float64),
            cpc=np.asarray(bat["capacity_power_curve"], np.float64),
            pv_nominal_power=float(attrs("pv")["nominal_power"]),
            cooling=attrs("cooling_device"), dhw_heater=attrs("dhw_device"),
            dhw_tank=attrs("dhw_storage"),
            heating_tank_capacity=float(attrs("heating_storage").get("capacity", 0.0)),
            lstm=dyn,
            actions=[k for k in actions if k not in e.get("inactive_actions", [])],
            observations=[k for k in observations if k not in e.get("inactive_observations", [])]))
    if len({tuple(b.actions) for b in buildings}) != 1:
        raise ValueError("the reference takes districts whose buildings share their actions")
    d = District(buildings, start, end, float(schema["seconds_per_time_step"]),
                 dict(schema["reward_function"].get("attributes") or {}), torch.device(device))
    _prepare(d)
    return d


def _column(b: Building, name: str, rows: slice) -> np.ndarray:
    """A data column over the simulation rows, float64 (PV in kW)."""
    if name == "solar_generation":
        return np.abs(b.pv_nominal_power * b.data["solar_generation"][rows] / 1000.0)
    if name == "comfort_band" and name not in b.data:
        return np.full(rows.stop - rows.start, DEFAULT_COMFORT_BAND)
    return b.data[name][rows]


def _prepare(d: District):
    dev, rows = d.device, slice(d.start, d.end + 1)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=torch.float32, device=dev)
    stack = lambda name: f32(np.stack([_column(b, name, rows) for b in d.buildings], 1))
    for name in ("non_shiftable_load", "cooling_demand", "dhw_demand", "solar_generation",
                 "outdoor_dry_bulb_temperature", "indoor_dry_bulb_temperature",
                 "indoor_dry_bulb_temperature_cooling_set_point",
                 "indoor_dry_bulb_temperature_heating_set_point", "comfort_band"):
        d.series[name] = stack(name)
    d.series["hvac_mode"] = stack("hvac_mode").round().long()
    d.batteries = battery_model.Batteries.of(d.buildings, dev)
    per = lambda get: f32([get(b) for b in d.buildings])
    d.params = {
        "cool_nominal": per(lambda b: b.cooling["nominal_power"]),
        "cool_efficiency": per(lambda b: b.cooling["efficiency"]),
        "cool_target": per(lambda b: b.cooling["target_cooling_temperature"]),
        "dhw_nominal": per(lambda b: b.dhw_heater["nominal_power"]),
        "dhw_efficiency": per(lambda b: b.dhw_heater["efficiency"]),
        "tank_capacity": per(lambda b: b.dhw_tank["capacity"]),
        "tank_efficiency": per(lambda b: b.dhw_tank["efficiency"]),
        "tank_loss": per(lambda b: b.dhw_tank["loss_coefficient"]),
        "tank_initial_soc": per(lambda b: b.dhw_tank["initial_soc"]),
        "heating_tank_capacity": per(lambda b: b.heating_tank_capacity),
    }

    # the LSTM: weights, normalization and the data-driven channels
    names = [list(b.lstm["input_observation_names"]) for b in d.buildings]
    shapes = {(int(b.lstm["num_layers"]), int(b.lstm["hidden_size"]), int(b.lstm["lookback"]))
              for b in d.buildings}
    if len({tuple(n) for n in names}) != 1 or len(shapes) != 1:
        raise ValueError("the reference takes districts whose LSTMs share their shape")
    names, ((L, H, lookback),) = names[0], shapes
    sd = [b.lstm["state_dict"] for b in d.buildings]
    w = lambda key: torch.stack([s[key].float() for s in sd]).to(dev)
    lo = f32([b.lstm["input_normalization_minimum"] for b in d.buildings]).float()
    hi = f32([b.lstm["input_normalization_maximum"] for b in d.buildings]).float()
    d.model = Model(
        w_ih=[w(f"l_lstm.weight_ih_l{l}") for l in range(L)],
        w_hh=[w(f"l_lstm.weight_hh_l{l}") for l in range(L)],
        b_ih=[w(f"l_lstm.bias_ih_l{l}") for l in range(L)],
        b_hh=[w(f"l_lstm.bias_hh_l{l}") for l in range(L)],
        lin_w=w("l_linear.weight"), lin_b=w("l_linear.bias")[:, 0], lo=lo, hi=hi,
        lookback=lookback, temp_channel=names.index("indoor_dry_bulb_temperature"),
        cooling_channel=names.index("cooling_demand"))

    def channel(b: Building, name: str) -> np.ndarray:
        for k, period in CHANNEL_PERIOD.items():
            if name in (f"{k}_sin", f"{k}_cos"):
                fn = np.sin if name.endswith("_sin") else np.cos
                return fn(2 * np.pi * b.data[k][rows] / period)
        return _column(b, name, rows)

    raw = f32(np.stack([np.stack([channel(b, n) for n in names], 1) for b in d.buildings], 1))
    d.channels = (raw - lo) / (hi - lo)                   # (T, B, F)


# --- the observations ------------------------------------------------------------

def _limits(b: Building, name: str, x: np.ndarray) -> Tuple[float, float]:
    """CityLearn's observation-space limits of one observation over the
    simulation rows (``building.py:1867-2160``, limit delta 0)."""
    if name in STATE_OBSERVATIONS or name == "power_outage":
        return 0.0, 1.0
    if name == "indoor_dry_bulb_temperature":
        return x.min() - MAX_TEMPERATURE_DELTA, x.max() + MAX_TEMPERATURE_DELTA
    if name == "indoor_dry_bulb_temperature_cooling_delta":
        return -MAX_TEMPERATURE_DELTA, MAX_TEMPERATURE_DELTA
    if name == "comfort_band":
        return 0.0, x.max()
    if name in ("cooling_demand", "dhw_demand"):
        return 0.0, x.max() * DEMAND_LIMIT_FACTOR
    return x.min(), x.max()


def _observation(b: Building, name: str, rows: slice) -> np.ndarray:
    """The data-driven value of an observation (float32 data, so that its
    limits are the float32 series')."""
    n = rows.stop - rows.start
    if name in STATE_OBSERVATIONS:
        return np.zeros(n)
    if name == "power_outage":           # not simulated in this district
        return np.zeros(n)
    if name == "indoor_dry_bulb_temperature_cooling_delta":
        f = lambda k: b.data[k][rows].astype(np.float32)
        return (f("indoor_dry_bulb_temperature")
                - f("indoor_dry_bulb_temperature_cooling_set_point")).astype(np.float64)
    return _column(b, name, rows).astype(np.float32).astype(np.float64)


def observation_table(d: District) -> torch.Tensor:
    """(T, B * K) float32: every building's encoded observation row at each
    simulation row, buildings side by side."""
    rows = slice(d.start, d.end + 1)
    cols = []
    for b in d.buildings:
        for name in b.observations:
            if name in DROPPED:
                continue
            raw = _observation(b, name, rows)
            x = torch.tensor(raw, dtype=torch.float32, device=d.device)
            if name in PERIODIC:
                ang = 2 * math.pi * x / PERIODIC[name]
                cols += [torch.sin(ang), torch.cos(ang)]
            elif name in ONEHOT:
                cols += [(x == c).float() for c in ONEHOT[name]]
            else:
                lo, hi = (np.float32(v) for v in _limits(b, name, raw))
                cols.append(torch.zeros_like(x) if lo == hi
                            else (x - float(lo)) / (float(hi) - float(lo)))
    return torch.stack(cols, 1)


def action_bounds(d: District) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M) low and high of each building's actions
    (``building.py:2161-2282``): a device's fraction of its power in [0, 1];
    a tank's in +-min(its device's power over its capacity, 1); the
    battery's in [-1, 1]."""
    low, high = [], []
    for b in d.buildings:
        lo, hi = [], []
        for a in b.actions:
            if a in ("cooling_device", "heating_device"):
                lo.append(0.0), hi.append(1.0)
            elif a == "electrical_storage":
                lo.append(-1.0), hi.append(1.0)
            elif a == "dhw_storage":
                lim = min(b.dhw_heater["nominal_power"] / max(b.dhw_tank["capacity"], ZERO), 1.0)
                lo.append(-lim), hi.append(lim)
            else:
                raise ValueError(f"the reference has no action {a}")
        low.append(lo), high.append(hi)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=d.device)
    return t(low), t(high)


# --- one hour ---------------------------------------------------------------------

def initial(d: District, offset: torch.Tensor) -> State:
    """An episode's start from data rows ``offset`` (D,)."""
    D, B, m = offset.shape[0], len(d.buildings), d.model
    tile = lambda v: v[None].expand(D, B).clone()
    L, H, F = len(m.w_ih), m.w_hh[0].shape[-1], m.lo.shape[-1]
    zeros = lambda *s: torch.zeros(s, device=d.device)
    return State(offset=offset.long(), t=0, soc=tile(d.batteries.initial_soc),
                 eff=tile(d.batteries.efficiency), deg=tile(d.batteries.capacity),
                 dhw_soc=tile(d.params["tank_initial_soc"]), h=zeros(L, B, D, H),
                 c=zeros(L, B, D, H), window=zeros(B, D, m.lookback + 1, F))


def cop(d: District, outdoor: torch.Tensor) -> torch.Tensor:
    """The cooling heat pump's Carnot COP, set to 20 where it is negative,
    above 20 or not finite."""
    p = d.params
    c = p["cool_efficiency"] * (p["cool_target"] + 273.15) / (outdoor - p["cool_target"])
    return torch.where(torch.isfinite(c) & (c >= 0) & (c <= 20), c, torch.full_like(c, 20.0))


def tank(d: District, soc, energy):
    """The DHW tank's charge (energy >= 0) or discharge: (soc, balance)."""
    p = d.params
    cap, rt = p["tank_capacity"], torch.sqrt(p["tank_efficiency"])
    before = torch.clamp(soc * cap * (1.0 - p["tank_loss"]), min=0.0)
    after = torch.where(energy >= 0, torch.minimum(before + energy * rt, cap),
                        torch.clamp(before + energy / rt, min=0.0))
    delta = after - before
    return after / torch.clamp(cap, min=ZERO), torch.where(delta >= 0, delta / rt, delta * rt)


def lstm(m: Model, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, mm: Callable):
    """``torch.nn.LSTM`` and its linear head over ``x`` (B, D, S, F) from
    (h, c) (L, B, D, H): the normalized prediction (B, D) and the new
    (h, c)."""
    hs, cs = [], []
    for l in range(len(m.w_ih)):
        hl, cl, ys = h[l], c[l], []
        for s in range(x.shape[2]):
            gates = (mm(x[:, :, s], m.w_ih[l].transpose(1, 2)) + m.b_ih[l][:, None]
                     + mm(hl, m.w_hh[l].transpose(1, 2)) + m.b_hh[l][:, None])
            i, f, g, o = gates.chunk(4, -1)
            cl = torch.sigmoid(f) * cl + torch.sigmoid(i) * torch.tanh(g)
            hl = torch.sigmoid(o) * torch.tanh(cl)
            ys.append(hl)
        x = torch.stack(ys, 2)
        hs.append(hl), cs.append(cl)
    pred = mm(x[:, :, -1], m.lin_w.transpose(1, 2))[..., 0] + m.lin_b[:, None]
    return pred, torch.stack(hs), torch.stack(cs)


def comfort(d: District, rows: torch.Tensor, temperature: torch.Tensor,
            heating: torch.Tensor) -> torch.Tensor:
    """``ComfortReward`` of the indoor temperature (D, B) at data rows
    ``rows`` (D,); ``heating`` (D, B): heating demand above cooling demand
    (:func:`heating_flag`)."""
    s = {k: v[rows] for k, v in d.series.items()}
    T, mode = temperature, s["hvac_mode"]
    band = d.reward.get("band")
    band = s["comfort_band"] if band is None else torch.full_like(T, float(band))
    lower = float(d.reward.get("lower_exponent", 2.0))
    higher = float(d.reward.get("higher_exponent", 3.0))
    csp = s["indoor_dry_bulb_temperature_cooling_set_point"]
    hsp = s["indoor_dry_bulb_temperature_heating_set_point"]
    zero = torch.zeros_like(T)
    pick = lambda cond, a, b: torch.where(cond, torch.full_like(T, a), torch.full_like(T, b))

    # one set point: cooling (mode 1) or heating (mode 2)
    sp = torch.where(mode == 1, csp, hsp)
    dev = torch.abs(T - sp)
    single = torch.where(
        T < sp - band, -dev ** pick(mode == 2, lower, higher),
        torch.where(T < sp, torch.where(heating, zero, -dev),
                    torch.where(T <= sp + band, torch.where(heating, -dev, zero),
                                -dev ** pick(heating, higher, lower))))
    # off (0) or auto (3): the dead band between the two set points
    cdev, hdev = torch.abs(T - csp), torch.abs(T - hsp)
    dual = torch.where(
        T < hsp - band, -hdev ** pick(heating, lower, higher),
        torch.where(T < hsp, -hdev,
                    torch.where(T <= csp, zero,
                                torch.where(T < csp + band, -cdev,
                                            -cdev ** pick(heating, higher, lower)))))
    return torch.where((mode == 1) | (mode == 2), single, dual)


def step(d: District, s: State, actions: torch.Tensor, mm: Callable = torch.matmul,
         carry: bool = True) -> Tuple[State, Out]:
    """One hour of every district under ``actions`` (D, B, M), in the
    order of :attr:`District.action_names`. ``carry=False`` is a fault:
    the LSTM starts each hour from a zero hidden state."""
    rows = s.offset + s.t
    at = lambda name: d.series[name][rows]
    p, m = d.params, d.model
    first = s.t == 0
    act = {name: actions[..., i] for i, name in enumerate(d.action_names)}
    zero = torch.zeros_like(at("non_shiftable_load"))
    nsl, ideal, dhw_demand = at("non_shiftable_load"), at("cooling_demand"), at("dhw_demand")
    outdoor, solar = at("outdoor_dry_bulb_temperature"), at("solar_generation")
    cp = cop(d, outdoor)

    # the first hour's consumption booked at reset from the ideal demands
    reset_cool = ideal / cp if first else zero
    reset_dhw = dhw_demand / p["dhw_efficiency"] if first else zero

    # partial load
    if s.t >= m.lookback + 1:
        power = torch.minimum(act.get("cooling_device", zero) * p["cool_nominal"],
                              p["cool_nominal"] - reset_cool)
        mode = at("hvac_mode")
        demand = torch.where((mode == 1) | (mode == 3), power * cp, zero)
    else:
        demand = ideal

    # the battery (the energy it draws is the same whether it runs first,
    # discharging, or last, charging: nothing caps a charge here)
    energy = act["electrical_storage"] * d.batteries.nominal_power * (d.seconds_per_time_step / 3600)
    soc, eff, deg, bat_balance = battery_model.charge(d.batteries, s.soc, s.eff, s.deg, energy)

    # cooling: the heat pump, no tank
    cooling = torch.minimum(demand, (p["cool_nominal"] - reset_cool) * cp)
    cool_cons = cooling / cp

    # DHW: the heater and its tank, in the order the tank's action sets
    request = act.get("dhw_storage", zero) * p["heating_tank_capacity"]
    heater_cap = lambda drawn: (p["dhw_nominal"] - drawn) * p["dhw_efficiency"]
    # charging (action >= 0): the heater meets the demand, then charges the tank
    out_c = torch.minimum(dhw_demand, heater_cap(reset_dhw))
    drawn_c = out_c / p["dhw_efficiency"]
    soc_c, bal_c = tank(d, s.dhw_soc, torch.minimum(heater_cap(reset_dhw + drawn_c), request))
    # discharging: the tank meets what it can, the heater the rest
    soc_d, bal_d = tank(d, s.dhw_soc, torch.maximum(-dhw_demand, request))
    tank_drawn_d = torch.clamp(bal_d, min=0.0) / p["dhw_efficiency"]
    out_d = torch.minimum(dhw_demand + torch.clamp(bal_d, max=0.0),
                          heater_cap(reset_dhw + tank_drawn_d))
    discharging = act.get("dhw_storage", zero) < 0
    dhw_soc = torch.where(discharging, soc_d, soc_c)
    dhw_balance = torch.where(discharging, bal_d, bal_c)
    dhw_out = torch.where(discharging, out_d, out_c)
    dhw_cons = dhw_out / p["dhw_efficiency"] + torch.clamp(dhw_balance, min=0.0) / p["dhw_efficiency"]

    # net consumption, with the first hour's repeated bookings
    if first:
        cool_cons = cool_cons + reset_cool + cooling / cp
        dhw_cons = dhw_cons + reset_dhw + (dhw_out + dhw_balance) / p["dhw_efficiency"]
        nsl_cons, bat_cons = 3.0 * nsl, 2.0 * bat_balance
    else:
        nsl_cons, bat_cons = nsl, bat_balance
    net = cool_cons + dhw_cons + nsl_cons + bat_cons - solar

    # the LSTM's indoor temperature
    v = d.channels[rows].transpose(0, 1).clone()                 # (B, D, F)
    norm = lambda x, ch: (x.t() - m.lo[:, ch, None]) / (m.hi[:, ch, None] - m.lo[:, ch, None])
    v[..., m.cooling_channel] = norm(cooling, m.cooling_channel)
    v[..., m.temp_channel] = norm(at("indoor_dry_bulb_temperature"), m.temp_channel)
    window = torch.cat([s.window[:, :, 1:], v[:, :, None]], 2)
    h, c = s.h, s.c
    temperature = at("indoor_dry_bulb_temperature")
    if s.t >= m.lookback:
        x = window[:, :, 1:].clone()
        x[..., m.temp_channel] = window[:, :, :-1, m.temp_channel]
        if not carry:
            h, c = torch.zeros_like(h), torch.zeros_like(c)
        pred, h, c = lstm(m, x, h, c, mm)
        window[:, :, -1, m.temp_channel] = pred
        tc = m.temp_channel
        temperature = (pred * (m.hi[:, tc, None] - m.lo[:, tc, None]) + m.lo[:, tc, None]).t()

    new = State(offset=s.offset, t=s.t + 1, soc=soc, eff=eff, deg=deg, dhw_soc=dhw_soc,
                h=h, c=c, window=window)
    heating = heating_flag(cooling)
    return new, Out(reward=comfort(d, rows, temperature, heating), temperature=temperature,
                    net=net, cooling_demand=demand, cooling=cooling, heating=heating)


def heating_flag(cooling: torch.Tensor) -> torch.Tensor:
    """The reward's heating flag, heating demand above cooling demand (the
    delivered cooling): with no heating demand, true only where the
    delivered cooling is negative, which happens at an episode's first hour
    when the ideal demand's consumption booked at reset exceeds the heat
    pump's nominal power."""
    return cooling < 0
