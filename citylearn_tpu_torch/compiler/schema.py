"""Schema compiler: ``schema.json`` + CSVs -> :class:`DistrictSpec`.

The counterpart of ``citylearn_tpu.compiler.schema`` for the districts
the port carries (battery+PV, thermal storage, EV chargers with
electric vehicles, washing machines and charging constraints, and LSTM
temperature dynamics with power outages, and occupant thermostat
interaction): the same device resolution, series defaults, noise stream
and observation/action surface, with CSVs read by the standard ``csv``
module instead of pandas. Schema blocks outside those districts raise
``NotImplementedError`` naming the block: autosizing. Missing HVAC devices and tanks
resolve to the same inert defaults as in the JAX package.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from citylearn_tpu_torch.compiler import seeding
from citylearn_tpu_torch.compiler.spaces import (
    estimate_action_space,
    estimate_observation_space_limits,
)
from citylearn_tpu_torch.compiler.spec import (
    CURVE_PAD,
    DEFAULT_COMFORT_BAND,
    BatterySpec,
    BuildingSpec,
    ChargerSpec,
    DistrictSpec,
    DynamicsSpec,
    ElectricVehicleSpec,
    HVACDeviceSpec,
    OccupantSpec,
    StorageTankSpec,
    WashingMachineSpec,
)
from citylearn_tpu_torch.utilities import NoiseUtils

# CSV -> series field lists (reference citylearn/data.py:341-661)
WEATHER_FIELDS = [
    "outdoor_dry_bulb_temperature", "outdoor_relative_humidity",
    "diffuse_solar_irradiance", "direct_solar_irradiance",
] + [
    f"{base}_predicted_{i}"
    for base in ("outdoor_dry_bulb_temperature", "outdoor_relative_humidity",
                 "diffuse_solar_irradiance", "direct_solar_irradiance")
    for i in (1, 2, 3)
]
PRICING_FIELDS = ["electricity_pricing"] + [f"electricity_pricing_predicted_{i}" for i in (1, 2, 3)]

# charger helper observations -> per-charger names (reference
# citylearn.py:2010-2030, building.py:1221-1331)
CHARGER_OBS_EXPANSION = [
    ("electric_vehicle_charger_connected_state",
     "electric_vehicle_charger_{id}_connected_state"),
    ("connected_electric_vehicle_at_charger_departure_time",
     "connected_electric_vehicle_at_charger_{id}_departure_time"),
    ("connected_electric_vehicle_at_charger_required_soc_departure",
     "connected_electric_vehicle_at_charger_{id}_required_soc_departure"),
    ("connected_electric_vehicle_at_charger_soc",
     "connected_electric_vehicle_at_charger_{id}_soc"),
    ("connected_electric_vehicle_at_charger_battery_capacity",
     "connected_electric_vehicle_at_charger_{id}_battery_capacity"),
    ("electric_vehicle_charger_incoming_state",
     "electric_vehicle_charger_{id}_incoming_state"),
    ("incoming_electric_vehicle_at_charger_estimated_arrival_time",
     "incoming_electric_vehicle_at_charger_{id}_estimated_arrival_time"),
    ("incoming_electric_vehicle_at_charger_estimated_soc_arrival",
     "incoming_electric_vehicle_at_charger_{id}_estimated_soc_arrival"),
]

Table = Dict[str, np.ndarray]


def read_csv_columns(path: str) -> Table:
    """Read a CSV into one array per column. Numeric columns become
    float64 with empty cells as NaN (``pandas.read_csv``'s numeric parse);
    any other column stays an array of strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    table: Table = {}
    for j, name in enumerate(header):
        raw = np.array([r[j].strip() for r in body], dtype=str)
        try:
            table[name] = np.where(raw == "", "nan", raw).astype(np.float64)
        except ValueError:
            table[name] = raw
    return table


def _read_csv(cache: Dict[str, Table], root: str, filename: str) -> Table:
    path = os.path.join(root, filename)
    if path not in cache:
        cache[path] = read_csv_columns(path)
    return cache[path]


def _read_csv_raw(path: str) -> Dict[str, List[str]]:
    """One list of unparsed cells per column."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {name: [r[j] for r in rows[1:]] for j, name in enumerate(rows[0])}


_INT_CELL = re.compile(r"[+-]?\d+")


def _load_charger_sim(path: str, sim_start: int, sim_end: int,
                      ev_name_to_index: dict, noise_std: float,
                      noise_rng: Optional[np.random.RandomState] = None) -> dict:
    """Parse a charger schedule CSV with the reference's normalization
    (reference ``data.py:663-768``). ``noise_std`` adds seeded Gaussian
    noise (scaled by 1/100, clipped to [0, 1]) to the required/estimated
    SOC columns (``data.py:748-768``); the reference draws on the full
    CSV length from the global RNG, replicated here from the compile-time
    seeded stream.

    The state and EV-id columns follow what ``pandas.read_csv`` hands the
    reference: a state column parses (``int(str(s))`` when ``isdigit``)
    only when pandas types it as integers, that is when every cell is an
    integer literal, or as strings; a column with an empty cell is float
    there and every state reads NaN. EV ids resolve only from a column
    pandas keeps as strings."""
    full = read_csv_columns(path)
    raw = _read_csv_raw(path)
    n_full = len(raw["electric_vehicle_charger_state"])
    noise = NoiseUtils.make_noise_fn(noise_std, noise_rng)

    def soc_noised(name):
        col = full[name].astype(float)
        col = np.where(np.isnan(col), -0.1, col)
        nz = noise(n_full)
        return np.where(col != -0.1, np.clip(col / 100.0 + nz / 100.0, 0, 1), col)

    req_full = soc_noised("electric_vehicle_required_soc_departure")
    est_full = soc_noised("electric_vehicle_estimated_soc_arrival")
    sl = slice(sim_start, sim_end + 1)
    state_cells = [c.strip() for c in raw["electric_vehicle_charger_state"]]
    state_is_float = (full["electric_vehicle_charger_state"].dtype.kind == "f"
                      and not all(_INT_CELL.fullmatch(c) for c in state_cells))
    state = np.array([np.nan if state_is_float or not c.isdigit() else int(c)
                      for c in state_cells[sl]], dtype=float)
    ids_are_strings = full["electric_vehicle_id"].dtype.kind != "f"
    ids = raw["electric_vehicle_id"][sl]
    numeric = lambda name: full[name].astype(float)[sl]
    cap = numeric("electric_vehicle_battery_capacity_khw")
    soc_now = numeric("current_soc")
    soc_now = np.where(np.isnan(soc_now), -0.1, soc_now)
    with np.errstate(divide="ignore", invalid="ignore"):
        current_soc = np.clip(soc_now / cap, 0, 1)
    dep = numeric("electric_vehicle_departure_time")
    dep = np.where(np.isnan(dep), -1, dep).astype(int)
    arr = numeric("electric_vehicle_estimated_arrival_time")
    arr = np.where(np.isnan(arr), -1, arr).astype(int)

    def resolve_ids(want_state):
        out = np.full(len(state), -1, np.int32)
        for i, (s, ev_id) in enumerate(zip(state, ids)):
            if s == want_state and ids_are_strings \
                    and ev_id.strip() not in ("", "nan") and ev_id in ev_name_to_index:
                out[i] = ev_name_to_index[ev_id]
        return out

    return dict(state=state, connected_ev=resolve_ids(1),
                incoming_ev=resolve_ids(2), capacity_kwh=cap,
                current_soc=current_soc, departure_time=dep, required_soc=req_full[sl],
                arrival_time=arr, estimated_soc_arrival=est_full[sl])


def _load_profile(cell: str) -> np.ndarray:
    """A washing machine's ``load_profile`` cell, a Python list literal;
    anything else is an empty profile."""
    try:
        return np.array(ast.literal_eval(cell.strip()), dtype=float)
    except (ValueError, SyntaxError, TypeError):
        return np.array([], dtype=float)


def _series_from_energy_csv(df: Table, noise_std: float = 0.0,
                            noise_rng: Optional[np.random.RandomState] = None
                            ) -> Dict[str, np.ndarray]:
    """Build energy-simulation series with the reference's defaults/clips
    (``citylearn/data.py:399-493``), including load-time Gaussian
    observation noise. Noise draws follow the reference constructor order
    (temperature -> solar -> humidity, ``data.py:409-461``) from one
    seeded stream — the reference draws from the *unseeded* global RNG
    (``utilities.py:148-171``), so the seeded stream here corresponds to
    calling ``np.random.seed(random_seed)`` right before reference env
    construction."""
    n = len(df["hour"])
    out: Dict[str, np.ndarray] = {}
    noise = NoiseUtils.make_noise_fn(noise_std, noise_rng)

    def col(name, dtype, default=None):
        if name in df and not np.isnan(df[name]).all():
            return df[name].astype(dtype)
        return None if default is None else np.full(n, default, dtype=dtype)

    for k in ["month", "hour", "day_type"]:
        out[k] = df[k].astype(np.int32)
    if "minutes" in df:
        out["minutes"] = df["minutes"].astype(np.int32)
    out["daylight_savings_status"] = col("daylight_savings_status", np.int32, 0)
    # the reference draws noise whenever the CSV *column* exists — even
    # all-NaN columns — so stream position parity requires consuming
    # draws on presence, applying them only to valid data
    idt = col("indoor_dry_bulb_temperature", np.float32)
    idt_noise = noise(n)
    out["indoor_dry_bulb_temperature"] = (
        np.zeros(n, np.float32) if idt is None
        else np.clip(idt + idt_noise, -90, 57).astype(np.float32))
    out["average_unmet_cooling_setpoint_difference"] = col(
        "average_unmet_cooling_setpoint_difference", np.float32, 0.0)
    for k in ["non_shiftable_load", "dhw_demand", "cooling_demand", "heating_demand",
              "solar_generation"]:
        v = col(k, np.float32, 0.0)
        out[k] = np.nan_to_num(v, nan=0.0) if k != "solar_generation" else v
    # solar noise is shaped from the temperature column (data.py:423 quirk)
    out["solar_generation"] = (out["solar_generation"]
                               + noise(n)).astype(np.float32)
    irh = col("indoor_relative_humidity", np.float32)
    irh_noise = noise(n) if "indoor_relative_humidity" in df else 0.0
    out["indoor_relative_humidity"] = (
        np.zeros(n, np.float32) if irh is None
        else np.clip(irh + irh_noise, 0, 100).astype(np.float32))
    if float((out["cooling_demand"] * out["heating_demand"]).sum()) != 0.0:
        raise ValueError("Cooling and heating in the same time step is not allowed.")
    out["occupant_count"] = col("occupant_count", np.float32, 0.0)
    out["indoor_dry_bulb_temperature_cooling_set_point"] = col(
        "indoor_dry_bulb_temperature_cooling_set_point", np.float32, 0.0)
    out["indoor_dry_bulb_temperature_heating_set_point"] = col(
        "indoor_dry_bulb_temperature_heating_set_point", np.float32, 0.0)
    out["power_outage"] = col("power_outage", np.float32, 0.0)
    cb = col("comfort_band", np.float32)
    out["comfort_band"] = (
        np.full(n, DEFAULT_COMFORT_BAND, np.float32) if cb is None else cb)
    hm = col("hvac_mode", np.int32)
    out["hvac_mode"] = np.ones(n, np.int32) if hm is None else hm
    return out


def _load_dynamics(block: dict, root: str) -> DynamicsSpec:
    """Parse an LSTM dynamics block and load its ``.pth`` weights
    (reference ``citylearn.py:2216-2227``, ``dynamics.py:112-127``)."""
    import torch

    attrs = dict(block["attributes"])
    path = os.path.join(root, attrs["filename"])
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    num_layers = int(attrs["num_layers"])
    spec = DynamicsSpec(
        input_observation_names=list(attrs["input_observation_names"]),
        norm_min=np.asarray(attrs["input_normalization_minimum"], np.float32),
        norm_max=np.asarray(attrs["input_normalization_maximum"], np.float32),
        hidden_size=int(attrs["hidden_size"]),
        num_layers=num_layers,
        lookback=int(attrs["lookback"]),
    )
    for l in range(num_layers):
        spec.w_ih.append(sd[f"l_lstm.weight_ih_l{l}"].numpy().astype(np.float32))
        spec.w_hh.append(sd[f"l_lstm.weight_hh_l{l}"].numpy().astype(np.float32))
        spec.bias.append((sd[f"l_lstm.bias_ih_l{l}"] + sd[f"l_lstm.bias_hh_l{l}"])
                         .numpy().astype(np.float32))
    spec.lin_w = sd["l_linear.weight"].numpy().astype(np.float32).reshape(-1)
    spec.lin_b = float(sd["l_linear.bias"].numpy().reshape(-1)[0])
    return spec


def _load_occupant(block: dict, root: str, sim_start: int, sim_end: int) -> OccupantSpec:
    """Parse an occupant block: the logistic parameters CSV and the two
    pickled ``DecisionTreeClassifier``s flattened to node arrays
    (reference ``citylearn.py:2230-2250``, ``occupant.py:18-99``).
    Unpickling the trees needs scikit-learn, imported by ``pickle`` only
    when a tree file is present."""
    import pickle
    import warnings

    attrs = dict(block.get("attributes") or {})
    params = read_csv_columns(os.path.join(root, block["parameters_filename"]))
    sl = slice(sim_start, sim_end + 1)
    delta_map = {int(k): float(v) for k, v in (attrs.get("delta_output_map") or {}).items()}

    def flatten_tree(path):
        if not os.path.exists(path):
            # the bundled quebec datasets ship without the pickled trees
            # (the reference crashes outright); degrade to an inert
            # single-leaf tree predicting delta 0
            warnings.warn(f"occupant model {os.path.basename(path)} missing; "
                          "using inert tree (delta 0)")
            return (np.asarray([-1], np.int32), np.asarray([-1], np.int32),
                    np.asarray([-2], np.int32), np.asarray([0.0], np.float32),
                    np.asarray([0.0], np.float32), 1)
        with open(path, "rb") as f:
            clf = pickle.load(f)
        t = clf.tree_
        classes = clf.classes_
        delta = np.zeros(t.node_count, np.float32)
        for node in range(t.node_count):
            cls = classes[int(np.argmax(t.value[node]))]
            delta[node] = delta_map.get(int(cls), 0.0)
        return (t.children_left.astype(np.int32), t.children_right.astype(np.int32),
                t.feature.astype(np.int32), t.threshold.astype(np.float32),
                delta, int(t.max_depth))

    inc = flatten_tree(os.path.join(root, attrs["setpoint_increase_model_filename"]))
    dec = flatten_tree(os.path.join(root, attrs["setpoint_decrease_model_filename"]))
    n = max(len(inc[0]), len(dec[0]))
    pad = lambda a, fill: np.pad(a, (0, n - len(a)), constant_values=fill)
    column = lambda name: params[name].astype(np.float32)[sl]
    hold = attrs.get("set_point_hold_time_steps")
    return OccupantSpec(
        a_increase=column("a_increase"),
        b_increase=column("b_increase"),
        a_decrease=column("a_decrease"),
        b_decrease=column("b_decrease"),
        tree_children_left=np.stack([pad(inc[0], -1), pad(dec[0], -1)]),
        tree_children_right=np.stack([pad(inc[1], -1), pad(dec[1], -1)]),
        tree_feature=np.stack([pad(inc[2], -2), pad(dec[2], -2)]),
        tree_threshold=np.stack([pad(inc[3], 0.0), pad(dec[3], 0.0)]),
        tree_delta=np.stack([pad(inc[4], 0.0), pad(dec[4], 0.0)]),
        max_depth=max(inc[5], dec[5]),
        set_point_hold_time_steps=(2 ** 30 if hold is None else int(hold)),
    )


def _unsupported(block: str, building: str = None):
    where = f" (building {building})" if building else ""
    raise NotImplementedError(
        f"schema block '{block}'{where} is not supported by the PyTorch "
        "port yet")


def _resolve_hvac(block: Optional[dict], seed: Optional[int]) -> HVACDeviceSpec:
    if block is None:
        # Missing device: the reference constructs HeatPump(0.0)/ElectricHeater(0.0)
        # with an *unseeded* (non-reproducible) efficiency sample
        # (building.py:721-747). nominal_power == 0 makes it inert; we pick the
        # range midpoint deterministically.
        return HVACDeviceSpec(is_heat_pump=True, nominal_power=0.0, efficiency=0.25,
                              target_cooling_temperature=8.5, target_heating_temperature=47.5)
    attrs = dict(block.get("attributes") or {})
    is_heat_pump = block["type"].rsplit(".", 1)[-1] == "HeatPump"
    if is_heat_pump:
        eff = seeding.resolve(attrs.get("efficiency"), (0.2, 0.3), seed)
        tct = seeding.resolve(attrs.get("target_cooling_temperature"), (7.0, 10.0), seed)
        tht = seeding.resolve(attrs.get("target_heating_temperature"), (45.0, 50.0), seed)
    else:
        eff = seeding.resolve(attrs.get("efficiency"), (0.9, 0.99), seed)  # energy_model.py:376
        tct, tht = 8.5, 47.5
    return HVACDeviceSpec(
        is_heat_pump=is_heat_pump,
        nominal_power=float(attrs.get("nominal_power") or 0.0),
        efficiency=eff,
        target_cooling_temperature=tct,
        target_heating_temperature=tht,
    )


def _resolve_storage_tank(block: Optional[dict], seed: Optional[int],
                          time_step_ratio: float) -> StorageTankSpec:
    if block is None:
        return StorageTankSpec(capacity=0.0, efficiency=0.94, loss_coefficient=0.005,
                               initial_soc=0.0)
    attrs = dict(block.get("attributes") or {})
    eff = seeding.resolve(attrs.get("efficiency"), (0.90, 0.98), seed)
    loss = seeding.resolve(attrs.get("loss_coefficient"), (0.001, 0.009), seed)
    init = seeding.resolve(attrs.get("initial_soc"), 0.0, seed)
    mip = attrs.get("max_input_power")
    mop = attrs.get("max_output_power")
    return StorageTankSpec(
        capacity=float(attrs.get("capacity") or 0.0),
        efficiency=eff,
        loss_coefficient=loss * time_step_ratio,  # reference energy_model.py:647
        initial_soc=init,
        max_input_power=float("inf") if mip is None else float(mip),
        max_output_power=float("inf") if mop is None else float(mop),
    )


def _resolve_battery(block: Optional[dict], seed: Optional[int],
                     time_step_ratio: float) -> BatterySpec:
    spec = BatterySpec()
    attrs = dict((block or {}).get("attributes") or {})
    # Order mirrors Battery.__init__ (energy_model.py:896-906); every tuple
    # sample draws from a fresh RandomState(seed) so order does not matter
    # for reproducibility, but defaults do.
    spec.depth_of_discharge = seeding.resolve(attrs.get("depth_of_discharge"), 1.0, seed)
    # provenance: tuple-sampled values are strong np.float64 in the
    # reference; schema literals stay weak Python floats (parity mode)
    spec.dod_weak = not isinstance(attrs.get("depth_of_discharge"), (list, tuple))
    spec.capacity = float(attrs.get("capacity") or 0.0)
    spec.nominal_power = float(attrs.get("nominal_power") or 0.0)
    spec.efficiency = seeding.resolve(attrs.get("efficiency"), (0.90, 0.98), seed)
    spec.loss_coefficient = (
        seeding.resolve(attrs.get("loss_coefficient"), (0.001, 0.009), seed) * time_step_ratio)
    init = attrs.get("initial_soc")
    spec.initial_soc = (1.0 - spec.depth_of_discharge if init is None
                        else seeding.resolve(init, 0.0, seed))
    spec.capacity_loss_coefficient = seeding.resolve(
        attrs.get("capacity_loss_coefficient"), (1e-5, 1e-4), seed)

    pec = attrs.get("power_efficiency_curve")
    if pec is None:
        if seed is None:
            raise ValueError("default battery curves require a device seed")
        pec = seeding.default_power_efficiency_curve(spec.efficiency, seed)
    cpc = attrs.get("capacity_power_curve")
    if cpc is None:
        if seed is None:
            raise ValueError("default battery curves require a device seed")
        cpc = seeding.default_capacity_power_curve(seed)
    spec.power_efficiency_curve_x, spec.power_efficiency_curve_y = seeding.pad_curve(pec, CURVE_PAD)
    spec.capacity_power_curve_x, spec.capacity_power_curve_y = seeding.pad_curve(cpc, CURVE_PAD)
    return spec


def _null_battery() -> BatterySpec:
    """Battery(0.0, 0.0) default for buildings without electrical storage.

    The reference samples its curves with an unseeded RandomState
    (non-reproducible); with zero capacity/power the curves never matter,
    so we use the shape defaults at efficiency 0.94 deterministically.
    """
    spec = BatterySpec(capacity=0.0, nominal_power=0.0, efficiency=0.94,
                       loss_coefficient=0.005, initial_soc=0.0)
    pec = [[0.0, 0.80], [0.3, 0.85], [0.7, 0.92], [0.8, 0.94], [1.0, 0.90]]
    cpc = [[0.0, 1.0], [0.8, 0.92], [1.0, 0.25]]
    spec.power_efficiency_curve_x, spec.power_efficiency_curve_y = seeding.pad_curve(pec, CURVE_PAD)
    spec.capacity_power_curve_x, spec.capacity_power_curve_y = seeding.pad_curve(cpc, CURVE_PAD)
    return spec


def compile_schema(schema_path_or_dict, root_directory: str = None, **overrides) -> DistrictSpec:
    """Compile a CityLearn schema into a :class:`DistrictSpec`.

    Parameters mirror ``CityLearnEnv.__init__`` overrides: any of
    ``central_agent``, ``simulation_start_time_step``,
    ``simulation_end_time_step``, ``episode_time_steps``,
    ``rolling_episode_split``, ``random_episode_split``, ``random_seed``
    may be passed as keyword overrides (reference ``citylearn.py:2006-2051``).
    """
    if isinstance(schema_path_or_dict, dict):
        schema = dict(schema_path_or_dict)
        if root_directory is None and not schema.get("root_directory"):
            raise ValueError("root_directory required when schema is a dict")
    else:
        schema_path = str(schema_path_or_dict)
        with open(schema_path) as f:
            schema = json.load(f)
        if root_directory is None and not schema.get("root_directory"):
            root_directory = os.path.dirname(os.path.abspath(schema_path))
    root = root_directory or schema.get("root_directory")

    def get(key, default=None):
        if key in overrides and overrides[key] is not None:
            return overrides[key]
        v = schema.get(key)
        return default if v is None else v

    # Env-level seed honors the constructor override (reference
    # citylearn.py:170), but device-seed hashing always uses the schema's own
    # seed: citylearn.py:2007 assigns schema['random_seed'] from the schema in
    # *both* branches, so the override never reaches the md5 hash.
    random_seed = int(get("random_seed", 0))
    schema_random_seed = int(schema.get("random_seed") or 0)
    # one seeded stream for all load-time observation noise, consumed in
    # building/constructor order (citylearn.py:2180-2206)
    noise_rng = np.random.RandomState(random_seed)
    central_agent = bool(get("central_agent", False))
    seconds_per_time_step = float(get("seconds_per_time_step", 3600.0))
    sim_start = int(get("simulation_start_time_step", 0))
    sim_end = int(get("simulation_end_time_step"))
    episode_time_steps = get("episode_time_steps")
    rolling = bool(get("rolling_episode_split", False))
    random_split = bool(get("random_episode_split", False))

    # split charger/washing-machine helper entries out of the base obs/action
    # schema (reference citylearn.py:2010-2030); they expand per charger/WM.
    raw_obs = schema["observations"]
    raw_act = schema["actions"]
    charger_obs_helper = {k: v for k, v in raw_obs.items() if "electric_vehicle_" in k}
    wm_obs_helper = {k: v for k, v in raw_obs.items() if "washing_machine_" in k}
    charger_act_helper = {k: v for k, v in raw_act.items() if "electric_vehicle_" in k}
    wm_act_helper = {k: v for k, v in raw_act.items() if "washing_machine" in k}
    obs_schema = {k: v for k, v in raw_obs.items()
                  if k not in charger_obs_helper and k not in wm_obs_helper}
    act_schema = {k: v for k, v in raw_act.items()
                  if k not in charger_act_helper and k not in wm_act_helper}
    shared_observations = [k for k, v in obs_schema.items()
                           if v.get("shared_in_central_agent", False)]

    # electric vehicles (reference citylearn.py:2095-2098, 2558-2594);
    # batteries resolved after the building loop once time_step_ratio is known
    ev_defs = [(name, ev_schema) for name, ev_schema in
               (schema.get("electric_vehicles_def") or {}).items()
               if ev_schema.get("include", True)]
    ev_name_to_index = {name: i for i, (name, _) in enumerate(ev_defs)}

    cache: Dict[str, Table] = {}
    buildings: List[BuildingSpec] = []
    time_step_ratio = 1.0

    b_index = 0
    for b_name, b_schema in schema["buildings"].items():
        if not b_schema.get("include", True):
            continue
        # default type string feeds the md5 device-seed hash; the reference
        # uses 'citylearn.citylearn.Building' (citylearn.py:2211)
        b_type = b_schema.get("type") or "citylearn.citylearn.Building"
        type_name = b_type.rsplit(".", 1)[-1]
        dynamics = None
        if b_schema.get("dynamics") is not None:
            if type_name not in ("LSTMDynamicsBuilding", "DynamicsBuilding",
                                 "OccupantInteractionBuilding",
                                 "LogisticRegressionOccupantInteractionBuilding"):
                raise NotImplementedError(
                    f"building type {b_type} with dynamics not yet supported")
            dynamics = _load_dynamics(b_schema["dynamics"], root)
        occupant = None
        if b_schema.get("occupant") is not None and type_name == \
                "LogisticRegressionOccupantInteractionBuilding":
            occupant = _load_occupant(b_schema["occupant"], root, sim_start, sim_end)
            hold = (b_schema.get("set_point_hold_time_steps")
                    or (b_schema.get("attributes") or {}).get("set_point_hold_time_steps"))
            if hold is not None:
                occupant.set_point_hold_time_steps = int(hold)
        power_outage_cfg = b_schema.get("power_outage") or {}
        simulate_outage = bool(power_outage_cfg.get("simulate_power_outage", False))
        stochastic_outage = bool(power_outage_cfg.get("stochastic_power_outage", False))

        # --- data -------------------------------------------------------
        noise_std = float(b_schema.get("noise_std") or 0.0)
        edf = _read_csv(cache, root, b_schema["energy_simulation"])
        series = _series_from_energy_csv(edf, noise_std, noise_rng)
        n = len(edf["hour"])
        noise = NoiseUtils.make_noise_fn(noise_std, noise_rng)

        # time_step_ratio derivation (reference data.py:428-455)
        hour = series["hour"]
        minutes = series.get("minutes")
        if minutes is not None and len(minutes) > 1:
            delta = int(hour[1]) * 60 + int(minutes[1]) - (int(hour[0]) * 60 + int(minutes[0]))
        else:
            delta = (int(hour[1]) - int(hour[0])) * 60
        if delta < 0:
            delta += 1440
        base_seconds = max(1, delta * 60)
        time_step_ratio = seconds_per_time_step / base_seconds

        # weather noise is additive, unclipped (data.py:573-595); carbon and
        # pricing clip to [0, 1] post-noise (data.py:624-627,661) and draw
        # noise even when the file is absent (citylearn.py:2194, 2200-2206)
        wdf = _read_csv(cache, root, b_schema["weather"])
        for k in WEATHER_FIELDS:
            series[k] = (wdf[k].astype(np.float32) + noise(n)).astype(np.float32)
        if b_schema.get("carbon_intensity"):
            cdf = _read_csv(cache, root, b_schema["carbon_intensity"])
            carbon_raw = cdf["carbon_intensity"].astype(np.float32)
        else:
            carbon_raw = np.zeros(n, np.float32)
        series["carbon_intensity"] = np.clip(
            carbon_raw + noise(n), 0, 1).astype(np.float32)
        if b_schema.get("pricing"):
            pdf = _read_csv(cache, root, b_schema["pricing"])
            for k in PRICING_FIELDS:
                series[k] = np.clip(pdf[k].astype(np.float32)
                                    + noise(n), 0, 1).astype(np.float32)
        else:
            for k in PRICING_FIELDS:
                series[k] = np.clip(noise(n), 0, 1).astype(np.float32)

        # --- devices ----------------------------------------------------
        def dev_seed(device_name: str, block: Optional[dict]) -> Optional[int]:
            if block is None:
                return None
            explicit = (block.get("attributes") or {}).get("random_seed")
            if explicit is not None:
                return int(explicit)
            return seeding.device_random_seed(
                b_name, b_type, device_name, block["type"], schema_random_seed)

        for key in ("electrical_storage", "pv", "cooling_device", "heating_device",
                    "dhw_device", "cooling_storage", "heating_storage", "dhw_storage"):
            if (b_schema.get(key) or {}).get("autosize"):
                _unsupported(f"{key}.autosize", b_name)

        bat_block = b_schema.get("electrical_storage")
        battery = (_resolve_battery(bat_block, dev_seed("electrical_storage", bat_block),
                                    time_step_ratio)
                   if bat_block is not None else _null_battery())
        solar_generation = overrides.get("solar_generation")
        if isinstance(solar_generation, list):
            solar_generation = solar_generation[b_index]
        pv_block = None if solar_generation is False else b_schema.get("pv")
        pv_nominal = float(((pv_block or {}).get("attributes") or {}).get("nominal_power") or 0.0)

        cool_block = b_schema.get("cooling_device")
        heat_block = b_schema.get("heating_device")
        dhw_block = b_schema.get("dhw_device")
        cooling_device = _resolve_hvac(cool_block, dev_seed("cooling_device", cool_block))
        heating_device = _resolve_hvac(heat_block, dev_seed("heating_device", heat_block))
        if heat_block is None:
            heating_device.is_heat_pump = True   # default HeatPump(0.0), building.py:741-743
        dhw_device = _resolve_hvac(dhw_block, dev_seed("dhw_device", dhw_block))
        if dhw_block is None:
            dhw_device.is_heat_pump = False      # default ElectricHeater(0.0), building.py:733-735
            dhw_device.efficiency = 0.92

        cs_block = b_schema.get("cooling_storage")
        hs_block = b_schema.get("heating_storage")
        ds_block = b_schema.get("dhw_storage")
        cooling_storage = _resolve_storage_tank(cs_block, dev_seed("cooling_storage", cs_block), time_step_ratio)
        heating_storage = _resolve_storage_tank(hs_block, dev_seed("heating_storage", hs_block), time_step_ratio)
        dhw_storage = _resolve_storage_tank(ds_block, dev_seed("dhw_storage", ds_block), time_step_ratio)

        # --- chargers + washing machines --------------------------------
        chargers: List[ChargerSpec] = []
        for charger_name, charger_cfg in (b_schema.get("chargers") or {}).items():
            attrs = charger_cfg.get("attributes") or {}
            ch_eff = float(attrs.get("efficiency") or 1.0)

            def _eff_curve(curve):
                # power-dependent efficiency (charger.py:252-281): schema
                # stores [[power, eff], ...]; constant at `efficiency` when
                # absent so the lookup degenerates to the scalar
                if curve is None:
                    curve = [[0.0, ch_eff], [1.0, ch_eff]]
                return seeding.pad_curve(curve, CURVE_PAD)

            cex, cey = _eff_curve(attrs.get("charge_efficiency_curve"))
            dex, dey = _eff_curve(attrs.get("discharge_efficiency_curve"))
            sim = _load_charger_sim(
                os.path.join(root, charger_cfg["charger_simulation"]),
                sim_start, sim_end, ev_name_to_index,
                float(charger_cfg.get("noise_std", 0.0)), noise_rng)
            power = lambda key, default: float(attrs[key] if attrs.get(key) is not None
                                               else default)
            chargers.append(ChargerSpec(
                charger_id=charger_name,
                building_index=b_index,
                efficiency=ch_eff,
                charge_eff_x=cex, charge_eff_y=cey,
                discharge_eff_x=dex, discharge_eff_y=dey,
                max_charging_power=power("max_charging_power", 50.0),
                min_charging_power=float(attrs.get("min_charging_power") or 0.0),
                max_discharging_power=power("max_discharging_power", 50.0),
                min_discharging_power=float(attrs.get("min_discharging_power") or 0.0),
                **sim))

        washing_machines: List[WashingMachineSpec] = []
        for wm_name, wm_cfg in (b_schema.get("washing_machines") or {}).items():
            wm_path = os.path.join(root, wm_cfg["washing_machine_energy_simulation"])
            wdf = read_csv_columns(wm_path)
            start_arr = wdf["wm_start_time_step"].astype(float)
            end_arr = wdf["wm_end_time_step"].astype(float)
            profiles = [_load_profile(lp) for lp in _read_csv_raw(wm_path)["load_profile"]]
            washing_machines.append(WashingMachineSpec(
                name=wm_name, building_index=b_index,
                wm_start=np.where(np.isnan(start_arr), -1, start_arr).astype(int)[sim_start:sim_end + 1],
                wm_end=np.where(np.isnan(end_arr), -1, end_arr).astype(int)[sim_start:sim_end + 1],
                load_profiles=profiles[sim_start:sim_end + 1]))

        # --- observation/action surface --------------------------------
        # constructor overrides flip the schema's active flags in schema-key
        # order (reference process_metadata, citylearn.py:2411-2500); flat
        # lists apply to every building, list-of-lists per building
        def per_building(name, fallback):
            v = overrides.get(name)
            if v is None:
                return fallback
            return v[b_index] if v and isinstance(v[0], list) else v

        inactive_obs = per_building(
            "inactive_observations", b_schema.get("inactive_observations") or [])
        inactive_act = per_building(
            "inactive_actions", b_schema.get("inactive_actions") or [])
        override_obs = per_building("active_observations", None)
        override_act = per_building("active_actions", None)
        active_observations = [
            k for k, v in obs_schema.items()
            if (v.get("active", False) if override_obs is None
                else k in override_obs) and k not in inactive_obs]
        active_actions = [
            k for k, v in act_schema.items()
            if (v.get("active", False) if override_act is None
                else k in override_act) and k not in inactive_act]
        # per-charger / per-WM / charging-constraint expansion. The
        # reference surfaces constraint observations *before* the charger
        # observations, in the order: phase one-hots, building headroom,
        # phase headrooms, violation.
        cc = b_schema.get("charging_constraints")
        if cc:
            obs_cfg = cc.get("observations") or {}
            if bool(obs_cfg.get("phase_encoding", False)) and (cc.get("phases") or []):
                phase_map = {cid: (p.get("name") or "")
                             for p in (cc.get("phases") or [])
                             for cid in (p.get("chargers") or [])}
                phase_names = sorted({p.get("name") for p in cc.get("phases")
                                      if p.get("name")})
                if any(ch.charger_id not in phase_map for ch in chargers):
                    phase_names = phase_names + ["unassigned"]
                for ch in chargers:
                    for pn in phase_names:
                        active_observations.append(
                            f"charging_phase_one_hot_{ch.charger_id}_{pn}")
            expose_headroom = bool(obs_cfg.get(
                "headroom", cc.get("expose_observations", True)))
            if expose_headroom:
                if cc.get("building_limit_kw") is not None:
                    active_observations.append("charging_building_headroom_kw")
                for phase in (cc.get("phases") or []):
                    if phase.get("limit_kw") is not None:
                        name_p = phase.get("name") or "phase"
                        active_observations.append(
                            f"charging_phase_{name_p}_headroom_kw")
            if bool(obs_cfg.get("violation", True)):
                active_observations.append("charging_constraint_violation_kwh")

        def helper_on(helper_map, key, override):
            # overrides flip helper metadata too (citylearn.py:2432-2441)
            if override is not None:
                return key in override
            v = helper_map.get(key)
            return bool(v and v.get("active", False))

        for ch in chargers:
            for helper_key, template in CHARGER_OBS_EXPANSION:
                if helper_on(charger_obs_helper, helper_key, override_obs) \
                        and helper_key not in inactive_obs:
                    active_observations.append(template.format(id=ch.charger_id))
            if helper_on(charger_act_helper, "electric_vehicle_storage", override_act) \
                    and "electric_vehicle_storage" not in inactive_act:
                active_actions.append(f"electric_vehicle_storage_{ch.charger_id}")
        for wm in washing_machines:
            if helper_on(wm_obs_helper, "washing_machine_start_time_step", override_obs):
                active_observations.append(f"{wm.name}_start_time_step")
            if helper_on(wm_obs_helper, "washing_machine_end_time_step", override_obs):
                active_observations.append(f"{wm.name}_end_time_step")
            if helper_on(wm_act_helper, "washing_machine", override_act):
                active_actions.append(wm.name)

        spec = BuildingSpec(
            name=b_name,
            index=b_index,
            active_observations=active_observations,
            active_actions=active_actions,
            observation_low={}, observation_high={},
            action_low=[], action_high=[],
            battery=battery,
            pv_nominal_power=pv_nominal,
            cooling_device=cooling_device,
            heating_device=heating_device,
            dhw_device=dhw_device,
            cooling_storage=cooling_storage,
            heating_storage=heating_storage,
            dhw_storage=dhw_storage,
            series=series,
            simulate_power_outage=simulate_outage,
            stochastic_power_outage=stochastic_outage,
            stochastic_power_outage_model=power_outage_cfg.get("stochastic_power_outage_model"),
            dynamics=dynamics,
            occupant=occupant,
            chargers=chargers,
            washing_machines=washing_machines,
            charging_constraints=b_schema.get("charging_constraints"),
        )

        lo, hi = estimate_observation_space_limits(spec, sim_start, sim_end)
        if "charging_constraint_violation_kwh" in hi:
            hi["charging_constraint_violation_kwh"] *= seconds_per_time_step / 3600.0
        spec.observation_low, spec.observation_high = lo, hi
        spec.action_low, spec.action_high = estimate_action_space(spec, sim_start, sim_end)
        buildings.append(spec)
        b_index += 1

    electric_vehicles: List[ElectricVehicleSpec] = []
    for i, (ev_name, ev_schema) in enumerate(ev_defs):
        attrs = dict(ev_schema["battery"]["attributes"])
        # reference defaults: initial_soc random.uniform(0,1) (global RNG,
        # non-reproducible — 0.5 here) and depth_of_discharge 0.10
        # (citylearn.py:2562-2575); battery seeded with the schema's seed.
        if attrs.get("initial_soc") is None:
            attrs["initial_soc"] = 0.5
        attrs.setdefault("depth_of_discharge", 0.10)
        bat = _resolve_battery({"attributes": attrs}, schema_random_seed, time_step_ratio)
        electric_vehicles.append(ElectricVehicleSpec(name=ev_name, index=i, battery=bat))

    return DistrictSpec(
        schema=schema,
        dataset_dir=root,
        buildings=buildings,
        electric_vehicles=electric_vehicles,
        central_agent=central_agent,
        random_seed=random_seed,
        seconds_per_time_step=seconds_per_time_step,
        time_step_ratio=time_step_ratio,
        simulation_start_time_step=sim_start,
        simulation_end_time_step=sim_end,
        episode_time_steps=episode_time_steps,
        rolling_episode_split=rolling,
        random_episode_split=random_split,
        shared_observations=shared_observations,
    )
