"""Schema compiler: ``schema.json`` + CSVs -> :class:`DistrictSpec`.

The counterpart of ``citylearn_tpu.compiler.schema`` for the districts
the port carries (battery+PV and thermal storage): the same device
resolution, series defaults, noise stream and observation/action
surface, with CSVs read by the standard ``csv`` module instead of
pandas. Schema blocks outside those districts raise
``NotImplementedError`` naming the block: LSTM dynamics, electric
vehicles and chargers, charging constraints, washing machines,
occupants, autosizing and stochastic power outages. Missing HVAC devices
and tanks resolve to the same inert defaults as in the JAX package.
"""

from __future__ import annotations

import csv
import json
import os
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
    DistrictSpec,
    HVACDeviceSpec,
    StorageTankSpec,
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

    if any(ev.get("include", True)
           for ev in (schema.get("electric_vehicles_def") or {}).values()):
        _unsupported("electric_vehicles_def")

    # charger/washing-machine helper entries are not building observations
    # or actions (reference citylearn.py:2010-2030); with no chargers or
    # machines they expand to nothing
    obs_schema = {k: v for k, v in schema["observations"].items()
                  if "electric_vehicle_" not in k and "washing_machine_" not in k}
    act_schema = {k: v for k, v in schema["actions"].items()
                  if "electric_vehicle_" not in k and "washing_machine" not in k}
    shared_observations = [k for k, v in obs_schema.items()
                           if v.get("shared_in_central_agent", False)]

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
        for block in ("chargers", "washing_machines", "charging_constraints"):
            if b_schema.get(block):
                _unsupported(block, b_name)
        if b_schema.get("dynamics") is not None:
            _unsupported("dynamics", b_name)
        if b_schema.get("occupant") is not None and type_name == \
                "LogisticRegressionOccupantInteractionBuilding":
            _unsupported("occupant", b_name)
        power_outage_cfg = b_schema.get("power_outage") or {}
        simulate_outage = bool(power_outage_cfg.get("simulate_power_outage", False))
        stochastic_outage = bool(power_outage_cfg.get("stochastic_power_outage", False))
        if simulate_outage and stochastic_outage:
            _unsupported("power_outage.stochastic_power_outage", b_name)

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
            charging_constraints=b_schema.get("charging_constraints"),
        )

        lo, hi = estimate_observation_space_limits(spec, sim_start, sim_end)
        spec.observation_low, spec.observation_high = lo, hi
        spec.action_low, spec.action_high = estimate_action_space(spec, sim_start, sim_end)
        buildings.append(spec)
        b_index += 1

    return DistrictSpec(
        schema=schema,
        dataset_dir=root,
        buildings=buildings,
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
