"""EnergyPlus backend for the dataset-generation pipeline.

Implements the :class:`~citylearn_tpu_torch.end_use_load_profiles.build.BuildingSimulator`
protocol against a real EnergyPlus toolchain — the reference's doe_xstock
flow (``citylearn/end_use_load_profiles/simulate.py:9-166``) without the
eppy/doe_xstock dependencies:

- **ideal run**: the building's IDF is simulated with its
  ``ZoneHVAC:IdealLoadsAirSystem``; loads and zone conditions are
  extracted from the EnergyPlus SQLite output with ``sqlite3`` and numpy
  equivalents of the reference's SQL (``misc/queries/select_ideal_loads.sql``,
  ``select_citylearn_energy_simulation.sql``).
- **partial run**: ideal-loads objects are stripped and per-zone
  ``Schedule:File`` + ``OtherEquipment`` objects are appended as IDF text
  (the reference's ``add_other_equipment``, ``simulate.py:106-166``),
  driving the zones with the prescribed (multiplier-perturbed) thermal
  loads; the free-response temperature is extracted back.

Every external seam is injectable so the full code path runs under test
without an EnergyPlus binary:

- ``model_provider(bldg_id) -> {"idf": str, "epw": str}`` supplies the
  building model (the reference gets these from doe_xstock's EULP cache);
- ``run_energyplus(idf_path, epw_path, output_directory) -> sqlite_path``
  executes the simulation (default: the ``energyplus`` CLI).

Frames are dicts of numpy columns. Per-time-step sums and means are
compensated (Kahan) sums in row order, as pandas' ``groupby`` takes them.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sqlite3
import subprocess
import tempfile
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from citylearn_tpu_torch.end_use_load_profiles.build import (  # noqa: F401
    Table,
    get_multipliers,
    write_table,
)

J_TO_KWH = 1.0 / 3.6e6

#: variables the reference's queries consume (select_citylearn_energy_simulation.sql)
WEIGHTED_VARIABLES = ("Zone Air Temperature", "Zone Air Relative Humidity")
SETPOINT_VARIABLES = ("Zone Thermostat Cooling Setpoint Temperature",
                      "Zone Thermostat Heating Setpoint Temperature")
OTHER_VARIABLES = ("Water Use Equipment Heating Rate",
                   "Zone Lights Electricity Rate",
                   "Zone Electric Equipment Electricity Rate",
                   "Zone People Occupant Count")
IDEAL_COOLING = "Zone Ideal Loads Zone Sensible Cooling Rate"
IDEAL_HEATING = "Zone Ideal Loads Zone Sensible Heating Rate"


def default_run_energyplus(idf_path: str, epw_path: str,
                           output_directory: str) -> str:
    """Run the ``energyplus`` CLI with SQLite output and return the path
    to ``eplusout.sql``."""
    subprocess.run(["energyplus", "-w", epw_path, "-d", output_directory,
                    "-r", idf_path], check=True, capture_output=True)
    return os.path.join(output_directory, "eplusout.sql")


# ----------------------------------------------------------------------
# SQLite extraction (numpy equivalents of misc/queries/*.sql)
# ----------------------------------------------------------------------

def group_sum(keys: np.ndarray, values: np.ndarray, mean: bool = False
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``(sorted unique keys, per-key sum or mean of values)``: pandas'
    ``groupby(keys).sum()``/``.mean()`` — each group's non-NaN values
    summed in row order with Kahan compensation."""
    keys = np.asarray(keys)
    values = np.asarray(values, np.float64)
    uniq, inv = np.unique(keys, return_inverse=True)
    total = np.zeros(len(uniq))
    comp = np.zeros(len(uniq))
    count = np.zeros(len(uniq))
    if len(keys):
        valid = ~np.isnan(values)
        inv_v, val_v = inv[valid], values[valid]
        # each row's position within its group, in row order
        order = np.argsort(inv_v, kind="stable")
        sizes = np.bincount(inv_v, minlength=len(uniq))
        pos = np.empty(len(inv_v), np.int64)
        pos[order] = np.arange(len(inv_v)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
        for p in range(int(sizes.max(initial=0))):
            at = pos == p
            g, v = inv_v[at], val_v[at]
            y = v - comp[g]
            t = total[g] + y
            comp[g] = (t - total[g]) - y
            total[g] = t
        count = sizes.astype(np.float64)
    if mean:
        with np.errstate(invalid="ignore", divide="ignore"):
            return uniq, np.where(count > 0, total / count, np.nan)
    return uniq, total


def _report_data(sqlite_path: str) -> Table:
    """ReportData joined to its dictionary, in ReportData's row order:
    columns TimeIndex, Name, KeyValue (``""`` where NULL), Value."""
    with sqlite3.connect(sqlite_path) as con:
        rows = con.execute(
            "SELECT d.TimeIndex, dd.Name, dd.KeyValue, d.Value FROM ReportData d "
            "LEFT JOIN ReportDataDictionary dd "
            "ON d.ReportDataDictionaryIndex = dd.ReportDataDictionaryIndex "
            "ORDER BY d.rowid").fetchall()
    return {
        "TimeIndex": np.array([r[0] for r in rows], np.int64),
        "Name": np.array([r[1] or "" for r in rows], dtype=object),
        "KeyValue": np.array([r[2] or "" for r in rows], dtype=object),
        "Value": np.array([np.nan if r[3] is None else r[3] for r in rows], np.float64),
    }


def _zone_weights(sqlite_path: str) -> Dict[str, float]:
    """Conditioned-zone volume weights by zone name (the reference's
    ``create_zone_metadata.sql`` weighting: zone volume x multiplier over
    the conditioned total)."""
    with sqlite3.connect(sqlite_path) as con:
        zones = con.execute("SELECT ZoneName, Volume, Multiplier FROM Zones").fetchall()
    weight = np.array([v * m for _, v, m in zones], np.float64)
    weight = weight / weight.sum()
    return {z[0]: float(w) for z, w in zip(zones, weight)}


def extract_ideal_loads(sqlite_path: str) -> Table:
    """Per-zone ideal sensible loads (``select_ideal_loads.sql``):
    timestep, zone_name, cooling_load / heating_load in [W], sorted by
    zone then timestep, a load absent for a (timestep, zone) as 0."""
    df = _report_data(sqlite_path)
    loads: Dict[tuple, Dict[str, float]] = {}
    for name, col in ((IDEAL_COOLING, "cooling_load"), (IDEAL_HEATING, "heating_load")):
        m = df["Name"] == name
        for t, key, v in zip(df["TimeIndex"][m], df["KeyValue"][m], df["Value"][m]):
            zone = key.replace(" IDEAL LOADS AIR SYSTEM", "")
            loads.setdefault((zone, int(t)), {})[col] = v
    keys = sorted(loads)
    get = lambda col: np.array([loads[k].get(col, 0.0) for k in keys], np.float64)
    fill = lambda a: np.where(np.isnan(a), 0.0, a)
    return {"timestep": np.array([k[1] for k in keys], np.int64),
            "zone_name": np.array([k[0] for k in keys], dtype=object),
            "cooling_load": fill(get("cooling_load")),
            "heating_load": fill(get("heating_load"))}


def extract_energy_simulation(sqlite_path: str) -> Table:
    """CityLearn energy-simulation frame
    (``select_citylearn_energy_simulation.sql`` semantics): volume-weighted
    zone conditions, setpoints, Other-Equipment thermal loads split by
    sign, DHW/lights/equipment/occupancy sums; loads in kWh. Rows are the
    sorted time indices of any variable; a variable absent at one is 0."""
    df = _report_data(sqlite_path)
    weights = {k.upper(): v for k, v in _zone_weights(sqlite_path).items()}
    upper = np.array([k.upper() for k in df["KeyValue"]], dtype=object)
    frames = {}

    def by_time(mask, values=None, mean=False):
        values = df["Value"][mask] if values is None else values
        return group_sum(df["TimeIndex"][mask], values, mean)

    for name, col in (("Zone Air Temperature", "indoor_dry_bulb_temperature"),
                      ("Zone Air Relative Humidity", "indoor_relative_humidity")):
        m = df["Name"] == name
        w = np.array([weights.get(k, 0.0) for k in upper[m]], np.float64)
        frames[col] = by_time(m, df["Value"][m] * w)
    for name, col in zip(SETPOINT_VARIABLES,
                         ("indoor_dry_bulb_temperature_cooling_set_point",
                          "indoor_dry_bulb_temperature_heating_set_point")):
        frames[col] = by_time(df["Name"] == name, mean=True)

    # Other Equipment thermal loads: positive = heating, negative = cooling
    oe = ((df["Name"] == "Other Equipment Convective Heating Rate")
          & np.array(["LOAD" in k for k in upper], bool))
    t_heat, heat = by_time(oe & (df["Value"] > 0))
    t_cool, cool = by_time(oe & (df["Value"] <= 0))
    frames["heating_demand"] = (t_heat, heat * J_TO_KWH * 3600.0 / 1000.0)
    frames["cooling_demand"] = (t_cool, np.abs(cool) * J_TO_KWH * 3600.0 / 1000.0)

    t, v = by_time(df["Name"] == "Water Use Equipment Heating Rate")
    frames["dhw_demand"] = (t, v / 1000.0)
    t, v = by_time(np.isin(df["Name"], ("Zone Lights Electricity Rate",
                                        "Zone Electric Equipment Electricity Rate")))
    frames["non_shiftable_load"] = (t, v / 1000.0)
    frames["occupant_count"] = by_time(df["Name"] == "Zone People Occupant Count")

    index = np.unique(np.concatenate([t for t, _ in frames.values()]))
    n = len(index)
    steps = np.arange(n)
    out: Table = {
        "month": np.minimum(steps // 24 // 30 + 1, 12).astype(np.int32),
        "hour": (steps % 24 + 1).astype(np.int32),
        "day_type": ((steps // 24) % 7 + 1).astype(np.int32),
    }
    for col, (t, v) in frames.items():
        full = np.zeros(n)
        full[np.searchsorted(index, t)] = v
        out[col] = np.where(np.isnan(full), 0.0, full)
    return out


# ----------------------------------------------------------------------
# IDF text editing (the reference uses eppy; plain-text emission keeps the
# object payloads identical without the dependency)
# ----------------------------------------------------------------------

def remove_ideal_loads_air_system(idf_text: str) -> str:
    """Strip ``ZoneHVAC:IdealLoadsAirSystem`` objects (reference
    ``simulate.py:104``: the partial run replaces HVAC with prescribed
    OtherEquipment loads)."""
    pattern = re.compile(
        r"ZoneHVAC:IdealLoadsAirSystem\s*,[^;]*;", re.IGNORECASE | re.DOTALL)
    return pattern.sub("", idf_text)


def add_other_equipment(idf_text: str, zone_names: Sequence[str],
                        loads_filepath: str, n_time_steps: int,
                        minutes_per_item: int = 60) -> str:
    """Append the partial-load injection objects (reference
    ``simulate.py:110-166``): one ``Schedule:File`` + ``OtherEquipment``
    per (zone, load) with the reference's exact column/row-skip layout —
    column j+1 of the stacked per-zone loads CSV, skipping
    ``1 + i * n_time_steps`` rows for zone i."""
    blocks = ["""
ScheduleTypeLimits,
    other equipment hvac power,       !- Name
    ,                                 !- Lower Limit Value
    ,                                 !- Upper Limit Value
    Continuous,                       !- Numeric Type
    Dimensionless;                    !- Unit Type
"""]
    loads = ["cooling_load", "heating_load"]
    for i, zone_name in enumerate(zone_names):
        for j, load in enumerate(loads):
            name = f"{zone_name} partial {load}"
            blocks.append(f"""
Schedule:File,
    {name},                           !- Name
    other equipment hvac power,       !- Schedule Type Limits Name
    {loads_filepath},                 !- File Name
    {j + 1},                          !- Column Number
    {1 + i * n_time_steps},           !- Rows to Skip at Top
    8760,                             !- Number of Hours of Data
    Comma,                            !- Column Separator
    No,                               !- Interpolate to Timestep
    {minutes_per_item};               !- Minutes per Item
""")
            blocks.append(f"""
OtherEquipment,
    {name},                           !- Name
    None,                             !- Fuel Type
    {zone_name},                      !- Zone or ZoneList Name
    {name},                           !- Schedule Name
    EquipmentLevel,                   !- Design Level Calculation Method
    1.0,                              !- Design Level {{W}}
    ,                                 !- Power per Zone Floor Area
    ,                                 !- Power per Person
    0.0,                              !- Fraction Latent
    0.0,                              !- Fraction Radiant
    0.0,                              !- Fraction Lost
    ,                                 !- Carbon Dioxide Generation Rate
    partial {load};                   !- End-Use Subcategory
""")
    return idf_text + "".join(blocks)


def write_partial_loads_csv(path: str, cooling_w: np.ndarray,
                            heating_w: np.ndarray,
                            zone_weights: Mapping[str, float]) -> Sequence[str]:
    """Distribute the building-level prescribed loads across zones by the
    conditioned-volume weights (zone name -> weight) and write the stacked
    per-zone CSV the Schedule:File objects read (reference
    ``simulate.py:119-129``: cooling written negative)."""
    names = list(zone_weights)
    cooling, heating = [], []
    for z in names:
        w = float(zone_weights[z])
        cooling.append(-np.asarray(cooling_w, np.float64) * w)
        heating.append(np.asarray(heating_w, np.float64) * w)
    write_table(path, {"cooling_load": np.concatenate(cooling),
                       "heating_load": np.concatenate(heating)})
    return names


@dataclasses.dataclass
class EnergyPlusSimulator:
    """:class:`BuildingSimulator` over EnergyPlus (injectable seams for
    binary-free testing; see module docstring)."""

    model_provider: Callable[[int], Dict[str, str]]
    run_energyplus: Callable[[str, str, str], str] = None
    output_directory: Optional[str] = None
    number_of_time_steps_per_hour: int = 1

    def __post_init__(self):
        if self.run_energyplus is None:
            self.run_energyplus = default_run_energyplus
        if self.output_directory is None:
            self.output_directory = tempfile.mkdtemp(prefix="citylearn_eplus_")

    # -- protocol -------------------------------------------------------
    def weather(self, n_time_steps: int) -> Table:
        from citylearn_tpu_torch.compiler.pv_autosize import read_epw
        epw = read_epw(self.model_provider(0)["epw"])
        n = min(n_time_steps, len(epw["temp_air"]))
        return {
            "outdoor_dry_bulb_temperature": epw["temp_air"][:n].astype(np.float32),
            "outdoor_relative_humidity": np.full(n, 50.0, np.float32),
            "diffuse_solar_irradiance": epw["dhi"][:n].astype(np.float32),
            "direct_solar_irradiance": epw["dni"][:n].astype(np.float32),
        }

    def _run(self, bldg_id: int, idf_text: str, tag: str) -> str:
        model = self.model_provider(bldg_id)
        out_dir = os.path.join(self.output_directory, f"{bldg_id}_{tag}")
        os.makedirs(out_dir, exist_ok=True)
        idf_path = os.path.join(out_dir, "model.idf")
        with open(idf_path, "w") as f:
            f.write(idf_text)
        return self.run_energyplus(idf_path, model["epw"], out_dir)

    def simulate_ideal(self, bldg_id: int, n_time_steps: int) -> Table:
        model = self.model_provider(bldg_id)
        sql = self._run(bldg_id, model["idf"], "ideal")
        ideal = extract_ideal_loads(sql)
        sim = extract_energy_simulation(sql)
        # ideal runs report loads through the IdealLoads system, not
        # OtherEquipment — overwrite the demand columns from the loads table
        _, cooling = group_sum(ideal["timestep"], ideal["cooling_load"])
        _, heating = group_sum(ideal["timestep"], ideal["heating_load"])
        n = min(n_time_steps, len(sim["hour"]))
        sim = {k: v[:n].copy() for k, v in sim.items()}
        sim["cooling_demand"] = cooling[:n] / 1000.0
        sim["heating_demand"] = heating[:n] / 1000.0
        if "solar_generation" not in sim:
            sim["solar_generation"] = np.zeros(n)
        return sim

    def simulate_partial(self, bldg_id: int, cooling_kwh: np.ndarray,
                         heating_kwh: np.ndarray) -> Table:
        model = self.model_provider(bldg_id)
        out_dir = os.path.join(self.output_directory, f"{bldg_id}_partial")
        os.makedirs(out_dir, exist_ok=True)
        # zone weights come from the ideal run's sqlite when available,
        # else a single-zone assumption
        ideal_sql = os.path.join(self.output_directory, f"{bldg_id}_ideal",
                                 "eplusout.sql")
        weights = (_zone_weights(ideal_sql) if os.path.exists(ideal_sql)
                   else {"ZONE 1": 1.0})
        loads_path = os.path.join(out_dir, "partial_load.csv")
        n = len(cooling_kwh)
        zone_names = write_partial_loads_csv(
            loads_path, np.asarray(cooling_kwh) * 1000.0,
            np.asarray(heating_kwh) * 1000.0, weights)
        idf = remove_ideal_loads_air_system(model["idf"])
        idf = add_other_equipment(
            idf, zone_names, loads_path, n,
            minutes_per_item=60 // self.number_of_time_steps_per_hour)
        sql = self._run(bldg_id, idf, "partial")
        sim = extract_energy_simulation(sql)
        return {k: v[:n] for k, v in sim.items()}
