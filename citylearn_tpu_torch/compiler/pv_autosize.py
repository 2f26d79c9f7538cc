"""PV autosizing: EPW-driven PVWatts-equivalent solar model + sizing math.

The reference autosizes rooftop PV by sampling a system design from LBNL's
Tracking-the-Sun dataset and simulating it with NREL PySAM's ``PVWattsNone``
model over the dataset's EPW weather file
(reference ``energy_model.py:490-602``, ``building.py:2426-2441``).
This module has, in numpy:

1. an **EPW reader**,
2. a **PVWatts-equivalent irradiance-to-AC chain** — NOAA solar position,
   HDKR transposition to plane-of-array, Sandia open-rack cell
   temperature, the PVWatts DC temperature-derate and part-load inverter
   model — a documented approximation of PySAM's ``Pvwattsv8``
   (divergence: HDKR sky-diffuse instead of Perez, simplified bifacial
   rear-side gain), taken by the sizing when PySAM does not import,
3. the reference's **exact sizing math** (zero-net-energy proportion,
   roof-area limit, module-step floor; ``energy_model.py:532-601``) on top
   of a sampled system design. The Tracking-the-Sun CSV is read with
   ``csv`` when found (:func:`citylearn_tpu_torch.data.misc_file`);
   otherwise a deterministic synthetic residential-PV design table with
   the same columns stands in.

Tables are dicts of numpy columns; pandas' ``sample(1, random_state=s)``
is the same draw from ``np.random.RandomState(s)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from citylearn_tpu_torch.compiler import seeding

Table = Dict[str, np.ndarray]

LBL_PV_FILENAME = "lbl-tracking_the_sun-res-pv.csv"  # data.py:43

# PVWatts defaults (Pvwattsv8 'PVWattsNone' standard-module configuration)
GAMMA_PDC = -0.0037          # module max-power temperature coefficient [1/degC]
SYSTEM_LOSSES = 0.14         # PVWatts default total DC losses
INVERTER_NOM_EFF = 0.96      # nominal inverter efficiency
INVERTER_REF_EFF = 0.9637    # PVWatts reference inverter efficiency
ALBEDO = 0.2
# Sandia open-rack glass/polymer cell-temperature model coefficients
SANDIA_A, SANDIA_B, SANDIA_DT = -3.56, -0.075, 3.0


def read_epw(filepath: str) -> dict:
    """Parse an EnergyPlus EPW file into hourly numpy arrays.

    Returns latitude/longitude/timezone plus ``ghi``, ``dni``, ``dhi``
    [W/m^2], ``temp_air`` [degC], ``wind_speed`` [m/s] and fractional
    mid-hour local standard time (EPW hours are hour-ending 1..24).
    """
    with open(filepath) as f:
        header = f.readline().strip().split(",")
        lat, lon, tz = float(header[6]), float(header[7]), float(header[8])
        rows = []
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 22 or not parts[0].isdigit():
                continue
            rows.append((int(parts[1]), int(parts[2]), int(parts[3]),
                         float(parts[6]), float(parts[13]), float(parts[14]),
                         float(parts[15]), float(parts[21])))
    arr = np.asarray(rows, dtype=np.float64)
    month, day, hour = arr[:, 0], arr[:, 1], arr[:, 2]
    cum_days = np.concatenate(([0], np.cumsum([31, 28, 31, 30, 31, 30,
                                               31, 31, 30, 31, 30, 31])))
    doy = cum_days[(month - 1).astype(int)] + day
    return {
        "latitude": lat, "longitude": lon, "timezone": tz,
        "day_of_year": doy,
        "local_hour": hour - 0.5,      # mid-hour convention (PVWatts)
        "temp_air": arr[:, 3], "ghi": arr[:, 4],
        "dni": arr[:, 5], "dhi": arr[:, 6], "wind_speed": arr[:, 7],
    }


def solar_position(lat_deg: float, lon_deg: float, tz_hours: float,
                   day_of_year: np.ndarray, local_hour: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """NOAA-style solar zenith and azimuth [rad] (azimuth clockwise from N)."""
    b = 2.0 * np.pi * (day_of_year - 1 + (local_hour - 12) / 24.0) / 365.0
    # Spencer (1971) declination and equation of time
    decl = (0.006918 - 0.399912 * np.cos(b) + 0.070257 * np.sin(b)
            - 0.006758 * np.cos(2 * b) + 0.000907 * np.sin(2 * b)
            - 0.002697 * np.cos(3 * b) + 0.00148 * np.sin(3 * b))
    eot = 229.18 * (0.000075 + 0.001868 * np.cos(b) - 0.032077 * np.sin(b)
                    - 0.014615 * np.cos(2 * b) - 0.04089 * np.sin(2 * b))
    solar_time = local_hour + (4.0 * (lon_deg - 15.0 * tz_hours) + eot) / 60.0
    hour_angle = np.radians(15.0 * (solar_time - 12.0))
    lat = math.radians(lat_deg)
    cos_zen = (math.sin(lat) * np.sin(decl)
               + math.cos(lat) * np.cos(decl) * np.cos(hour_angle))
    zenith = np.arccos(np.clip(cos_zen, -1.0, 1.0))
    sin_zen = np.sin(zenith)
    # azimuth from north, clockwise
    cos_az = (np.sin(decl) - cos_zen * math.sin(lat)) / np.where(
        sin_zen * math.cos(lat) < 1e-9, 1e-9, sin_zen * math.cos(lat))
    az = np.arccos(np.clip(cos_az, -1.0, 1.0))
    azimuth = np.where(hour_angle > 0, 2 * np.pi - az, az)
    return zenith, azimuth


def poa_irradiance(epw: dict, tilt_deg: float, azimuth_deg: float,
                   bifaciality: float = 0.0) -> np.ndarray:
    """Plane-of-array irradiance [W/m^2] via the HDKR transposition model
    (Hay-Davies circumsolar + Klucher-Reindl horizon brightening), plus
    isotropic ground reflection and a rear-side bifacial gain
    approximated as ``bifaciality * albedo * GHI``."""
    zen, sun_az = solar_position(epw["latitude"], epw["longitude"],
                                 epw["timezone"], epw["day_of_year"],
                                 epw["local_hour"])
    ghi, dni, dhi = epw["ghi"], epw["dni"], epw["dhi"]
    tilt = math.radians(tilt_deg)
    surf_az = math.radians(azimuth_deg)
    cos_zen = np.cos(zen)
    cos_aoi = (cos_zen * math.cos(tilt)
               + np.sin(zen) * math.sin(tilt) * np.cos(sun_az - surf_az))
    cos_aoi = np.maximum(cos_aoi, 0.0)
    up = cos_zen > 0.05234  # sun above 87 deg zenith

    # extraterrestrial normal irradiance for anisotropy index
    b = 2.0 * np.pi * (epw["day_of_year"] - 1) / 365.0
    e0 = 1367.0 * (1.00011 + 0.034221 * np.cos(b) + 0.00128 * np.sin(b)
                   + 0.000719 * np.cos(2 * b) + 0.000077 * np.sin(2 * b))
    ai = np.where(up, dni / np.maximum(e0, 1.0), 0.0)          # anisotropy
    # circumsolar projection ratio, capped to tame horizon-hour EPW
    # averaging spikes (hourly DNI recorded while the mid-hour sun sits
    # near the horizon)
    rb = np.where(up, np.clip(cos_aoi / np.maximum(cos_zen, 0.05234),
                              0.0, 5.0), 0.0)

    beam = np.where(up, dni * cos_aoi, 0.0)
    f = np.sqrt(np.where(ghi > 0, np.clip(dni * cos_zen / np.maximum(ghi, 1e-6),
                                          0.0, 1.0), 0.0))
    sky = dhi * (ai * rb + (1 - ai) * 0.5 * (1 + math.cos(tilt))
                 * (1 + f * math.sin(tilt / 2.0) ** 3))
    ground = ghi * ALBEDO * 0.5 * (1 - math.cos(tilt))
    rear = bifaciality * ALBEDO * ghi
    return np.maximum(beam + sky + ground + rear, 0.0)


def pvwatts_ac(epw: dict, system_capacity_kw: float, dc_ac_ratio: float,
               tilt_deg: float, azimuth_deg: float,
               bifaciality: float = 0.0) -> np.ndarray:
    """Hourly AC output [W] of a ``system_capacity_kw`` system — the
    PVWatts chain: POA -> Sandia cell temperature -> temperature-derated
    DC -> part-load inverter with clipping at ``Pdc0 / dc_ac_ratio``."""
    poa = poa_irradiance(epw, tilt_deg, azimuth_deg, bifaciality)
    t_mod = poa * np.exp(SANDIA_A + SANDIA_B * epw["wind_speed"]) + epw["temp_air"]
    t_cell = t_mod + (poa / 1000.0) * SANDIA_DT
    pdc0 = system_capacity_kw * 1000.0                     # W
    pdc = (poa / 1000.0) * pdc0 * (1.0 + GAMMA_PDC * (t_cell - 25.0))
    pdc = np.maximum(pdc, 0.0) * (1.0 - SYSTEM_LOSSES)
    pac0 = pdc0 / dc_ac_ratio
    zeta = np.clip(pdc / max(pac0, 1e-9), 1e-4, None)
    eta = (INVERTER_NOM_EFF / INVERTER_REF_EFF
           * (-0.0162 * zeta - 0.0059 / zeta + 0.9858))
    pac = np.where(pdc > 0, np.clip(eta, 0.0, None) * pdc, 0.0)
    return np.minimum(pac, pac0)


def _synthetic_sizing_table(n: int = 500, seed: int = 0) -> Table:
    """Deterministic stand-in for the LBNL Tracking-the-Sun residential-PV
    sample (same columns the reference consumes) when the CSV is absent."""
    rs = np.random.RandomState(seed)
    nameplate = rs.choice([250, 270, 280, 300, 310, 320, 327, 335, 340,
                           350, 360, 365, 370, 380, 390, 400], size=n)
    return {
        "nameplate_capacity_module_1": nameplate.astype(float),
        "inverter_loading_ratio": rs.uniform(1.05, 1.35, n),
        "tilt_1": rs.uniform(10.0, 35.0, n),
        "azimuth_1": np.clip(rs.normal(180.0, 35.0, n), 90.0, 270.0),
        "bifacial_module_1": (rs.uniform(size=n) < 0.05).astype(float),
        "module_area": np.round(nameplate / 1000.0 * rs.uniform(5.0, 5.6, n), 3),
        "PV_system_size_DC": np.round(
            np.clip(rs.lognormal(math.log(6.0), 0.4, n), 2.0, 16.0), 2),
    }


def get_pv_sizing_data() -> Table:
    """The LBNL Tracking-the-Sun table when a local copy is found (numeric
    columns float64, empty cells NaN), else the synthetic stand-in
    (reference ``data.py:191-226`` downloads it from GitHub)."""
    from citylearn_tpu_torch.compiler.schema import read_csv_columns
    from citylearn_tpu_torch.data import misc_file

    path = misc_file(LBL_PV_FILENAME)
    return _synthetic_sizing_table() if path is None else read_csv_columns(path)


def sample_row(table: Table, random_state: int) -> dict:
    """pandas' ``DataFrame.sample(1, random_state=random_state).iloc[0]
    .to_dict()``: one row drawn without replacement from
    ``np.random.RandomState(random_state)``."""
    n = len(next(iter(table.values())))
    i = int(np.random.RandomState(random_state).choice(n, size=1, replace=False)[0])
    return {k: v[i] for k, v in table.items()}


def autosize_pv(demand_kwh: float, epw_filepath: str, random_seed: int,
                use_sample_target: Optional[bool] = None,
                zero_net_energy_proportion=None, roof_area: float = None,
                safety_factor=None, sizing_data: Table = None
                ) -> Tuple[float, np.ndarray]:
    """Reference ``PV.autosize`` sizing math (``energy_model.py:532-601``)
    on the PVWatts-equivalent simulation.

    Returns ``(nominal_power [kW], inverter_ac_power_per_kw [W/kW])``;
    the latter becomes the building's ``solar_generation`` input series
    (reference ``building.py:2440-2441``).
    """
    znep = seeding.resolve(zero_net_energy_proportion, (0.7, 1.0), random_seed)
    safety = seeding.resolve(safety_factor, 1.0, random_seed)
    roof_area = np.inf if roof_area is None else float(roof_area)
    use_sample_target = bool(use_sample_target) if use_sample_target is not None else False

    sizing = get_pv_sizing_data() if sizing_data is None else sizing_data

    # NREL PySAM's Pvwattsv8 'PVWattsNone' model when the package imports:
    # the reference's flow with its 3-try re-sample loop on simulation
    # failure (energy_model.py:538-566); else the numpy chain above
    try:
        import PySAM.Pvwattsv8 as Pvwattsv8  # noqa: N813
    except ImportError:
        Pvwattsv8 = None

    if Pvwattsv8 is not None:
        tries = 3
        for i in range(tries):
            config = sample_row(sizing, random_seed + i)
            model = Pvwattsv8.default("PVWattsNone")
            pv_nominal_power = float(config["nameplate_capacity_module_1"]) / 1000.0
            model.SystemDesign.system_capacity = pv_nominal_power
            model.SystemDesign.dc_ac_ratio = config["inverter_loading_ratio"]
            model.SystemDesign.tilt = config["tilt_1"]
            model.SystemDesign.azimuth = config["azimuth_1"]
            model.SystemDesign.bifaciality = config["bifacial_module_1"] * 0.65
            model.SolarResource.solar_resource_file = epw_filepath
            try:
                model.execute()
                break
            except Exception:
                if i == tries - 1:
                    raise
        inverter_ac_power_per_kw = (np.array(model.Outputs.ac, dtype="float32")
                                    / pv_nominal_power)
    else:
        config = sample_row(sizing, random_seed)
        pv_nominal_power = float(config["nameplate_capacity_module_1"]) / 1000.0
        epw = read_epw(epw_filepath)
        ac = pvwatts_ac(epw, pv_nominal_power,
                        float(config["inverter_loading_ratio"]),
                        float(config["tilt_1"]), float(config["azimuth_1"]),
                        float(config.get("bifacial_module_1") or 0.0) * 0.65)
        inverter_ac_power_per_kw = (ac / pv_nominal_power).astype(np.float32)

    if use_sample_target:
        target_nominal_power = float(config["PV_system_size_DC"])
    else:
        zne_nominal_power = demand_kwh / float(
            np.sum(inverter_ac_power_per_kw / 1000.0))
        limited = zne_nominal_power * znep
        target_nominal_power = math.floor(
            limited * safety / pv_nominal_power) * pv_nominal_power

    module_area = config.get("module_area")
    pv_area = (pv_nominal_power * 5.263
               if module_area is None or (isinstance(module_area, float)
                                          and math.isnan(module_area))
               else float(module_area))
    if np.isinf(roof_area):
        roof_limit = np.inf
    else:
        roof_limit = math.floor(roof_area / pv_area) * pv_nominal_power

    nominal_power = min(max(target_nominal_power, pv_nominal_power), roof_limit)
    return float(nominal_power), inverter_ac_power_per_kw
