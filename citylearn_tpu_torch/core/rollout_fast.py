"""Fast-path episode dispatcher: run an eligible configuration under an
open-loop plan as ONE whole-episode kernel launch in place of the
stepped loop of :mod:`citylearn_tpu_torch.core.rollout` — battery+PV
districts on :func:`citylearn_tpu_torch.ops.battery.battery_episode`,
thermal-storage districts on
:func:`citylearn_tpu_torch.ops.thermal.thermal_episode`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.core.types import DistrictParams, StaticConfig
from citylearn_tpu_torch.ops.battery import battery_episode
from citylearn_tpu_torch.ops.thermal import N_TROWS, thermal_episode

THERMAL_KEYS = ("cooling_storage", "dhw_storage", "electrical_storage")
_REWARD_OK = ("RewardFunction", "IndependentSACReward")
# IndependentSACReward min(-net, 0) == -max(net, 0) == the default reward
# at exponent 1 (reward_function.py:65-88,159-168)


def eligible(cfg: StaticConfig) -> bool:
    """Battery+PV-only districts with no outage/dynamics/EV/WM and the
    default exponent-1 reward — the vectorized-training workhorse
    configuration (2022 challenge family)."""
    return (not cfg.any_cooling and not cfg.any_heating and not cfg.any_dhw
            and not cfg.has_dynamics and not cfg.has_evs
            and not cfg.has_washing_machines and not cfg.any_outage
            and cfg.reward_type == "RewardFunction"
            and cfg.reward_exponent == 1.0)


def eligible_thermal(cfg: StaticConfig) -> bool:
    """Cooling/DHW + battery districts (the 2021 challenge family):
    thermal tanks and heat-pump/heater devices fused whole-episode; no
    heating end-use, outage, dynamics, EVs, WMs or occupants.

    A central agent is allowed: central agency only changes the reward's
    aggregation and the observation layout, never the physics or the KPI
    series the kernel records. The kernel's reward sum stays per-building,
    so consumers needing the central reward use the stepped path —
    kernel-backed evaluation never reads rewards."""
    return ((cfg.any_cooling or cfg.any_dhw) and not cfg.any_heating
            and not cfg.has_dynamics and not cfg.has_evs
            and not cfg.has_washing_machines and not cfg.any_outage
            and not cfg.has_occupant
            and cfg.reward_per_building is None
            and cfg.reward_type in _REWARD_OK
            and cfg.reward_exponent == 1.0)


def _pad_time(arr: torch.Tensor, n: int, off: int = 0) -> torch.Tensor:
    """Rows ``[off, off + n)`` of a sim-range series, zeros past the range."""
    out = torch.zeros((n,) + arr.shape[1:], dtype=arr.dtype, device=arr.device)
    win = arr[off:off + n]
    out[:win.shape[0]] = win
    return out


def expand_action_plan(arr, hours: np.ndarray, S: int, B: int) -> np.ndarray:
    """Normalize an action input to an (S, B) open-loop plan: a (24,)
    hour-indexed table broadcasts over buildings, an (S,) series
    broadcasts over buildings, an (S, B) plan passes through."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 1 and arr.shape[0] == 24:
        arr = arr[hours - 1]
    if arr.ndim == 1:
        if arr.shape[0] < S:
            raise ValueError(f"per-step plan too short: {arr.shape}")
        arr = np.broadcast_to(arr[:S, None], (S, B))
    if arr.shape[0] < S or arr.shape[1] != B:
        raise ValueError(f"bad plan shape {arr.shape} for {S} steps x {B} buildings")
    return arr[:S]


def _n_knots(curves_x) -> int:
    """Knots up to the last distinct one. The compiler pads curves by
    repeating the last knot; repeated tail knots never win the strict
    ``x < q`` count, so trimming them keeps the lookup unchanged."""
    n_knots = 2
    for cx in curves_x:
        x = cx.cpu().numpy().T                   # (B, P) -> knot-major (P, B)
        diffs = np.any(x[1:] != x[:-1], axis=1)  # knot k+1 differs from k
        if diffs.any():
            n_knots = max(n_knots, int(np.max(np.nonzero(diffs)[0])) + 2)
    return n_knots


def battery_tables(params: DistrictParams):
    """The battery kernels' parameter rows and curves: ``bparams`` (8, B)
    rows capacity, nominal_power, loss_coefficient, initial_soc,
    depth_of_discharge, capacity_loss_coefficient and two zero rows; the
    four curves knot-major (n_knots, B), trimmed by :func:`_n_knots`."""
    bat = params.battery
    zero = torch.zeros_like(bat.capacity)
    n_knots = _n_knots((bat.power_efficiency_curve_x, bat.capacity_power_curve_x))
    bparams = torch.stack([bat.capacity, bat.nominal_power, bat.loss_coefficient,
                           bat.initial_soc, bat.depth_of_discharge,
                           bat.capacity_loss_coefficient, zero, zero])
    curves = tuple(c.t()[:n_knots].contiguous() for c in (
        bat.power_efficiency_curve_x, bat.power_efficiency_curve_y,
        bat.capacity_power_curve_x, bat.capacity_power_curve_y))
    return bparams, curves


def battery_episode_inputs(cfg: StaticConfig, params: DistrictParams,
                           n_districts: int, action_table,
                           n_steps: Optional[int] = None,
                           data_offset: int = 0) -> dict:
    """Keyword arguments of :func:`citylearn_tpu_torch.ops.battery.battery_episode`
    for ``n_districts`` fresh copies of the district under an open-loop
    plan (see :func:`run_battery_episode`), on the device of ``params``."""
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    off = int(data_offset)
    B = cfg.n_buildings
    ser = params.series
    hours = ser.hour[off:off + S, 0].cpu().numpy()
    bat = params.battery
    bparams, curves = battery_tables(params)
    tile = lambda v: v.expand(n_districts, B).contiguous()
    return dict(
        actions=torch.tensor(expand_action_plan(action_table, hours, S, B),
                             device=params.device),
        series=tuple(_pad_time(x, S, off) for x in (
            ser.non_shiftable_load, ser.solar_generation,
            ser.electricity_pricing, ser.carbon_intensity)),
        bparams=bparams,
        curves=curves,
        soc0=tile(bat.initial_soc), eff0=tile(bat.efficiency), deg0=tile(bat.capacity),
        hours_ratio=cfg.seconds_per_time_step / 3600.0,
        ratio=cfg.time_step_ratio)


def run_battery_episode(cfg: StaticConfig, params: DistrictParams,
                        n_districts: int, action_table,
                        n_steps: Optional[int] = None,
                        record_series: bool = False,
                        data_offset: int = 0, device=None):
    """Whole-episode rollout for ``n_districts`` identical district copies
    under an open-loop action plan ((24,) hour table, (S,) series or
    (S, B) per-building plan), on ``device`` (the CUDA card by default).
    Returns per-district per-building reward/cost/emission sums and final
    battery state, each (D, B); with ``record_series=True`` an extra
    (3, S, B) per-step stream of district 0's (net, raw battery balance,
    soc) is appended.

    ``data_offset`` selects a shifted episode window [off, off + S) of
    the sim range (the reference's rolling/random ``EpisodeTracker``
    splits, ``base.py:76-129``): input series and hour tables follow the
    window; explicit per-step plans stay episode-relative."""
    if not eligible(cfg):
        raise ValueError("configuration not eligible for the battery fast path")
    params = params.to(resolve_device(device))
    return battery_episode(**battery_episode_inputs(
        cfg, params, n_districts, action_table, n_steps, data_offset),
        record=record_series)


def thermal_episode_inputs(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                           action_tables: Dict[str, object],
                           n_steps: Optional[int] = None, data_offset: int = 0) -> dict:
    """Keyword arguments of :func:`citylearn_tpu_torch.ops.thermal.thermal_episode`
    for ``n_districts`` fresh copies of the district under open-loop plans
    (see :func:`run_thermal_episode`), on the device of ``params``. Plans
    of other actions are inert on an eligible district and are not read."""
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    off = int(data_offset)
    B = cfg.n_buildings
    ser = params.series
    hours = ser.hour[off:off + S, 0].cpu().numpy()
    plan = lambda k: torch.tensor(
        np.ascontiguousarray(expand_action_plan(action_tables[k], hours, S, B))
        if k in action_tables else np.zeros((S, B), np.float32), device=params.device)
    bparams, curves = battery_tables(params)

    # thermal parameter rows (ops/thermal.py row order)
    cd, dd = params.cooling_device, params.dhw_device
    ct, dt = params.cooling_storage, params.dhw_storage
    rows = [
        cd.nominal_power, cd.efficiency, cd.target_cooling_temperature,
        cd.is_heat_pump.to(torch.float32),
        dd.nominal_power, dd.efficiency, dd.target_heating_temperature,
        dd.is_heat_pump.to(torch.float32),
        ct.capacity, torch.sqrt(ct.efficiency), ct.loss_coefficient,
        ct.max_input_power, ct.max_output_power,
        ct.capacity,                               # cooling converts by itself
        dt.capacity, torch.sqrt(dt.efficiency), dt.loss_coefficient,
        dt.max_input_power, dt.max_output_power,
        params.heating_storage.capacity,           # dhw quirk: building.py:1765
    ]
    assert len(rows) == N_TROWS
    bat = params.battery
    tile = lambda v: v.expand(n_districts, B).contiguous()
    return dict(
        actions=tuple(plan(k) for k in THERMAL_KEYS),
        series=tuple(_pad_time(x, S, off) for x in (
            ser.non_shiftable_load, ser.solar_generation, ser.electricity_pricing,
            ser.carbon_intensity, ser.cooling_demand, ser.dhw_demand,
            ser.outdoor_dry_bulb_temperature)),
        bparams=bparams,
        curves=curves,
        tparams=torch.stack(rows),
        csoc0=tile(ct.initial_soc), dsoc0=tile(dt.initial_soc),
        soc0=tile(bat.initial_soc), eff0=tile(bat.efficiency), deg0=tile(bat.capacity),
        hours_ratio=cfg.seconds_per_time_step / 3600.0,
        ratio=cfg.time_step_ratio)


def run_thermal_episode(cfg: StaticConfig, params: DistrictParams,
                        n_districts: int, action_tables: Dict[str, object],
                        n_steps: Optional[int] = None,
                        record_series: bool = False,
                        data_offset: int = 0, device=None):
    """Whole-episode rollout on the thermal kernel for ``n_districts``
    identical district copies under open-loop action plans
    ``{action_name: (24,) hour table | (S,) | (S, B)}`` (cooling_storage /
    dhw_storage / electrical_storage; missing keys act 0), on ``device``
    (the CUDA card by default).

    Returns (reward_sum, cost_sum, emission_sum, cooling_soc, dhw_soc,
    battery_soc, battery_eff, battery_degraded), each (D, B); with
    ``record_series=True`` an extra (N_TREC, S, B) per-step stream of
    district 0 is appended (see :mod:`citylearn_tpu_torch.ops.thermal`
    row constants). ``data_offset`` shifts the episode window as in
    :func:`run_battery_episode`."""
    if not eligible_thermal(cfg):
        raise ValueError("configuration not eligible for the thermal fast path")
    params = params.to(resolve_device(device))
    return thermal_episode(**thermal_episode_inputs(
        cfg, params, n_districts, action_tables, n_steps, data_offset),
        record=record_series)
