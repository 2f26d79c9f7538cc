"""Fast-path episode dispatcher: run an eligible configuration under an
open-loop plan as ONE whole-episode kernel launch in place of the
stepped loop of :mod:`citylearn_tpu_torch.core.rollout` — battery+PV
districts on :func:`citylearn_tpu_torch.ops.battery.battery_episode`,
thermal-storage districts on
:func:`citylearn_tpu_torch.ops.thermal.thermal_episode`, EV districts on
:func:`citylearn_tpu_torch.ops.ev.ev_episode`, LSTM-dynamics districts on
:func:`citylearn_tpu_torch.ops.lstm.lstm_episode`, and the neighborhood and
occupant districts on
:func:`citylearn_tpu_torch.ops.neighborhood.neighborhood_episode`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.core.types import BatteryParams, DistrictParams, StaticConfig
from citylearn_tpu_torch.ops.battery import battery_episode
from citylearn_tpu_torch.ops.ev import MAX_LANES, ev_episode
from citylearn_tpu_torch.ops.lstm import (
    L_COOL_ACTIVE,
    L_LIN_B,
    L_NMIN_CC,
    L_NMIN_TC,
    L_NSPAN_CC,
    L_NSPAN_TC,
    N_LROWS,
    lstm_episode,
    pack_weights,
    pad4,
)
from citylearn_tpu_torch.ops.neighborhood import N_NROWS, neighborhood_episode
from citylearn_tpu_torch.ops.thermal import N_TROWS, thermal_episode

THERMAL_KEYS = ("cooling_storage", "dhw_storage", "electrical_storage")
LSTM_KEYS = ("cooling_device",) + THERMAL_KEYS
NEIGHBORHOOD_KEYS = ("cooling_or_heating_device", "cooling_device", "heating_device",
                     "electrical_storage")
# the JAX package's lane tile: its neighborhood kernel holds a district's
# buildings in one, and so does this package's eligibility rule
B_PAD = 128
_REWARD_OK = ("RewardFunction", "IndependentSACReward")
# IndependentSACReward min(-net, 0) == -max(net, 0) == the default reward
# at exponent 1 (reward_function.py:65-88,159-168)


def refuse_parity(cfg: StaticConfig):
    """Raise ``ValueError`` for a float64 parity-mode configuration.

    The whole-episode kernels compute in float32 and have no store-point
    rounding, so they would not honour the mode. (The JAX package's kernel
    paths never read ``parity_f64``; only its Gym env sets it.) The stepped
    path runs the mode."""
    if cfg.parity_f64:
        raise ValueError("the whole-episode kernels run float32 and refuse the float64 "
                         "parity mode (parity_f64); step it with core.step.district_step "
                         "or the Gym env")


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


def battery_tables(bat: BatteryParams):
    """The battery kernels' parameter rows and curves for the batteries
    ``bat`` (the buildings', or the EVs'): ``bparams`` (8, B) rows
    capacity, nominal_power, loss_coefficient, initial_soc,
    depth_of_discharge, capacity_loss_coefficient and two zero rows; the
    four curves knot-major (n_knots, B), trimmed by :func:`_n_knots`."""
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
    bparams, curves = battery_tables(params.battery)
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
    refuse_parity(cfg)
    if not eligible(cfg):
        raise ValueError("configuration not eligible for the battery fast path")
    params = params.to(resolve_device(device))
    return battery_episode(**battery_episode_inputs(
        cfg, params, n_districts, action_table, n_steps, data_offset),
        record=record_series)


def thermal_rows(params: DistrictParams) -> torch.Tensor:
    """The thermal kernels' parameter rows (N_TROWS, B), in
    ``ops/thermal.py``'s row order."""
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
    return torch.stack(rows)


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
    bparams, curves = battery_tables(params.battery)

    ct, dt = params.cooling_storage, params.dhw_storage
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
        tparams=thermal_rows(params),
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
    refuse_parity(cfg)
    if not eligible_thermal(cfg):
        raise ValueError("configuration not eligible for the thermal fast path")
    params = params.to(resolve_device(device))
    return thermal_episode(**thermal_episode_inputs(
        cfg, params, n_districts, action_tables, n_steps, data_offset),
        record=record_series)


def eligible_ev(cfg: StaticConfig) -> bool:
    """Battery+PV buildings with EV chargers and washing machines (the
    ``..._plus_evs`` and charging-constraints configurations): no thermal
    end-uses, outage, dynamics or occupants. Charging constraints are
    action-only math, precomputed host-side by the dispatcher
    (scaled per-charger plans + violation streams).

    central_agent is allowed — same reasoning as
    :func:`eligible_thermal`: only reward aggregation and observation
    layout change, not physics; kernel reward_sum stays per-building."""
    return (cfg.has_evs and not cfg.any_cooling and not cfg.any_heating
            and not cfg.any_dhw and not cfg.has_dynamics
            and not cfg.any_outage and not cfg.has_occupant
            and cfg.reward_per_building is None
            and (cfg.reward_type == "Electric_Vehicles_Reward_Function"
                 or (cfg.reward_type in _REWARD_OK
                     and cfg.reward_exponent == 1.0)))


def apply_charging_constraints_np(cfg: StaticConfig, params: DistrictParams, a: np.ndarray):
    """Numpy replication of the building/phase charging-constraint
    scaling (reference ``building.py:901-989``; core/step.py
    ``_charging_constraints``) for an (S, C) open-loop charger plan —
    constraints depend only on the ACTIONS and static limits, so the
    kernel path precomputes the scaled plan and the per-building
    violation kWh stream host-side. Returns (plan (S, C), violation
    (S, B)), float32."""
    ch = params.chargers
    B = cfg.n_buildings
    S, C = a.shape
    maxc, bld, blim, pidx, plim, pbld = (x.cpu().numpy() for x in (
        ch.max_charging_power, ch.building_index, ch.cc_building_limit,
        ch.cc_phase_index, ch.cc_phase_limit, ch.cc_phase_building))
    P = cfg.n_charging_phases
    hours_ratio = cfg.seconds_per_time_step / 3600.0

    pos = (a > 0.0) & (maxc > 0.0)[None, :]
    req = np.where(pos, a * maxc[None, :], 0.0)
    tot_b = np.zeros((S, B))
    for c in range(C):
        tot_b[:, bld[c]] += req[:, c]
    over_b = np.isfinite(blim)[None, :] & (tot_b > blim[None, :])
    scale_b = np.where(over_b,
                       np.where(blim[None, :] == 0.0, 0.0,
                                blim[None, :] / np.maximum(tot_b, 1e-12)), 1.0)
    viol_b = np.where(over_b, tot_b - blim[None, :], 0.0)
    scaled1 = req * scale_b[:, bld]
    tot_p = np.zeros((S, P))
    for c in range(C):
        if pidx[c] >= 0:
            tot_p[:, pidx[c]] += scaled1[:, c]
    over_p = np.isfinite(plim)[None, :] & (tot_p > plim[None, :])
    scale_p = np.where(over_p,
                       np.where(plim[None, :] == 0.0, 0.0,
                                plim[None, :] / np.maximum(tot_p, 1e-12)), 1.0)
    viol_p = np.where(over_p, tot_p - plim[None, :], 0.0)
    for pi in range(P):
        viol_b[:, pbld[pi]] += viol_p[:, pi]
    scale_p_full = np.concatenate([scale_p, np.ones((S, 1))], axis=1)
    pidx_full = np.where(pidx >= 0, pidx, P)
    target = scaled1 * scale_p_full[:, pidx_full]
    a_out = np.where(
        pos, np.maximum(0.0, np.minimum(a, target / np.maximum(maxc[None, :], 1e-12))),
        np.where((a > 0.0) & (maxc <= 0.0)[None, :], 0.0, a))
    return a_out.astype(np.float32), (viol_b * hours_ratio).astype(np.float32)


def ev_episode_inputs(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                      action_tables: Dict[str, object], n_steps: Optional[int] = None,
                      data_offset: int = 0) -> dict:
    """Keyword arguments of :func:`citylearn_tpu_torch.ops.ev.ev_episode`
    for ``n_districts`` fresh copies of the district under open-loop plans
    (see :func:`run_ev_episode`), on the device of ``params``. Series of
    the sim range follow ``data_offset``; charger, EV and machine
    schedules are episode-relative and stay un-shifted, as on the stepped
    path."""
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    off = int(data_offset)
    B = cfg.n_buildings
    C, V, W = cfg.n_chargers, cfg.n_evs, cfg.n_washing_machines
    if max(B, C, V, W) > MAX_LANES:
        raise ValueError(f"the EV fast path takes up to {MAX_LANES} buildings, chargers, "
                         f"EVs and machines, got {B}, {C}, {V}, {W}")
    dev = params.device
    ser, ch, evp = params.series, params.chargers, params.evs
    f32 = lambda x: x.to(torch.float32)

    def schedule(arr, fill):
        """Rows [0, S) of an episode-relative schedule, ``fill`` past its end."""
        out = torch.full((S,) + arr.shape[1:], fill, dtype=arr.dtype, device=dev)
        out[:min(S, arr.shape[0])] = arr[:S]
        return out

    if cfg.has_washing_machines:
        wmp = params.washing_machines
        machines = (schedule(f32(wmp.wm_start), -1.0), schedule(f32(wmp.wm_end), -1.0),
                    schedule(wmp.triggered_load, 0.0))
        wm_bld = wmp.building_index
    else:
        machines = tuple(torch.zeros((S, 0), device=dev) for _ in range(3))
        wm_bld = torch.zeros(0, dtype=torch.int32, device=dev)

    hours = ser.hour[off:off + S, 0].cpu().numpy()
    viol = np.zeros((S, B), np.float32)
    actions = []
    for key, n in (("electrical_storage", B), ("electric_vehicle_storage", C),
                   ("washing_machine", W)):
        plan = np.zeros((S, n), np.float32)
        if action_tables.get(key) is not None and n > 0:
            plan = expand_action_plan(action_tables[key], hours, S, n)
            if key == "electric_vehicle_storage" and cfg.has_charging_constraints:
                plan, viol = apply_charging_constraints_np(cfg, params, plan)
        actions.append(torch.tensor(np.ascontiguousarray(plan), device=dev))

    bat, eb = params.battery, evp.battery
    bparams, curves = battery_tables(bat)
    evparams, ev_curves = battery_tables(eb)
    ch_knots = _n_knots((ch.charge_eff_x, ch.discharge_eff_x))
    tile = lambda v: v.expand(n_districts, v.shape[0]).contiguous()
    return dict(
        actions=tuple(actions),
        series=(*(_pad_time(x, S, off) for x in (
            ser.non_shiftable_load, ser.solar_generation, ser.electricity_pricing,
            ser.carbon_intensity)),
            schedule(ch.connected_ev, -1), schedule(ch.required_soc, 0.0),
            schedule(ch.departure_time, 0.0),
            schedule(evp.force_soc, float("nan")), schedule(evp.drift_mult, float("nan")),
            *machines),
        bparams=bparams, curves=curves,
        cparams=torch.stack([ch.max_charging_power, ch.min_charging_power,
                             ch.max_discharging_power, ch.min_discharging_power]),
        ch_curves=tuple(c.t()[:ch_knots].contiguous() for c in (
            ch.charge_eff_x, ch.charge_eff_y, ch.discharge_eff_x, ch.discharge_eff_y)),
        evparams=evparams, ev_curves=ev_curves,
        ch_bld=ch.building_index, wm_bld=wm_bld,
        state0=(tile(bat.initial_soc), tile(bat.efficiency), tile(bat.capacity),
                tile(eb.initial_soc), tile(eb.efficiency), tile(eb.capacity),
                torch.zeros((n_districts, W), device=dev)),
        hours_ratio=cfg.seconds_per_time_step / 3600.0,
        ratio=cfg.time_step_ratio,
        ev_weights=tuple(cfg.ev_reward_weights),
        use_ev_reward=cfg.reward_type == "Electric_Vehicles_Reward_Function",
        viol=torch.tensor(viol, device=dev),
        penalty_coefficient=float(cfg.charging_penalty_coefficient))


def run_ev_episode(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                   action_tables: Dict[str, object], n_steps: Optional[int] = None,
                   record_series: bool = False, data_offset: int = 0, device=None):
    """Whole-episode rollout on the EV kernel for ``n_districts``
    identical district copies; ``action_tables``: open-loop plans per
    action class — ``electrical_storage`` ((24,) | (S,) | (S, B) over
    buildings), ``electric_vehicle_storage`` (... over the C chargers),
    ``washing_machine`` (... over the W machines); missing keys act 0 —
    on ``device`` (the CUDA card by default).

    Returns (reward_sum, cost_sum, emission_sum, battery_soc, battery_eff,
    battery_degraded, ev_soc, ev_eff, ev_degraded, wm_initiated) — the
    first six (D, B), the EV triple (D, V), wm (D, W); with
    ``record_series=True`` an (N_EREC, S, B) per-step stream of district
    0 is appended (net, raw battery balance/soc, charger and washing-
    machine consumptions, reward)."""
    refuse_parity(cfg)
    if not eligible_ev(cfg):
        raise ValueError("configuration not eligible for the EV fast path")
    params = params.to(resolve_device(device))
    return ev_episode(**ev_episode_inputs(
        cfg, params, n_districts, action_tables, n_steps, data_offset),
        record=record_series)


def eligible_lstm(cfg: StaticConfig) -> bool:
    """LSTM-dynamics districts (the 2023 challenge family): dynamics
    groups, cooling-device partial load, DHW + battery, ComfortReward,
    with or without power outages; no EVs/WMs/occupants. Data-level
    conditions (every building in a group, one or two LSTM layers, a shared
    lookback, inert heating) are checked by :func:`lstm_packable`.

    central_agent is allowed: it only changes the reward's aggregation and
    the observation layout, not the physics; the kernel's reward sum stays
    per building."""
    return (cfg.has_dynamics and len(cfg.dyn_groups) >= 1
            and not cfg.has_occupant and not cfg.has_evs
            and not cfg.has_washing_machines
            and not cfg.has_charging_constraints
            and cfg.reward_per_building is None
            and cfg.reward_type == "ComfortReward")


def _lstm_units(cfg: StaticConfig, params: DistrictParams):
    """Per building: its dynamics group, its row in the group and the
    group's static meta (layers, hidden size, channels, temperature,
    cooling and heating channel, lookback)."""
    units = [None] * cfg.n_buildings
    for g, (meta, dyn) in enumerate(zip(cfg.dyn_groups, params.dynamics)):
        lookback, L, H, F, tc, cc, hc = meta
        for row, b in enumerate(dyn.member_indices.cpu().numpy()):
            units[int(b)] = dict(g=g, row=row, L=int(L), H=int(H), F=int(F), tc=int(tc),
                                 cc=int(cc), hc=int(hc), lookback=int(lookback))
    return units


def lstm_packable(cfg: StaticConfig, params: DistrictParams) -> bool:
    """Data-level eligibility for the LSTM kernel: every building covered
    by some group, layer counts 1-2, shared lookback, no heating-side
    dynamics, inert heating end use. The sums of channel and hidden widths
    are held to 128 as the JAX package's lane tiles hold them, so that a
    configuration takes the same path in both packages; the kernel's own
    limits are per building and raise in :func:`ops.lstm.lstm_episode`."""
    if not eligible_lstm(cfg):
        return False
    covered = np.concatenate([d.member_indices.cpu().numpy() for d in params.dynamics])
    if not np.array_equal(np.sort(covered), np.arange(cfg.n_buildings)):
        return False
    units = _lstm_units(cfg, params)
    if len({u["lookback"] for u in units}) != 1 \
            or sum(u["F"] for u in units) > 128 or sum(u["H"] for u in units) > 128:
        return False
    if any(u["L"] not in (1, 2) or u["cc"] < 0 or u["hc"] >= 0 for u in units):
        return False
    if any(bool(d.heating_device_active.any()) or bool(d.cooling_or_heating_active.any())
           for d in params.dynamics):
        return False
    # heating end-use must be inert (zero demand, zero tank)
    return (float(params.series.heating_demand.max()) <= 0.0
            and float(params.heating_storage.capacity.max()) <= 0.0)


def lstm_tables(cfg: StaticConfig, params: DistrictParams, S: int, off: int):
    """Per building of a dynamics district, for the kernels that run its
    LSTM: ``(units, buildings, schan, rows)`` — :func:`_lstm_units`; one
    dict per building for :func:`citylearn_tpu_torch.ops.lstm.pack_weights`;
    the static channels of the window ``[off, off + S)``, pre-normalized at
    pack time, each building's ``pad4(F)`` columns side by side with its
    dynamic channels (temperature, cooling and heating demand) zeroed, (S,
    X) numpy; and (B,) numpy rows ``nmin_*`` / ``nspan_*`` (the
    normalization minimum and span of the temperature, cooling- and
    heating-demand channels ``tc``, ``cc``, ``hc``; 0 and 1 where a
    building has no such channel), ``lin_b`` (the head's bias) and
    ``cool_active`` (cooling_device availability)."""
    B = cfg.n_buildings
    units = _lstm_units(cfg, params)
    host = [{k: getattr(d, k).cpu().numpy()
             for k in ("lin_w", "lin_b", "norm_min", "norm_max", "cooling_device_active")}
            for d in params.dynamics]
    static = [d.static_channels[off:off + S].cpu().numpy() for d in params.dynamics]
    layers = [[[w.cpu().numpy() for w in per_layer] for per_layer in (d.w_ih, d.w_hh, d.bias)]
              for d in params.dynamics]
    rows = {k: np.zeros(B, np.float32) for k in (
        "nmin_tc", "nmin_cc", "nmin_hc", "lin_b", "cool_active")}
    rows.update({k: np.ones(B, np.float32) for k in ("nspan_tc", "nspan_cc", "nspan_hc")})
    schan = np.zeros((S, sum(pad4(u["F"]) for u in units)), np.float32)
    buildings, x_off = [], 0
    for b, u in enumerate(units):
        g, row, F = u["g"], u["row"], u["F"]
        nmin, nmax = host[g]["norm_min"][row], host[g]["norm_max"][row]
        for name in ("tc", "cc", "hc"):
            ch = u[name]
            if ch >= 0:
                rows[f"nmin_{name}"][b], rows[f"nspan_{name}"][b] = nmin[ch], nmax[ch] - nmin[ch]
        rows["lin_b"][b] = host[g]["lin_b"][row]
        rows["cool_active"][b] = float(host[g]["cooling_device_active"][row])
        window = static[g][:, row, :]
        schan[:window.shape[0], x_off:x_off + F] = window
        for ch in (u["tc"], u["cc"], u["hc"]):
            if ch >= 0:
                schan[:, x_off + ch] = 0.0
        w_ih, w_hh, bias = ([w[row] for w in per_layer] for per_layer in layers[g])
        buildings.append(dict(w_ih=w_ih, w_hh=w_hh, bias=bias, lin_w=host[g]["lin_w"][row],
                              tc=u["tc"], cc=u["cc"], hc=u["hc"]))
        x_off += pad4(F)
    return units, buildings, schan, rows


def lstm_episode_inputs(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                        action_tables: Dict[str, object], n_steps: Optional[int] = None,
                        data_offset: int = 0) -> dict:
    """Keyword arguments of :func:`citylearn_tpu_torch.ops.lstm.lstm_episode`
    for ``n_districts`` fresh copies of the district under open-loop plans
    (see :func:`run_lstm_episode`), on the device of ``params``."""
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    off = int(data_offset)
    B = cfg.n_buildings
    dev = params.device
    ser = params.series
    hours = ser.hour[off:off + S, 0].cpu().numpy()
    plan = lambda k: torch.tensor(
        np.ascontiguousarray(expand_action_plan(action_tables[k], hours, S, B))
        if action_tables.get(k) is not None else np.zeros((S, B), np.float32), device=dev)
    bparams, curves = battery_tables(params.battery)
    units, buildings, schan, rows = lstm_tables(cfg, params, S, off)
    lrows = np.zeros((N_LROWS, B), np.float32)
    lrows[L_NMIN_CC], lrows[L_NSPAN_CC] = rows["nmin_cc"], rows["nspan_cc"]
    lrows[L_NMIN_TC], lrows[L_NSPAN_TC] = rows["nmin_tc"], rows["nspan_tc"]
    lrows[L_LIN_B], lrows[L_COOL_ACTIVE] = rows["lin_b"], rows["cool_active"]

    band = (torch.full((S, B), float(cfg.reward_band), device=dev)
            if cfg.reward_band is not None else _pad_time(ser.comfort_band, S, off))
    bat, ct, dt = params.battery, params.cooling_storage, params.dhw_storage
    tile = lambda v: v.expand(n_districts, B).contiguous()
    return dict(
        actions=tuple(plan(k) for k in LSTM_KEYS),
        series=(*(_pad_time(x, S, off) for x in (
            ser.non_shiftable_load, ser.solar_generation, ser.electricity_pricing,
            ser.carbon_intensity, ser.cooling_demand, ser.dhw_demand,
            ser.outdoor_dry_bulb_temperature, ser.hvac_mode.to(torch.float32),
            ser.indoor_dry_bulb_temperature,
            ser.indoor_dry_bulb_temperature_cooling_set_point,
            ser.indoor_dry_bulb_temperature_heating_set_point)),
            band, torch.tensor(schan, device=dev), _pad_time(ser.power_outage, S, off)),
        bparams=bparams, curves=curves, tparams=thermal_rows(params),
        lparams=torch.tensor(lrows, device=dev),
        weights=pack_weights(buildings, dev),
        csoc0=tile(ct.initial_soc), dsoc0=tile(dt.initial_soc),
        soc0=tile(bat.initial_soc), eff0=tile(bat.efficiency), deg0=tile(bat.capacity),
        hours_ratio=cfg.seconds_per_time_step / 3600.0, ratio=cfg.time_step_ratio,
        lookback=units[0]["lookback"],
        lo_exp=float(cfg.reward_lower_exponent), hi_exp=float(cfg.reward_higher_exponent))


def run_lstm_episode(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                     action_tables: Dict[str, object], n_steps: Optional[int] = None,
                     record_series: bool = False, data_offset: int = 0, device=None):
    """Whole-episode rollout on the LSTM-dynamics kernel for
    ``n_districts`` identical district copies under open-loop plans
    ``{action_name: (24,) hour table | (S,) | (S, B)}`` over
    cooling_device / cooling_storage / dhw_storage / electrical_storage
    (missing keys act 0), on ``device`` (the CUDA card by default).

    Returns (reward_sum, cost_sum, emission_sum, cool_soc, dhw_soc,
    bat_soc, bat_eff, bat_degraded, last_temp), each (D, B); with
    ``record_series=True`` an (N_LREC, S, B) per-step stream of district
    0 is appended (see :mod:`citylearn_tpu_torch.ops.lstm` row constants).
    ``data_offset`` shifts the episode window as in
    :func:`run_battery_episode`."""
    refuse_parity(cfg)
    if not lstm_packable(cfg, params):
        raise ValueError("configuration not eligible for the LSTM fast path")
    params = params.to(resolve_device(device))
    return lstm_episode(**lstm_episode_inputs(
        cfg, params, n_districts, action_tables, n_steps, data_offset),
        record=record_series)


def eligible_neighborhood(cfg: StaticConfig) -> bool:
    """LSTM-dynamics districts that the LSTM kernel does not serve: the EULP
    neighborhoods (47-100 heterogeneous buildings, signed
    cooling_or_heating partial load, the default reward) and the quebec
    occupant family (heating-side partial load, ComfortReward, occupant
    interaction). The kernel runs the physics of every district; the
    temperature and occupant sequence runs once, in the post-pass
    (:mod:`citylearn_tpu_torch.core.neighborhood_eval`). Data-level
    conditions (inert tanks, a shared lookback, every building covered,
    B <= 128) are checked by :func:`neighborhood_packable`."""
    return (cfg.has_dynamics and len(cfg.dyn_groups) >= 1
            and not cfg.has_evs and not cfg.has_washing_machines
            and not cfg.any_outage and not cfg.has_charging_constraints
            and cfg.reward_per_building is None
            and (cfg.reward_type == "ComfortReward"
                 or (cfg.reward_type in _REWARD_OK and cfg.reward_exponent == 1.0)))


def neighborhood_packable(cfg: StaticConfig, params: DistrictParams) -> bool:
    """Data-level eligibility for the neighborhood kernel: every building
    covered by a dynamics group with one shared lookback, at most 128
    buildings, and zero cooling and heating tank capacity — which, through
    the reference's conversion of the DHW action by the heating tank's
    capacity (``building.py:1765``), makes every tank inert, the
    precondition of the kernel's device-only dispatch. A district that the
    LSTM kernel serves is not this kernel's."""
    if not eligible_neighborhood(cfg):
        return False
    if eligible_lstm(cfg) and lstm_packable(cfg, params):
        return False
    if cfg.n_buildings > B_PAD:
        return False
    covered = np.concatenate([d.member_indices.cpu().numpy() for d in params.dynamics])
    if not np.array_equal(np.sort(covered), np.arange(cfg.n_buildings)):
        return False
    if len({int(meta[0]) for meta in cfg.dyn_groups}) != 1:
        return False
    return (float(params.cooling_storage.capacity.max()) <= 0.0
            and float(params.heating_storage.capacity.max()) <= 0.0)


def neighborhood_rows(params: DistrictParams) -> torch.Tensor:
    """The neighborhood kernel's parameter rows (N_NROWS, B), in
    ``ops/neighborhood.py``'s row order; the partial-load availability
    rows are the union over the dynamics groups."""
    B = params.battery.capacity.shape[0]
    active = torch.zeros((3, B), dtype=torch.float32, device=params.device)
    for dyn in params.dynamics:
        m = dyn.member_indices.long()
        flags = torch.stack([dyn.cooling_device_active, dyn.heating_device_active,
                             dyn.cooling_or_heating_active]).to(torch.float32)
        active[:, m] = torch.maximum(active[:, m], flags)
    cd, hd, dd = params.cooling_device, params.heating_device, params.dhw_device
    dt = params.dhw_storage
    rows = [
        cd.nominal_power, cd.efficiency, cd.target_cooling_temperature,
        cd.is_heat_pump.to(torch.float32),
        hd.nominal_power, hd.efficiency, hd.target_heating_temperature,
        hd.is_heat_pump.to(torch.float32),
        dd.nominal_power, dd.efficiency, dd.target_heating_temperature,
        dd.is_heat_pump.to(torch.float32),
        dt.capacity, dt.loss_coefficient, *active,
    ]
    assert len(rows) == N_NROWS
    return torch.stack(rows)


def neighborhood_episode_inputs(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                                action_tables: Dict[str, object],
                                n_steps: Optional[int] = None, data_offset: int = 0) -> dict:
    """Keyword arguments of
    :func:`citylearn_tpu_torch.ops.neighborhood.neighborhood_episode` for
    ``n_districts`` fresh copies of the district under open-loop plans
    (see :func:`run_neighborhood_episode`), on the device of ``params``.
    Plans of other actions are inert on an eligible district and are not
    read."""
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    off = int(data_offset)
    B = cfg.n_buildings
    ser = params.series
    hours = ser.hour[off:off + S, 0].cpu().numpy()
    plan = lambda k: torch.tensor(
        np.ascontiguousarray(expand_action_plan(action_tables[k], hours, S, B))
        if action_tables.get(k) is not None else np.zeros((S, B), np.float32),
        device=params.device)
    bparams, curves = battery_tables(params.battery)
    bat, dt = params.battery, params.dhw_storage
    tile = lambda v: v.expand(n_districts, B).contiguous()
    return dict(
        actions=tuple(plan(k) for k in NEIGHBORHOOD_KEYS),
        series=tuple(_pad_time(x, S, off) for x in (
            ser.non_shiftable_load, ser.solar_generation, ser.electricity_pricing,
            ser.carbon_intensity, ser.cooling_demand, ser.heating_demand, ser.dhw_demand,
            ser.outdoor_dry_bulb_temperature, ser.hvac_mode.to(torch.float32))),
        bparams=bparams, curves=curves, nparams=neighborhood_rows(params),
        dsoc0=tile(dt.initial_soc), soc0=tile(bat.initial_soc), eff0=tile(bat.efficiency),
        deg0=tile(bat.capacity),
        hours_ratio=cfg.seconds_per_time_step / 3600.0, ratio=cfg.time_step_ratio,
        lookback=int(cfg.dyn_groups[0][0]))


def run_neighborhood_episode(cfg: StaticConfig, params: DistrictParams, n_districts: int,
                             action_tables: Dict[str, object], n_steps: Optional[int] = None,
                             record_series: bool = False, data_offset: int = 0, device=None):
    """Whole-episode rollout on the neighborhood kernel for ``n_districts``
    identical district copies under open-loop plans ``{action_name: (24,)
    hour table | (S,) | (S, B)}`` over cooling_or_heating_device /
    cooling_device / heating_device / electrical_storage (missing keys act
    0; dhw_storage plans are inert on this family and are not read), on
    ``device`` (the CUDA card by default).

    Returns (reward_sum, cost_sum, emission_sum, dhw_soc, bat_soc, bat_eff,
    bat_degraded), each (D, B); with ``record_series=True`` an (N_NREC, S,
    B) per-step stream of district 0 is appended (see
    :mod:`citylearn_tpu_torch.ops.neighborhood` row constants). The reward
    sum is the default exponent-1 reward; the ComfortReward of a quebec
    district depends on the temperature of the post-pass and is not
    summed here. ``data_offset`` shifts the episode window as in
    :func:`run_battery_episode`."""
    refuse_parity(cfg)
    if not neighborhood_packable(cfg, params):
        raise ValueError("configuration not eligible for the neighborhood fast path")
    params = params.to(resolve_device(device))
    return neighborhood_episode(**neighborhood_episode_inputs(
        cfg, params, n_districts, action_tables, n_steps, data_offset),
        record=record_series)
