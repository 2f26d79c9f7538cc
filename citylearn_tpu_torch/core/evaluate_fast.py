"""Kernel-backed evaluation: the user-facing KPI table served by the
whole-episode kernels.

The reference's ``evaluate()`` (``citylearn.py:1136-1323``) consumes the
per-step series the env accumulated while stepping. For a kernel-eligible
district (battery+PV, the 2022 family; cooling and DHW storage plus
battery, the 2021 family; battery+PV with EV chargers and washing
machines, the plus_evs family; LSTM temperature dynamics with partial-load
cooling and power outages, the 2023 family; the EULP neighborhoods and the
quebec occupant sets, whose temperature and set points come from a
single-district post-pass) under an *open-loop* policy (hour-indexed
RBC tables or per-target per-step plans), the episode runs as ONE kernel
launch recording district 0's per-step series (net, balances, SOCs,
device outputs); every other KPI input is data-driven, so the recorded
streams rebuild the exact ``collected`` dict of
:func:`citylearn_tpu_torch.core.evaluate.collect_episode` and
:func:`citylearn_tpu_torch.core.evaluate.kpi_table` runs unchanged.

:func:`citylearn_tpu_torch.core.evaluate.evaluate_districts` routes here
when handed a :class:`ScriptedPolicy` on an eligible configuration.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.core import hvac, rollout_fast
from citylearn_tpu_torch.core.evaluate import kpi_table, window
from citylearn_tpu_torch.core.neighborhood_eval import temp_setpoint_series
from citylearn_tpu_torch.core.rollout import ACTION_KEYS
from citylearn_tpu_torch.core.types import DistrictParams, StaticConfig
from citylearn_tpu_torch.ops import ev as ev_ops
from citylearn_tpu_torch.ops import lstm as lstm_ops
from citylearn_tpu_torch.ops import neighborhood as nb_ops
from citylearn_tpu_torch.ops.thermal import R_BBAL, R_CBAL, R_COUT, R_DBAL, R_DOUT, R_NET

#: non-building-axis action classes (per-charger / per-machine plans)
EXTRA_KEYS = ("electric_vehicle_storage", "washing_machine")


class ScriptedPolicy:
    """An open-loop action plan: ``{action_name: (24,) hour table | (S,)
    per-step series | (S, n) per-target plan}`` (targets: buildings;
    chargers for ``electric_vehicle_storage``; machines for
    ``washing_machine``).

    A length-24 leading axis is by default interpreted as an hour-indexed
    table (reference HourRBC semantics). For a 24-STEP per-step plan
    pass ``hour_tables=False``; with the default (auto) a 24-leading
    plan on a 24-step episode resolves as an hour table WITH a warning
    — pass ``hour_tables=True`` to silence it, ``False`` to flip it.

    Scripted policies are state-independent, which is what lets the
    whole-episode kernel serve them; they also act as ordinary policies
    on the stepped path via :meth:`as_policy_fn`."""

    def __init__(self, plans: Dict[str, np.ndarray],
                 hour_tables: Optional[bool] = None):
        unknown = set(plans) - set(ACTION_KEYS) - set(EXTRA_KEYS)
        if unknown:
            raise ValueError(f"unknown action names: {sorted(unknown)}")
        self.plans = {k: np.asarray(v, np.float32) for k, v in plans.items()}
        self.hour_tables = hour_tables

    def _is_hour_table(self, v: np.ndarray, n: int, n_steps: int) -> bool:
        shaped = (v.ndim == 1 and v.shape[0] == 24) or \
            (v.ndim == 2 and v.shape[0] == 24 and v.shape[1] == n)
        if not shaped or self.hour_tables is False:
            return False
        if self.hour_tables is None and n_steps == 24:
            warnings.warn(
                "a 24-leading action plan on a 24-step episode is "
                "ambiguous; resolving as an HOUR-INDEXED table — pass "
                "ScriptedPolicy(..., hour_tables=False) for a per-step "
                "plan (or True to silence this warning)", stacklevel=3)
        return True

    @classmethod
    def from_hour_rbc(cls, agent, n_buildings: int, spec=None) -> "ScriptedPolicy":
        """(24, n) plans from an :class:`citylearn_tpu_torch.agents.rbc.HourRBC`
        agent's resolved per-building hour maps (reference
        ``agents/rbc.py:80-136``). A central agent carries ONE name-keyed
        map shared by every building. Pass the compiled ``spec`` to route
        per-charger (``electric_vehicle_storage_<id>``) and
        washing-machine hour maps onto their district-wide plan axes."""
        plans: Dict[str, np.ndarray] = {}
        maps = agent.action_map
        if len(maps) == 1 and n_buildings > 1:
            maps = maps * n_buildings           # central: shared hour map
        ch_slot, wm_slot, n_ch, n_wm = {}, {}, 0, 0
        if spec is not None:
            for b in spec.buildings:
                for ch in b.chargers:
                    ch_slot[f"electric_vehicle_storage_{ch.charger_id}"] = n_ch
                    n_ch += 1
                for wm in b.washing_machines:
                    wm_slot[wm.name] = n_wm
                    n_wm += 1

        def col_of(table):
            return np.asarray([table[h] for h in range(1, 25)], np.float32)

        for b, m in enumerate(maps):
            for name, table in m.items():
                if table is None:
                    continue
                if name in ACTION_KEYS:
                    plan = plans.setdefault(name, np.zeros((24, n_buildings), np.float32))
                    plan[:, b] = col_of(table)
                elif name in ch_slot:
                    plan = plans.setdefault("electric_vehicle_storage",
                                            np.zeros((24, n_ch), np.float32))
                    plan[:, ch_slot[name]] = col_of(table)
                elif name in wm_slot:
                    plan = plans.setdefault("washing_machine", np.zeros((24, n_wm), np.float32))
                    plan[:, wm_slot[name]] = col_of(table)
        return cls(plans)

    def expanded(self, cfg: StaticConfig, params: DistrictParams,
                 n_steps: int, data_offset: int = 0) -> Dict[str, np.ndarray]:
        """Normalize every plan to (S, n) over its target axis —
        buildings for building-level actions, chargers for
        ``electric_vehicle_storage``, machines for ``washing_machine``.
        Hour tables resolve against the episode window's hours
        (``data_offset``); explicit plans are episode-relative."""
        hours = params.series.hour[data_offset:data_offset + n_steps, 0].cpu().numpy()
        widths = _target_widths(cfg)
        out = {}
        for k, v in self.plans.items():
            n = widths.get(k, cfg.n_buildings)
            if self._is_hour_table(v, n, n_steps):
                out[k] = (v[hours - 1] if v.ndim == 2
                          else np.broadcast_to(v[hours - 1][:, None],
                                               (n_steps, n)).copy())
            else:
                if v.shape[0] < n_steps:
                    raise ValueError(f"per-step plan for {k} too short: {v.shape}")
                plan = v[:n_steps]
                if plan.ndim == 1:
                    plan = np.broadcast_to(plan[:, None], (n_steps, n)).copy()
                out[k] = plan
        return out

    def as_policy_fn(self, cfg: StaticConfig, params: DistrictParams,
                     n_steps: int) -> Callable:
        """Policy for the stepped path. Hour tables are expanded over the
        FULL simulation range and indexed by the sim-range step (so
        shifted episode windows keep the right hours); explicit (S,)/(S, B)
        plans are episode-relative and index by the episode step."""
        hours_full = params.series.hour[:, 0].cpu().numpy()
        B = cfg.n_buildings
        dev = params.device
        widths = _target_widths(cfg)
        by_tau, by_t = {}, {}
        for k, v in self.plans.items():
            n = widths.get(k, B)
            if self._is_hour_table(v, n, n_steps):
                table = (v[hours_full - 1] if v.ndim == 2 else
                         np.broadcast_to(v[hours_full - 1][:, None],
                                         (hours_full.shape[0], n)))
                by_tau[k] = torch.tensor(np.ascontiguousarray(table), device=dev)
            else:
                plan = np.asarray(v, np.float32)[:n_steps]
                if plan.ndim == 1:
                    plan = np.broadcast_to(plan[:, None], (n_steps, n))
                by_t[k] = torch.tensor(np.ascontiguousarray(plan), device=dev)
        keys = list(ACTION_KEYS)
        if cfg.has_evs:
            keys.append("electric_vehicle_storage")
        if cfg.has_washing_machines:
            keys.append("washing_machine")

        def policy(params, states):
            tau = (states.data_offset + states.t).long()
            t = states.t.long()
            zero = lambda k: torch.zeros((t.shape[0], widths.get(k, B)), dtype=torch.float32,
                                         device=t.device)
            return {k: (by_tau[k][tau] if k in by_tau else
                        by_t[k][t] if k in by_t else zero(k))
                    for k in keys}
        return policy


def _target_widths(cfg: StaticConfig) -> Dict[str, int]:
    """Plan width of the action classes that are not per building."""
    return {"electric_vehicle_storage": max(cfg.n_chargers, 1),
            "washing_machine": max(cfg.n_washing_machines, 1)}


def kernel_family(cfg: StaticConfig) -> Optional[str]:
    """Which whole-episode kernel serves this configuration, if any."""
    if rollout_fast.eligible(cfg):
        return "battery"
    if rollout_fast.eligible_thermal(cfg):
        return "thermal"
    if rollout_fast.eligible_lstm(cfg):
        return "lstm"
    if rollout_fast.eligible_ev(cfg):
        return "ev"
    if rollout_fast.eligible_neighborhood(cfg):
        return "neighborhood"
    return None


def _with_t0_double(bal: torch.Tensor) -> torch.Tensor:
    """Battery electricity-consumption series: the t == 0 row double-counts
    the balance (``building.py:2643-2652``; core/step.py bat_total)."""
    return torch.cat([bal[:1] * 2.0, bal[1:]], dim=0)


def _assemble(cfg: StaticConfig, params: DistrictParams, family: str, rec: torch.Tensor,
              off: int, baseline_condition: str, postpass=None) -> Dict[str, torch.Tensor]:
    """KPI dict for one district from the kernel's recorded (rows, S, B)
    stream and the data series of the episode window ``[off, off + S)``;
    on the neighborhood family ``postpass`` holds the temperature, the two
    set-point series and the final occupant state of
    :func:`core.neighborhood_eval.temp_setpoint_series`."""
    S = rec.shape[1]
    ser = params.series
    start = torch.tensor([off], device=rec.device)
    w = lambda arr: window(arr, start, S)                    # (S, 1, B)
    final_state = None
    if family == "neighborhood":
        net = rec[nb_ops.R_NET]
        # every tank is inert on this family (neighborhood_packable): the
        # storage consumption is the battery's alone (building.py:345-366)
        storage = _with_t0_double(rec[nb_ops.R_BBAL])
        served = (rec[nb_ops.R_COUT] + rec[nb_ops.R_HOUT] + rec[nb_ops.R_DOUT])[:, None] \
            + w(ser.non_shiftable_load)
        temp, csp, hsp, final_state = postpass
        indoor_t, cooling_sp, heating_sp = temp[:, None], csp[:, None], hsp[:, None]
        cool_act, heat_act = rec[nb_ops.R_CDEM][:, None], rec[nb_ops.R_HDEM][:, None]
    elif family == "battery":
        net, storage = rec[0], _with_t0_double(rec[1])
        served = w(ser.non_shiftable_load)
    elif family == "ev":
        net = rec[ev_ops.R_NET]
        # without_storage subtracts charger consumption too
        # (building.py:360-366); washing machines are NOT storage
        storage = _with_t0_double(rec[ev_ops.R_BBAL]) + rec[ev_ops.R_CHC]
        served = w(ser.non_shiftable_load)
    else:
        # the thermal and the LSTM kernels name these rows alike
        net = rec[R_NET]
        # storage consumption: device input power of each tank balance
        # (building.py:414-464) plus the battery's
        outdoor = w(ser.outdoor_dry_bulb_temperature)[:, 0]
        storage = (hvac.input_power(params.cooling_device, rec[R_CBAL], outdoor, False)
                   + hvac.input_power(params.dhw_device, rec[R_DBAL], outdoor, True)
                   + _with_t0_double(rec[R_BBAL]))
        # an outage may leave part of the non-shiftable load unmet
        nsl_met = (rec[lstm_ops.R_NSLMET][:, None] if family == "lstm"
                   else w(ser.non_shiftable_load))
        served = (rec[R_COUT] + torch.clamp(-rec[R_CBAL], min=0.0)
                  + rec[R_DOUT] + torch.clamp(-rec[R_DBAL], min=0.0))[:, None] + nsl_met
    if family != "neighborhood":
        # the LSTM kernel records the predicted temperature and the
        # partial-load demand; elsewhere both are data
        indoor_t = (rec[lstm_ops.R_TEMP][:, None] if family == "lstm"
                    else w(ser.indoor_dry_bulb_temperature))
        cooling_sp = w(ser.indoor_dry_bulb_temperature_cooling_set_point)
        heating_sp = w(ser.indoor_dry_bulb_temperature_heating_set_point)
        cool_act = (rec[lstm_ops.R_CDEM][:, None] if family == "lstm"
                    else w(ser.cooling_demand))
        heat_act = w(ser.heating_demand)
    net = net[:, None]
    pricing = w(ser.electricity_pricing)
    carbon = w(ser.carbon_intensity)
    collected = dict(
        net=net,
        cost=net * pricing,
        emission=torch.clamp(net * carbon, min=0.0),
        storage=storage[:, None],
        solar=-w(ser.solar_generation),
        pricing=pricing,
        carbon=carbon,
        indoor_t=indoor_t,
        cooling_sp=cooling_sp,
        heating_sp=heating_sp,
        cooling_demand_actual=cool_act,
        heating_demand_actual=heat_act,
        served=served,
    )
    table = kpi_table(cfg, params, collected, start, baseline_condition, final_state)
    return {k: v[0] for k, v in table.items()}


def evaluate_scripted(cfg: StaticConfig, params: DistrictParams,
                      policy: ScriptedPolicy, n_steps: int = None,
                      baseline_condition: str = "_without_storage",
                      n_districts: int = None, return_series: bool = False,
                      data_offset: int = 0, device=None):
    """Full normalized KPI table for ONE district under an open-loop
    policy, computed on the whole-episode kernel of the configuration's
    family on ``device`` (the CUDA card by default).

    Requires a kernel-eligible configuration (``kernel_family(cfg)``).
    Returns the same ``building|<kpi>`` -> (B,) / ``district|<kpi>`` ->
    scalar dict as :func:`citylearn_tpu_torch.core.evaluate.kpi_table`;
    with ``return_series=True`` also the raw recorded (rows, S, B) stream
    (see the kernel modules' row constants).
    ``n_districts`` identical districts run in the launch (1 by
    default); the table is district 0's.

    ``data_offset`` evaluates a shifted episode window [off, off + S) —
    the reference's rolling/random splits (``base.py:76-129``): input
    series, hour tables and the KPI window all follow the offset.
    Stochastic-outage signals are baked for the default window only, so a
    shifted window on such a dataset raises. The float64 parity mode
    raises too (:func:`rollout_fast.refuse_parity`)."""
    rollout_fast.refuse_parity(cfg)
    family = kernel_family(cfg)
    if family is None:
        raise ValueError("configuration is not kernel-eligible; use "
                         "evaluate_districts (stepped path) instead")
    off = int(data_offset)
    if off and cfg.has_stochastic_outage:
        raise ValueError(
            "shifted windows on a stochastic-outage dataset need the signal rebaked for "
            "that window: pass params = rebake_outage(spec, cfg, params, data_offset) "
            "(core/params.py) through evaluate_districts, or use its stepped path")
    if family == "lstm" and not rollout_fast.lstm_packable(cfg, params):
        raise ValueError("LSTM configuration not kernel-packable; use "
                         "evaluate_districts (stepped path) instead")
    if family == "neighborhood" and not rollout_fast.neighborhood_packable(cfg, params):
        raise ValueError("configuration not neighborhood-packable; use "
                         "evaluate_districts (stepped path) instead")
    dev = resolve_device(device)
    params = params.to(dev)
    S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
    plans = policy.expanded(cfg, params, S, data_offset=off)
    if family == "battery":
        out = rollout_fast.run_battery_episode(
            cfg, params, n_districts or 1,
            plans.get("electrical_storage", np.zeros((S, cfg.n_buildings), np.float32)),
            n_steps=S, record_series=True, data_offset=off, device=dev)
    elif family == "lstm":
        out = rollout_fast.run_lstm_episode(
            cfg, params, n_districts or 1, plans, n_steps=S, record_series=True,
            data_offset=off, device=dev)
    elif family == "ev":
        out = rollout_fast.run_ev_episode(
            cfg, params, n_districts or 1, plans, n_steps=S, record_series=True,
            data_offset=off, device=dev)
    elif family == "neighborhood":
        out = rollout_fast.run_neighborhood_episode(
            cfg, params, n_districts or 1, plans, n_steps=S, record_series=True,
            data_offset=off, device=dev)
    else:
        out = rollout_fast.run_thermal_episode(
            cfg, params, n_districts or 1, plans, n_steps=S, record_series=True,
            data_offset=off, device=dev)
    rec = out[-1]
    postpass = None
    if family == "neighborhood":
        # the single-district temperature and occupant post-pass: the tanks
        # are inert, so the demand observations are the device outputs
        postpass = temp_setpoint_series(cfg, params, rec[nb_ops.R_COUT], rec[nb_ops.R_HOUT],
                                        S, data_offset=off)
    table = _assemble(cfg, params, family, rec, off, baseline_condition, postpass)
    if return_series:
        return table, rec
    return table
