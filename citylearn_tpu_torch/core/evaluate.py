"""Batched KPI evaluation for district rollouts.

The reference computes KPIs host-side from per-building numpy series
(``citylearn.py:1136-1323``). Here the same normalized KPI table is
computed for a whole batch of districts on the device: a stepped
rollout stacks the per-step quantities, and the :mod:`kpi` reductions
produce control/baseline-normalized values.

Covered KPIs — the full building table (``cost_function.py:10-388``):
district ramping_average, daily/monthly one-minus-load-factor, daily and
all-time peak; per-building electricity_consumption_total,
zero_net_energy, carbon_emissions_total, cost_total, the discomfort
9-tuple, one-minus-thermal-resilience and power-outage/annual normalized
unserved energy. Baselines = ``without_storage[_and_partial_load][_and_pv]``
counterfactuals (``building.py:308-476,2863-2933``); the
``_and_partial_load`` baselines add back the consumption that a
dynamics building's partial-load control saved or spent against its
ideal demand (zero without dynamics buildings).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.core import hvac, kpi
from citylearn_tpu_torch.core.params import initial_state
from citylearn_tpu_torch.core.rollout_fast import lstm_packable, neighborhood_packable
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import DistrictParams, EnvState, StaticConfig, flatten

BASELINE_CONDITIONS = ("_without_storage", "_without_storage_and_pv",
                       "_without_storage_and_partial_load",
                       "_without_storage_and_partial_load_and_pv")


def _safe_div(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference normalization semantics (``citylearn.py:1172-1189``):
    0/0 -> 1.0; x/0 -> NaN (the host API returns None there)."""
    zero = torch.zeros_like(c)
    c = torch.where(torch.isfinite(c), c, zero)
    b = torch.where(torch.isfinite(b), b, zero)
    ratio = c / torch.where(b == 0.0, torch.ones_like(b), b)
    return torch.where(b == 0.0,
                       torch.where(c == 0.0, torch.ones_like(c),
                                   torch.full_like(c, torch.nan)),
                       ratio)


def window(arr: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """Rows ``[start, start + n)`` of a (T, B) series for each district's
    ``start`` (D,) -> (n, D, B). Like ``jax.lax.dynamic_slice_in_dim``,
    the start is clamped so that the window fits."""
    start = torch.clamp(start.long(), 0, arr.shape[0] - n)
    return arr[start[None, :] + torch.arange(n, device=arr.device)[:, None]]


def collect_episode(cfg: StaticConfig, params: DistrictParams,
                    states: EnvState, policy_fn: Callable, n_steps: int
                    ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Step ``n_steps`` with a policy, stacking everything the KPI table
    needs: time-major (S, D, B) per-building series."""
    ys = {}
    for _ in range(n_steps):
        tau = (states.data_offset + states.t).long()
        states, out = district_step(cfg, params, states, policy_fn(params, states))
        step = dict(
            net=out.net_electricity_consumption,
            cost=out.net_electricity_consumption_cost,
            emission=out.net_electricity_consumption_emission,
            storage=(out.cooling_storage_consumption + out.heating_storage_consumption
                     + out.dhw_storage_consumption + out.battery_consumption
                     + out.chargers_consumption),
            solar=out.solar_generation,             # negative kWh
            pricing=params.series.electricity_pricing[tau],
            carbon=params.series.carbon_intensity[tau],
            indoor_t=out.indoor_temperature,
            cooling_sp=out.cooling_set_point,
            heating_sp=out.heating_set_point,
            cooling_demand_actual=out.cooling_demand_actual,
            heating_demand_actual=out.heating_demand_actual,
            # served = met demand + storage discharge per end use + met
            # non-shiftable load
            served=(out.cooling_demand_met + torch.clamp(-out.cooling_storage_balance, min=0.0)
                    + out.heating_demand_met
                    + torch.clamp(-out.heating_storage_balance, min=0.0)
                    + out.dhw_demand_met + torch.clamp(-out.dhw_storage_balance, min=0.0)
                    + out.non_shiftable_load_met),
        )
        for k, v in step.items():
            ys.setdefault(k, []).append(v)
    return states, {k: torch.stack(v) for k, v in ys.items()}


def kpi_table(cfg: StaticConfig, params: DistrictParams,
              collected: Dict[str, torch.Tensor], start_tau: torch.Tensor,
              baseline_condition: str = "_without_storage",
              final_state: Optional[EnvState] = None) -> Dict[str, torch.Tensor]:
    """Normalized KPI dict for a district batch from collected (S, D, B)
    series; ``start_tau`` (D,) is the sim-range row of each district's
    first collected step. Returns ``building|<kpi>`` -> (D, B) and
    ``district|<kpi>`` -> (D,). ``final_state`` (any object with the
    ``occ_*`` overrides, (D, B)) is the state after the last step: on an
    occupant district its live set-point overrides patch the final,
    unwritten row.

    Reproduces the host ``evaluate()`` including its series-length quirk:
    the control district series has S rows (one per step taken) while
    counterfactual baselines have S + 1 rows — the final, unwritten index
    contributes zeros except data-driven solar (``citylearn.py:645-700,
    1888-1918``)."""
    if baseline_condition not in BASELINE_CONDITIONS:
        raise ValueError(f"unknown baseline condition {baseline_condition!r}")
    S = collected["net"].shape[0]
    and_pv = baseline_condition.endswith("_and_pv")
    ser = params.series
    T = ser.non_shiftable_load.shape[0]
    win = lambda arr: window(arr, start_tau, S + 1)
    # the row after the last collected step; JAX clamps an index past the end
    tau_end = torch.clamp(start_tau.long() + S, max=T - 1)

    net_c = collected["net"]                               # (S, D, B)
    base = net_c - collected["storage"]
    if and_pv:
        base = base - collected["solar"]
    extra = (ser.solar_generation[tau_end]                 # positive kWh
             if and_pv else torch.zeros_like(net_c[0]))[None]
    net_b = torch.cat([base, extra], dim=0)                # (S + 1, D, B)

    # controlled demand over the full window; the final unwritten row reads
    # as ideal demand fully met (building.py:2554-2558 prefill)
    cool_ideal_w = win(ser.cooling_demand)
    heat_ideal_w = win(ser.heating_demand)
    cool_act = torch.cat([collected["cooling_demand_actual"], cool_ideal_w[-1:]])
    heat_act = torch.cat([collected["heating_demand_actual"], heat_ideal_w[-1:]])
    if "_and_partial_load" in baseline_condition:
        # DynamicsBuilding counterfactual (building.py:2863-2933): add back
        # the ideal-vs-partial consumption delta. Heating quirk: the
        # reference evaluates the heat-pump input power at the *scalar*
        # outdoor temperature of the final row for the whole series
        # (building.py:2893-2897).
        outdoor_w = win(ser.outdoor_dry_bulb_temperature)
        heat_diff = heat_ideal_w - heat_act
        net_b = net_b + hvac.input_power(params.cooling_device, cool_ideal_w - cool_act,
                                         outdoor_w, False)
        net_b = net_b + torch.where(
            params.heating_device.is_heat_pump,
            hvac.input_power(params.heating_device, heat_diff, outdoor_w[-1:], True),
            heat_diff / params.dhw_device.efficiency)
    price_b = torch.cat([collected["pricing"], ser.electricity_pricing[tau_end][None]])
    carbon_b = torch.cat([collected["carbon"], ser.carbon_intensity[tau_end][None]])
    cost_b = net_b * price_b
    em_b = torch.clamp(net_b * carbon_b, min=0.0)

    # pricing/carbon-sum gates (citylearn.py:1246-1260)
    price_sum = torch.sum(price_b, dim=0)
    carbon_sum = torch.sum(carbon_b, dim=0)
    gate = lambda on, v: torch.where(on, v, torch.zeros_like(v))

    building = {
        "electricity_consumption_total": _safe_div(
            kpi.electricity_consumption(net_c), kpi.electricity_consumption(net_b)),
        "zero_net_energy": _safe_div(
            kpi.zero_net_energy(net_c), kpi.zero_net_energy(net_b)),
        "carbon_emissions_total": _safe_div(
            kpi.carbon_emissions(collected["emission"]),
            gate(carbon_sum != 0, kpi.carbon_emissions(em_b))),
        "cost_total": _safe_div(
            kpi.cost(collected["cost"]), gate(price_sum != 0, kpi.cost(cost_b))),
    }

    # ---- thermal comfort + resilience (cost_function.py:224-388); these
    # are raw (un-normalized) values like the host table
    indoor = torch.cat([collected["indoor_t"],
                        win(ser.indoor_dry_bulb_temperature)[-1:]])
    csp_end = win(ser.indoor_dry_bulb_temperature_cooling_set_point)[-1:]
    hsp_end = win(ser.indoor_dry_bulb_temperature_heating_set_point)[-1:]
    if cfg.has_occupant and final_state is not None:
        # the host patches the final unwritten row's set points with the
        # live occupant override where one is active (the reference's
        # occupant mutation, building.py:3248-3353, writes from t on)
        live = lambda ov, end: torch.where(torch.isfinite(ov), ov, end)
        csp_end = live(final_state.occ_csp_override, csp_end)
        hsp_end = live(final_state.occ_hsp_override, hsp_end)
    csp = torch.cat([collected["cooling_sp"], csp_end])
    hsp = torch.cat([collected["heating_sp"], hsp_end])
    band_w = win(ser.comfort_band)
    occ_w = win(ser.occupant_count)
    outage_w = win(ser.power_outage)
    dis = kpi.discomfort(indoor, csp, hsp, band_w, occ_w)
    dhw_w = win(ser.dhw_demand)
    nsl_w = win(ser.non_shiftable_load)
    expected = cool_act + heat_act + dhw_w + nsl_w
    served_end = cool_ideal_w[-1:] + heat_ideal_w[-1:] + dhw_w[-1:] + nsl_w[-1:]
    served = torch.cat([collected["served"], served_end])
    building.update({
        "discomfort_proportion": dis[0],
        "discomfort_cold_proportion": dis[1],
        "discomfort_hot_proportion": dis[2],
        "discomfort_cold_delta_minimum": dis[3],
        "discomfort_cold_delta_maximum": dis[4],
        "discomfort_cold_delta_average": dis[5],
        "discomfort_hot_delta_minimum": dis[6],
        "discomfort_hot_delta_maximum": dis[7],
        "discomfort_hot_delta_average": dis[8],
        "one_minus_thermal_resilience_proportion":
            kpi.one_minus_thermal_resilience(outage_w, indoor, csp, hsp, band_w, occ_w),
        "power_outage_normalized_unserved_energy_total":
            kpi.normalized_unserved_energy(expected, served, outage_w),
        "annual_normalized_unserved_energy_total":
            kpi.normalized_unserved_energy(expected, served),
    })

    # district: control series drops the final index (length quirk above)
    dc = torch.sum(net_c, dim=-1)                          # (S, D)
    db = torch.sum(net_b, dim=-1)                          # (S + 1, D)
    district = {
        "ramping_average": _safe_div(kpi.ramping(dc), kpi.ramping(db)),
        "daily_one_minus_load_factor_average": _safe_div(
            kpi.one_minus_load_factor(dc, 24), kpi.one_minus_load_factor(db, 24)),
        "monthly_one_minus_load_factor_average": _safe_div(
            kpi.one_minus_load_factor(dc, 730), kpi.one_minus_load_factor(db, 730)),
        "daily_peak_average": _safe_div(kpi.peak(dc, 24), kpi.peak(db, 24)),
        "all_time_peak_average": _safe_div(
            kpi.peak(dc, cfg.time_steps), kpi.peak(db, cfg.time_steps)),
    }
    # the host's district row averages district KPIs with building-KPI means
    out = {f"building|{k}": v for k, v in building.items()}
    out.update({f"district|{k}": v for k, v in district.items()})
    # pandas groupby-mean skips None/NaN building values (skipna)
    out.update({f"district|{k}": torch.nanmean(v, dim=-1) for k, v in building.items()})
    return out


def evaluate_districts_fn(cfg: StaticConfig, policy_fn: Callable,
                          n_steps: int = None,
                          baseline_condition: str = "_without_storage"
                          ) -> Callable:
    """The batched evaluator ``f(params, states) -> {kpi: tensor}`` on the
    stepped path, for callers that evaluate many batches."""
    S = (cfg.time_steps - 1) if n_steps is None else n_steps

    def run(params, states):
        start = states.data_offset + states.t
        final, collected = collect_episode(cfg, params, states, policy_fn, S)
        return kpi_table(cfg, params, collected, start, baseline_condition,
                         final_state=final)

    return run


def _is_fresh(cfg: StaticConfig, params: DistrictParams, states: EnvState) -> bool:
    """Every district state equals the packed initial state at the first
    district's episode-window offset. NaN equals NaN here: an occupant's
    set-point overrides start NaN-coded ("none")."""
    init = flatten(initial_state(cfg, params, int(states.data_offset[0])))
    same = lambda a, b: torch.equal(a, b) or (
        a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
        and torch.equal(a.nan_to_num(), b.nan_to_num()))
    return all(same(v, init[k].expand_as(v)) for k, v in flatten(states).items())


def evaluate_districts(cfg: StaticConfig, params: DistrictParams,
                       states: EnvState, policy_fn: Callable,
                       n_steps: int = None,
                       baseline_condition: str = "_without_storage",
                       device=None) -> Dict[str, torch.Tensor]:
    """KPI tables for a (D, ...) batch of districts on ``device`` (the
    CUDA card by default). Returns ``building|<kpi>`` -> (D, B) and
    ``district|<kpi>`` -> (D,) tensors.

    When ``policy_fn`` is a :class:`citylearn_tpu_torch.core.evaluate_fast.ScriptedPolicy`
    (an open-loop plan) on a kernel-eligible configuration and every
    district state is the fresh initial state, the episode runs as ONE
    whole-episode kernel launch with per-step series recording instead
    of the stepped loop — the same table; identical fresh districts have
    identical tables, so one is computed and broadcast."""
    from citylearn_tpu_torch.core.evaluate_fast import (
        ScriptedPolicy,
        evaluate_scripted,
        kernel_family,
    )

    dev = resolve_device(device)
    params, states = params.to(dev), states.to(dev)
    D = states.t.shape[0]
    if isinstance(policy_fn, ScriptedPolicy):
        family = kernel_family(cfg)
        off0 = int(states.data_offset[0])
        if family == "lstm" and not lstm_packable(cfg, params):
            family = None           # the stepped path serves an unpackable district
        if family == "neighborhood" and not neighborhood_packable(cfg, params):
            family = None
        if off0 and cfg.has_stochastic_outage:
            family = None           # needs a signal the caller rebaked; stepped path
        if family is not None and _is_fresh(cfg, params, states):
            table = evaluate_scripted(cfg, params, policy_fn, n_steps,
                                      baseline_condition, data_offset=off0,
                                      device=dev)
            return {k: v.expand((D,) + v.shape) for k, v in table.items()}
        S = (cfg.time_steps - 1) if n_steps is None else int(n_steps)
        policy_fn = policy_fn.as_policy_fn(cfg, params, S)
    return evaluate_districts_fn(cfg, policy_fn, n_steps, baseline_condition)(params, states)
