"""The district step: one function of tensors replacing the reference's
``CityLearnEnv.step`` cascade (``citylearn/citylearn.py:978-1056``
-> ``building.py:1500-1834`` -> ``energy_model.py``) for districts whose
buildings hold cooling, heating and DHW end uses (heat pump or electric
heater plus a storage tank each), a battery, PV and a non-shiftable
load — the 2022 (battery+PV) and 2021 (thermal-storage) families — plus
the EV chargers, electric vehicles, washing machines and charging
constraints of the ``plus_evs`` family, and the LSTM temperature
dynamics, partial-load HVAC control and power outages of the 2023
family, and the occupant thermostat interaction of the neighborhood
family. The float64 parity mode (``cfg.parity_f64``) runs the same step in
float64 and rounds to float32 where the reference stores into its float32
arrays (:func:`_store_rounder`).

Everything is elementwise over a ``(D, B)`` batch of districts and
buildings; charger, EV and machine quantities are ``(D, C)``, ``(D, V)``
and ``(D, W)``, and reach their buildings through fixed-order segment
sums.

Order semantics (reference ``building.py:1566-1632``): the priority list is
reordered per building from the *signs* of the storage actions —
discharging electrical storage runs first, and a discharging end-use tank
runs before its device. Because each decision is local, both orderings of
every block are computed elementwise and selected with ``torch.where``;
the cross-block coupling (``downward_electrical_flexibility``,
``building.py:640-668``) is threaded through a consumption accumulator.
Without a power outage that flexibility is +inf: the blocks decouple and
the late battery variant equals the early one, so it is computed only
for a configuration with an outage (computing it always doubles the
cost of a battery+PV step).

t == 0 quirks reproduced (``building.py:2526-2564, 2615-2652``): at reset
the device-energy arrays are prefilled with the raw demand series and
``update_variables`` runs once; during the first step the t == 0 branch of
``update_variables`` adds demand-derived consumption again — so device
consumptions at index 0 are triple-counted (battery: double).
Observations, rewards and KPI series see these values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.core import debug, hvac
from citylearn_tpu_torch.core.battery import battery_charge
from citylearn_tpu_torch.core.curves import interp_linear
from citylearn_tpu_torch.core.dynamics import lstm_predict
from citylearn_tpu_torch.core.reward import (
    EVRewardInputs,
    RewardInputs,
    compute_reward,
    segment_sum,
)
from citylearn_tpu_torch.core.step_graph import engaged_graph
from citylearn_tpu_torch.core.storage import tank_charge
from citylearn_tpu_torch.core.types import (
    BatteryParams,
    DistrictParams,
    EnvState,
    HVACParams,
    StaticConfig,
    StepOutput,
    StorageTankParams,
    map_tensors,
)


def _store_rounder(cfg: StaticConfig):
    """Float32 store-point rounding for parity mode.

    The reference computes each step in Python floats (float64) but stores
    every carried quantity into float32 numpy arrays (SOC/energy_balance
    ``energy_model.py:801-803``, per-device electricity_consumption
    ``energy_model.py:155``, net/cost/emission ``building.py:2559-2561``,
    demand/temperature series writes). In ``parity_f64`` mode the math runs
    in float64 and rounds at exactly those store points, so that a
    year-long trajectory tracks the reference to ~1 float32 ulp. Identity
    in the normal (all-float32) mode."""
    if cfg.parity_f64:
        return lambda x: x.float().double()
    return lambda x: x


def _stored(res, r32):
    """A battery or tank event with its SOC and energy balance stored."""
    return res._replace(soc=r32(res.soc), energy_balance=r32(res.energy_balance))


class _ThermalResult(NamedTuple):
    soc: torch.Tensor
    balance: torch.Tensor
    device_output: torch.Tensor          # energy_from_<end_use>_device this step
    apply_consumption: torch.Tensor      # apply-phase device consumption (device + storage charge)


def _flex(outage: torch.Tensor, solar_abs: torch.Tensor,
          cons_accum: torch.Tensor) -> torch.Tensor:
    """``downward_electrical_flexibility`` (reference ``building.py:640-668``)."""
    cap = torch.clamp(solar_abs - cons_accum, min=0.0)
    return torch.where(outage, cap, torch.full_like(cap, torch.inf))


def _thermal_block(dev: HVACParams, tank_p: StorageTankParams, soc_prev: torch.Tensor,
                   demand: torch.Tensor, action: torch.Tensor, outdoor_t: torch.Tensor,
                   heating: bool, conv_capacity: torch.Tensor, hours_ratio_applies: bool,
                   outage: torch.Tensor, solar_abs: torch.Tensor, cons_accum: torch.Tensor,
                   dev_cons_init: torch.Tensor, cfg: StaticConfig
                   ) -> Tuple[_ThermalResult, torch.Tensor]:
    """One end-use (cooling/heating/dhw): device + its storage tank.

    ``conv_capacity`` is the capacity used for the action->energy
    conversion — the reference uses the *cooling* tank's capacity for
    heating storage and the *heating* tank's for dhw storage
    (``building.py:1720,1765``), a shipped quirk reproduced here.
    ``dev_cons_init`` is the device's own consumption already booked at
    this index (nonzero only at t == 0 from the reset-time
    ``update_variables``). Returns the block result and the updated
    district-level consumption accumulator.
    """
    hours_ratio = cfg.seconds_per_time_step / 3600.0
    # action * capacity stays float64 in the parity mode as in the
    # reference: actions reach update_<end_use>_storage as np.float64
    # scalars (citylearn.py:1063-1134), and np.float64 * np.float32 is float64
    energy_req = action * conv_capacity * (hours_ratio if hours_ratio_applies else 1.0)
    ratio = cfg.time_step_ratio
    parity = cfg.parity_f64
    r32 = _store_rounder(cfg)
    tank = lambda energy: _stored(tank_charge(tank_p, soc_prev, energy / ratio, ratio, parity),
                                  r32)
    store_cons = lambda bal: r32(hvac.input_power(dev, torch.clamp(bal, min=0.0), outdoor_t,
                                                  heating, parity))

    # The reference's ``min(demand, max_output)`` is a Python builtin min
    # over mixed-dtype numpy scalars: the float32 demand-series object vs
    # the float64 ``get_max_output_power`` product. Whichever OBJECT wins
    # sets the downstream division dtype — a saturated device stores an
    # UNROUNDED float64 consumption, an unsaturated one a float32-rounded
    # value (building.py:1641-1661 with energy_model.py:281,301). Parity
    # mode selects the rounding per value.
    def dev_cons(out, max_out, demand_side):
        raw = torch.clamp(hvac.input_power(dev, out, outdoor_t, heating, parity,
                                           round_result=False), min=0.0)
        return torch.where(demand_side <= max_out, r32(raw), raw) if parity else raw

    # ---- variant A: device first, then storage charge (action >= 0) ----
    # update_energy_from_<end_use>_device (building.py:1641-1661): storage
    # balance at t is still 0, so storage_output = 0.
    flex1 = _flex(outage, solar_abs, cons_accum)
    max_out1 = hvac.max_output_power(dev, outdoor_t, heating, flex1, dev_cons_init, parity)
    out_A = torch.minimum(demand, max_out1)
    cons_dev_A = dev_cons(out_A, max_out1, demand)
    # update_<end_use>_storage charging branch (building.py:1663-1687):
    # clamp by the device's max output given consumption booked so far.
    flex2 = _flex(outage, solar_abs, cons_accum + cons_dev_A)
    max_out2 = hvac.max_output_power(dev, outdoor_t, heating, flex2,
                                     dev_cons_init + cons_dev_A, parity)
    charge_A = torch.minimum(max_out2, energy_req)
    tank_A = tank(charge_A)
    cons_store_A = store_cons(tank_A.energy_balance)

    # ---- variant B: storage discharge first, then device (action < 0) ----
    discharge_B = torch.maximum(-demand, energy_req)
    tank_B = tank(discharge_B)
    cons_store_B = store_cons(tank_B.energy_balance)     # 0 for a true discharge
    storage_out_B = -torch.clamp(tank_B.energy_balance, max=0.0)
    flex_B = _flex(outage, solar_abs, cons_accum + cons_store_B)
    max_out_B = hvac.max_output_power(dev, outdoor_t, heating, flex_B,
                                      dev_cons_init + cons_store_B, parity)
    # demand (a float32 store) - storage_output (a float32 store) rounds to
    # float32 in the reference
    residual_B = r32(demand - storage_out_B)
    out_B = torch.minimum(residual_B, max_out_B)
    cons_dev_B = dev_cons(out_B, max_out_B, residual_B)

    discharging = action < 0.0
    pick = lambda a, b: torch.where(discharging, b, a)
    # no store rounding on the sum: the reference's per-device
    # electricity_consumption arrays are float64 and a saturated device's
    # term keeps its unrounded float64 value (see dev_cons above)
    apply_cons = pick(cons_dev_A + cons_store_A, cons_dev_B + cons_store_B)
    return (_ThermalResult(soc=pick(tank_A.soc, tank_B.soc),
                           balance=pick(tank_A.energy_balance, tank_B.energy_balance),
                           device_output=pick(out_A, out_B),
                           apply_consumption=apply_cons),
            cons_accum + apply_cons)


@tracing.traced("step.partial_load")
def _partial_load_demand(cfg: StaticConfig, params: DistrictParams, t: torch.Tensor,
                         actions: Dict[str, torch.Tensor], cooling_demand: torch.Tensor,
                         heating_demand: torch.Tensor, hvac_mode: torch.Tensor,
                         outdoor_t: torch.Tensor, dev_init_cool: torch.Tensor,
                         dev_init_heat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-load demand override for LSTM dynamics buildings (reference
    ``building.py:3080-3158``): the device action sets the available
    electric power, and demand becomes the device's maximum output under
    that power, gated by ``hvac_mode``; the ideal load is kept while the
    LSTM's input buffer fills (control starts at ``t >= lookback + 1``).
    Returns the controlled (cooling, heating) demands, (D, B) each."""
    zero = torch.zeros_like(cooling_demand)
    hours_ratio = cfg.seconds_per_time_step / 3600.0
    r32 = _store_rounder(cfg)
    coh_all = actions.get("cooling_or_heating_device", zero)
    cool_all = actions.get("cooling_device", zero)
    heat_all = actions.get("heating_device", zero)
    for (lookback, *_), dyn in zip(cfg.dyn_groups, params.dynamics):
        m = dyn.member_indices.long()
        control_warm = (t >= lookback + 1)[:, None]
        coh = coh_all[:, m]
        cool_act = torch.where(dyn.cooling_or_heating_active,
                               torch.abs(torch.clamp(coh, max=0.0)), cool_all[:, m])
        heat_act = torch.where(dyn.cooling_or_heating_active,
                               torch.abs(torch.clamp(coh, min=0.0)), heat_all[:, m])
        cool_active = dyn.cooling_device_active | dyn.cooling_or_heating_active
        heat_active = dyn.heating_device_active | dyn.cooling_or_heating_active
        cool_dev = map_tensors(lambda a: a[m], params.cooling_device)
        heat_dev = map_tensors(lambda a: a[m], params.heating_device)
        mode, out_t = hvac_mode[:, m], outdoor_t[:, m]
        partial_c = hvac.max_output_power(cool_dev, out_t, False,
                                          cool_act * cool_dev.nominal_power * hours_ratio,
                                          dev_init_cool[:, m], cfg.parity_f64)
        partial_c = r32(torch.where((mode == 1) | (mode == 3), partial_c, zero[:, m]))
        cooling_demand = cooling_demand.index_copy(
            1, m, torch.where(control_warm & cool_active, partial_c, cooling_demand[:, m]))
        # heating uses no hours ratio (building.py:3146) — shipped quirk
        partial_h = hvac.max_output_power(heat_dev, out_t, True,
                                          heat_act * heat_dev.nominal_power,
                                          dev_init_heat[:, m], cfg.parity_f64)
        partial_h = r32(torch.where((mode == 2) | (mode == 3), partial_h, zero[:, m]))
        heating_demand = heating_demand.index_copy(
            1, m, torch.where(control_warm & heat_active, partial_h, heating_demand[:, m]))
    return cooling_demand, heating_demand


@tracing.traced("step.dynamics")
def dynamics_update(cfg: StaticConfig, params: DistrictParams, tau: torch.Tensor,
                    t: torch.Tensor, cooling_demand_obs: torch.Tensor,
                    heating_demand_obs: torch.Tensor, temp_ideal: torch.Tensor,
                    lstm_h_in: Tuple[torch.Tensor, ...], lstm_c_in: Tuple[torch.Tensor, ...],
                    dyn_input_in: Tuple[torch.Tensor, ...]):
    """LSTM temperature dynamics for one step (building.py:2935-3078):
    channel updates, the one-step-older temperature-channel quirk,
    warm-gated hidden-state carry. ``tau``/``t`` are (D,), the demand
    observations and ``temp_ideal`` (D, B), the carry as
    :class:`EnvState` holds it.

    Returns ``(temp_t, lstm_h, lstm_c, dyn_input)``."""
    temp_t = temp_ideal
    lstm_h, lstm_c, dyn_input = list(lstm_h_in), list(lstm_c_in), list(dyn_input_in)
    for g, (meta, dyn) in enumerate(zip(cfg.dyn_groups, params.dynamics)):
        lookback, L, H, F, tc, cc, hc = meta
        m = dyn.member_indices.long()
        norm = lambda v, ch: ((v - dyn.norm_min[:, ch])
                              / (dyn.norm_max[:, ch] - dyn.norm_min[:, ch]))
        vals = dyn.static_channels[tau].clone()             # (D, Bg, F) pre-normalized
        if cc >= 0:
            vals[..., cc] = norm(cooling_demand_obs[:, m], cc)
        if hc >= 0:
            vals[..., hc] = norm(heating_demand_obs[:, m], hc)
        vals[..., tc] = norm(temp_ideal[:, m], tc)
        buf = torch.cat([dyn_input[g][..., 1:], vals[..., None]], dim=-1)

        predict_warm = (t >= lookback)[:, None]             # (D, 1)
        # model input (building.py:3039-3055): all channels use the last
        # `lookback` entries except indoor temperature which uses the
        # first `lookback` (one step older)
        model_in = buf[..., 1:].clone()
        model_in[:, :, tc, :] = buf[:, :, tc, :-1]
        pred_norm, h_new, c_new = lstm_predict(dyn, model_in.transpose(2, 3),
                                               lstm_h[g], lstm_c[g])
        buf[:, :, tc, -1] = torch.where(predict_warm, pred_norm, buf[:, :, tc, -1])
        pred_temp = pred_norm * (dyn.norm_max[:, tc] - dyn.norm_min[:, tc]) \
            + dyn.norm_min[:, tc]
        temp_t = temp_t.index_copy(1, m, torch.where(predict_warm, pred_temp, temp_ideal[:, m]))
        carry_warm = predict_warm[:, :, None, None]         # over (D, L, Bg, H)
        lstm_h[g] = torch.where(carry_warm, h_new, lstm_h[g])
        lstm_c[g] = torch.where(carry_warm, c_new, lstm_c[g])
        dyn_input[g] = buf
    return temp_t, tuple(lstm_h), tuple(lstm_c), tuple(dyn_input)


OCC_FIELDS = ("occ_csp_override", "occ_hsp_override", "occ_hold_counter", "occ_prev_temp",
              "occ_prev_csp", "occ_prev_hsp")


def occupant_update(cfg: StaticConfig, params: DistrictParams, state, csp_data: torch.Tensor,
                    hsp_data: torch.Tensor, hvac_mode: torch.Tensor, temp_t: torch.Tensor,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Occupant thermostat interaction for one step (building.py:3160-3353,
    occupant.py:62-99): the logistic interaction probability on the
    just-predicted temperature and the decision trees' set-point delta,
    with the future set points mutated, a hold counter and reversion. The
    mutations are carried as NaN-coded overrides: the reference mutates
    the series from index t on, so the effective set point is the override
    where one is active, else the data. ``state`` needs the ``occ_*``
    fields and ``data_offset``, each with a leading district axis; ``t``
    is (D,), the set points, mode and temperature (D, B). Shared by
    :func:`district_step` and the post-pass of the neighborhood family.

    Returns ``(csp_eff, hsp_eff, occ_state_dict)``."""
    occ = params.occupant
    r32 = _store_rounder(cfg)
    t = t.long()
    is_t0 = (t == 0)[:, None]
    csp_eff = torch.where(torch.isfinite(state.occ_csp_override), state.occ_csp_override,
                          csp_data)
    hsp_eff = torch.where(torch.isfinite(state.occ_hsp_override), state.occ_hsp_override,
                          hsp_data)
    # at t == 0 the reference reads index -1: numpy wraps to the episode's
    # final row (building.py:3276-3285 with time_step 0)
    end_idx = (state.data_offset + cfg.time_steps - 1).long()
    series = params.series
    prev_temp = torch.where(is_t0, series.indoor_dry_bulb_temperature[end_idx],
                            state.occ_prev_temp)
    prev_csp = torch.where(
        is_t0, series.indoor_dry_bulb_temperature_cooling_set_point[end_idx], state.occ_prev_csp)
    prev_hsp = torch.where(
        is_t0, series.indoor_dry_bulb_temperature_heating_set_point[end_idx], state.occ_prev_hsp)

    heating_mode = hvac_mode == 2
    current_sp = torch.where(heating_mode, hsp_eff, csp_eff)
    prev_sp = torch.where(heating_mode, prev_hsp, prev_csp)
    sig = lambda a, b: 1.0 / (1.0 + torch.exp(-(a[t] + b[t] * temp_t)))
    p_inc = sig(occ.a_increase, occ.b_increase)
    p_dec = sig(occ.a_decrease, occ.b_decrease)
    rp = occ.random_probability[t][:, None]
    feats = torch.stack([current_sp, prev_sp, prev_temp - prev_sp], dim=-1)    # (D, B, 3)
    rows = torch.arange(cfg.n_buildings, device=temp_t.device)

    def tree_delta(k):
        node = torch.zeros(temp_t.shape, dtype=torch.long, device=temp_t.device)
        at = lambda arr: arr[:, k, :][rows, node]
        for _ in range(cfg.occupant_tree_depth + 1):
            f = at(occ.tree_feature)
            x = feats.gather(-1, torch.clamp(f, 0, 2).long()[..., None])[..., 0]
            nxt = torch.where(x <= at(occ.tree_threshold), at(occ.tree_children_left),
                              at(occ.tree_children_right))
            node = torch.where(f >= 0, nxt.long(), node)
        return at(occ.tree_delta)

    inc_fires = (p_inc >= rp) & (p_dec < rp)
    dec_fires = (p_dec >= rp) & (p_inc < rp)
    zero = torch.zeros_like(temp_t)
    delta = torch.where(inc_fires, tree_delta(0), torch.where(dec_fires, -tree_delta(1), zero))
    # the simulate_dynamics gate (building.py:2996)
    delta = torch.where(t[:, None] >= occ.lookback, delta, zero)

    trig = torch.abs(delta) > 0.0
    cool_trig, heat_trig = trig & ~heating_mode, trig & heating_mode
    counter = state.occ_hold_counter
    counter = torch.where(trig, occ.hold_time_steps,
                          torch.where(counter >= 0, counter - 1, counter))
    revert = counter == 0
    nan = torch.full_like(temp_t, float("nan"))
    # this step's effective set points take the fresh mutation; reversion
    # applies from t + 1 (building.py:3310-3317)
    new_csp_ov = r32(torch.where(revert, nan, torch.where(cool_trig, current_sp + delta,
                                                          state.occ_csp_override)))
    new_hsp_ov = r32(torch.where(revert, nan, torch.where(heat_trig, current_sp + delta,
                                                          state.occ_hsp_override)))
    csp_eff = r32(torch.where(cool_trig, current_sp + delta, csp_eff))
    hsp_eff = r32(torch.where(heat_trig, current_sp + delta, hsp_eff))
    counter = torch.where(revert, torch.full_like(counter, -1), counter)
    return csp_eff, hsp_eff, dict(
        occ_csp_override=new_csp_ov, occ_hsp_override=new_hsp_ov, occ_hold_counter=counter,
        occ_prev_temp=r32(temp_t), occ_prev_csp=csp_eff, occ_prev_hsp=hsp_eff)


class _EVResult(NamedTuple):
    chargers_consumption: torch.Tensor   # (D, B)
    ev_soc: torch.Tensor                 # (D, V)
    ev_efficiency: torch.Tensor
    ev_degraded_capacity: torch.Tensor
    violation_kwh: torch.Tensor          # (D, B)
    building_headroom: torch.Tensor      # (D, B)
    phase_headroom: torch.Tensor         # (D, P)
    charger_consumption: torch.Tensor    # (D, C)
    charger_energy: torch.Tensor         # (D, C) past_charging_action kWh
    reward_inputs: Optional[EVRewardInputs]   # when the district uses the EV reward


def _charging_constraints(cfg: StaticConfig, params: DistrictParams, a: torch.Tensor,
                          hours_ratio: float) -> Tuple[torch.Tensor, ...]:
    """Building then phase limits on the positive kW requests of a (D, C)
    charger action (reference ``building.py:901-989``): requests over a
    limit are scaled down to it and the excess is tracked in kWh. Returns
    the scaled action, the violation (D, B) and the building (D, B) and
    phase (D, P) headrooms."""
    ch = params.chargers
    B, P = cfg.n_buildings, cfg.n_charging_phases
    maxc = ch.max_charging_power
    zero = torch.zeros_like(a)
    pos = (a > 0.0) & (maxc > 0.0)
    req = torch.where(pos, a * maxc, zero)
    over_scale = lambda over, lim, tot: torch.where(
        over, torch.where(lim == 0.0, torch.zeros_like(tot),
                          lim / torch.clamp(tot, min=1e-12)), torch.ones_like(tot))
    tot_b = segment_sum(req, ch.building_index, B)
    blim = ch.cc_building_limit
    over_b = torch.isfinite(blim) & (tot_b > blim)
    viol_b = torch.where(over_b, tot_b - blim, torch.zeros_like(tot_b))
    bidx = ch.building_index.long()
    scaled1 = req * over_scale(over_b, blim, tot_b)[:, bidx]
    # chargers on no phase sum into a spare segment that has no limit
    pidx = torch.where(ch.cc_phase_index >= 0, ch.cc_phase_index,
                       torch.full_like(ch.cc_phase_index, P))
    tot_p = segment_sum(scaled1, pidx, P + 1)[:, :P]
    plim = ch.cc_phase_limit
    over_p = torch.isfinite(plim) & (tot_p > plim)
    viol_p = torch.where(over_p, tot_p - plim, torch.zeros_like(tot_p))
    viol_b = viol_b + segment_sum(viol_p, ch.cc_phase_building, B)
    scale_p = torch.cat([over_scale(over_p, plim, tot_p),
                         torch.ones_like(tot_p[:, :1])], dim=1)
    target = scaled1 * scale_p[:, pidx.long()]
    a = torch.where(pos,
                    torch.clamp(torch.minimum(a, target / torch.clamp(maxc, min=1e-12)),
                                min=0.0),
                    torch.where((a > 0.0) & (maxc <= 0.0), zero, a))
    used_b = segment_sum(target, ch.building_index, B)
    used_p = segment_sum(target, pidx, P + 1)[:, :P]
    return (a, viol_b * hours_ratio,
            torch.where(torch.isfinite(blim), blim - used_b, torch.zeros_like(used_b)),
            torch.where(torch.isfinite(plim), plim - used_p, torch.zeros_like(used_p)))


def _ev_block(cfg: StaticConfig, params: DistrictParams, state: EnvState,
              a: torch.Tensor, hours_ratio: float) -> _EVResult:
    """EV chargers (reference ``electric_vehicle_charger.py:283-329``) with
    the offline SOC event tensors of ``compiler/events.py``; ``a`` is the
    (D, C) ``electric_vehicle_storage`` action."""
    ch, evp = params.chargers, params.evs
    r32 = _store_rounder(cfg)
    t = state.t.long()
    is_t0 = (t == 0)[:, None]
    force, drift = evp.force_soc[t], evp.drift_mult[t]          # (D, V), episode-relative
    base = torch.where(is_t0, evp.battery.initial_soc, torch.zeros_like(state.ev_soc))
    soc_evented = torch.where(
        torch.isfinite(force), force,
        torch.where(torch.isfinite(drift), torch.clamp(state.ev_soc * drift, 0.0, 1.0), base))
    # Battery.charge reads soc[t-1], except at t == 0 where it reads the
    # (possibly force-set) soc[0] (energy_model.py:662-666,1046-1047)
    soc_read = torch.where(is_t0, soc_evented, state.ev_soc)

    D = a.shape[0]
    zeros_b = a.new_zeros((D, cfg.n_buildings))
    violation, b_headroom = zeros_b, zeros_b
    p_headroom = a.new_zeros((D, cfg.n_charging_phases))
    if cfg.has_charging_constraints:
        a, violation, b_headroom, p_headroom = _charging_constraints(cfg, params, a, hours_ratio)

    zero = torch.zeros_like(a)
    charging = a > 0.0
    e_chg = torch.maximum(torch.minimum(a * ch.max_charging_power * hours_ratio,
                                        ch.max_charging_power), ch.min_charging_power)
    e_dis = torch.maximum(torch.minimum(a * ch.max_discharging_power * hours_ratio,
                                        -ch.min_discharging_power), -ch.max_discharging_power)
    energy = torch.where(charging, e_chg, e_dis)
    # power-dependent efficiency interpolated at |action|
    # (charger.py:252-281, 283-329); the packed curves are constant at
    # the scalar efficiency when the schema sets none
    eff = torch.where(charging,
                      interp_linear(torch.abs(a), ch.charge_eff_x, ch.charge_eff_y),
                      interp_linear(torch.abs(a), ch.discharge_eff_x, ch.discharge_eff_y))
    energy_kwh = torch.where(charging, energy * eff, energy / eff)

    conn = ch.connected_ev[t].long()                            # (D, C)
    connected = conn >= 0
    gidx = torch.clamp(conn, min=0)
    of_ev = lambda leaf: leaf[gidx]                             # (V, ...) -> (D, C, ...)
    at_charger = lambda x: torch.gather(x, 1, gidx)             # (D, V) -> (D, C)
    bp_c = BatteryParams(**{f.name: None if leaf is None else of_ev(leaf)
                            for f in dataclasses.fields(BatteryParams)
                            for leaf in [getattr(evp.battery, f.name)]})
    # EV battery charge is called with energy_kwh directly — no
    # _convert_energy_for_storage pre-division (charger.py:316)
    res = battery_charge(bp_c, at_charger(soc_read), at_charger(state.ev_efficiency),
                         at_charger(state.ev_degraded_capacity), energy_kwh, 1.0,
                         cfg.parity_f64)
    res = _stored(res, r32)
    applied = (a != 0.0) & connected
    balance = torch.where(applied, res.energy_balance, zero)
    cons_c = r32(torch.where(applied,
                             torch.where(balance >= 0.0, balance / eff, balance * eff), zero))
    # scatter only the applied charges: the others go to a spare column
    # that is dropped (an EV at two chargers in one step is outside the
    # data's contract; one of the two updates would win)
    sidx = torch.where(applied, gidx, torch.full_like(gidx, cfg.n_evs))
    scatter = lambda old, new: torch.cat([old, old[:, :1]], dim=1).scatter(
        1, sidx, new)[:, :cfg.n_evs]
    ev_soc = scatter(soc_evented, res.soc)
    charger_energy = torch.where(a != 0.0, energy, zero)
    reward_inputs = None
    if cfg.reward_type == "Electric_Vehicles_Reward_Function":
        reward_inputs = EVRewardInputs(
            building_index=ch.building_index,
            connected=connected,
            last_charged_kwh=charger_energy,
            soc_prev=torch.where(is_t0, of_ev(evp.battery.initial_soc),
                                 at_charger(state.ev_soc)),
            soc_now=at_charger(ev_soc),
            capacity=of_ev(evp.battery.capacity),
            depth_of_discharge=of_ev(evp.battery.depth_of_discharge),
            required_soc=ch.required_soc[t],
            hours_until_departure=ch.departure_time[t],
            max_charging_power=ch.max_charging_power,
            max_discharging_power=ch.max_discharging_power,
            violation_kwh=violation)
    return _EVResult(
        chargers_consumption=r32(segment_sum(cons_c, ch.building_index, cfg.n_buildings)),
        ev_soc=ev_soc,
        ev_efficiency=scatter(state.ev_efficiency, res.efficiency),
        ev_degraded_capacity=scatter(state.ev_degraded_capacity, res.degraded_capacity),
        violation_kwh=violation, building_headroom=b_headroom, phase_headroom=p_headroom,
        charger_consumption=cons_c, charger_energy=charger_energy,
        reward_inputs=reward_inputs)


def _washing_machines(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                      a_wm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Washing machines (reference ``energy_model.py:1289-1334``): a
    positive action inside the start/end window triggers the whole load
    once; a window that differs from the previous step's re-arms the
    machine. Returns the consumption (D, B) and the carried flag (D, W)."""
    wmp = params.washing_machines
    t = state.t.long()
    start, end = wmp.wm_start[t], wmp.wm_end[t]                 # (D, W)
    prev = torch.clamp(t - 1, min=0)
    changed = (t > 0)[:, None] & ((wmp.wm_start[prev] != start) | (wmp.wm_end[prev] != end))
    initiated = state.wm_initiated & ~changed
    tw = t[:, None]
    trigger = (~initiated & (a_wm > 0.0) & (start != -1) & (end != -1)
               & (start <= tw) & (tw <= end))
    load = wmp.triggered_load[t]
    cons_w = torch.where(trigger, load, torch.zeros_like(load))
    return (_store_rounder(cfg)(segment_sum(cons_w, wmp.building_index, cfg.n_buildings)),
            initiated | trigger)


def district_step(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                  actions: Dict[str, torch.Tensor]) -> Tuple[EnvState, StepOutput]:
    """Apply ``actions`` at the current step of a district batch and
    return the new state plus the per-step quantities.

    ``state`` carries a leading district axis ``D``; ``actions`` maps
    names to (D, B) tensors, of which this step reads
    ``electrical_storage``, ``cooling_storage``, ``heating_storage`` and
    ``dhw_storage``, on a dynamics district also ``cooling_device``,
    ``heating_device`` and ``cooling_or_heating_device``, plus
    ``electric_vehicle_storage`` (D, C) over the
    district's chargers and ``washing_machine`` (D, W) over its machines; a
    missing or inactive action is 0.0 (reference ``building.py:1561-1564``).

    Inside a :meth:`~citylearn_tpu_torch.core.step_graph.StepGraph.engaged`
    block the step is a replay of that graph's capture of it, and the
    returned state and output are its static outputs, valid until its next
    replay (:mod:`citylearn_tpu_torch.core.step_graph`).
    """
    graph = engaged_graph()
    if graph is not None:
        return graph.run(district_step, cfg, params, state, actions)
    series = params.series
    t = state.t
    tau = (state.data_offset + t).long()
    is_t0 = (t == 0)[:, None]
    ratio = cfg.time_step_ratio
    hours_ratio = cfg.seconds_per_time_step / 3600.0
    parity = cfg.parity_f64
    r32 = _store_rounder(cfg)

    at = lambda arr: arr[tau]                      # (T, B) -> (D, B)
    nsl = at(series.non_shiftable_load)
    cooling_demand_ideal = at(series.cooling_demand)
    heating_demand_ideal = at(series.heating_demand)
    dhw_demand = at(series.dhw_demand)
    solar_abs = at(series.solar_generation)
    outdoor_t = at(series.outdoor_dry_bulb_temperature)
    pricing = at(series.electricity_pricing)
    carbon = at(series.carbon_intensity)
    outage = at(series.power_outage) > 0.0
    hvac_mode = at(series.hvac_mode)
    temp_ideal = at(series.indoor_dry_bulb_temperature)
    zero = torch.zeros_like(nsl)
    action = lambda name: actions.get(name, zero)
    t0 = lambda x: torch.where(is_t0, x, zero)

    # reset-time update_variables consumption already booked at index 0
    # (building.py:2554-2558 prefill + 2618-2652), always from the *ideal*
    # (prefilled) demand. The heating branch uses the *dhw* device's efficiency when
    # the heating device is not a heat pump (building.py:2629-2632) —
    # shipped quirk.
    def heating_input(output):
        return r32(torch.where(params.heating_device.is_heat_pump,
                               hvac.input_power(params.heating_device, output, outdoor_t, True,
                                                parity),
                               output / params.dhw_device.efficiency))

    reset_cool = (r32(hvac.input_power(params.cooling_device, cooling_demand_ideal, outdoor_t,
                                       False, parity)) if cfg.any_cooling else zero)
    reset_heat = heating_input(heating_demand_ideal) if cfg.any_heating else zero
    reset_dhw = (r32(hvac.input_power(params.dhw_device, dhw_demand, outdoor_t, True, parity))
                 if cfg.any_dhw else zero)
    cons_accum = t0(reset_cool + reset_heat + reset_dhw + nsl)

    cooling_demand, heating_demand = cooling_demand_ideal, heating_demand_ideal
    if cfg.has_dynamics:
        cooling_demand, heating_demand = _partial_load_demand(
            cfg, params, t, actions, cooling_demand, heating_demand, hvac_mode, outdoor_t,
            t0(reset_cool), t0(reset_heat))

    # ---- electrical storage, early variant (discharging runs first,
    # building.py:1606-1609) ----
    bat_action = action("electrical_storage")
    bat_energy = bat_action * params.battery.nominal_power * hours_ratio
    battery = lambda energy: _stored(battery_charge(
        params.battery, state.battery_soc, state.battery_efficiency,
        state.battery_degraded_capacity, energy / ratio, ratio, parity), r32)
    bat_early = battery(bat_energy)
    bat_discharging = bat_action < 0.0
    cons_accum = cons_accum + torch.where(bat_discharging, bat_early.energy_balance, zero)

    # ---- thermal blocks in priority order: cooling, heating, dhw. Inert
    # end-uses (no demand anywhere, no storage) are identically zero ----
    inert = lambda soc: _ThermalResult(soc=soc, balance=zero, device_output=zero,
                                       apply_consumption=zero)
    if cfg.any_cooling:
        cool, cons_accum = _thermal_block(
            params.cooling_device, params.cooling_storage, state.cooling_storage_soc,
            cooling_demand, action("cooling_storage"), outdoor_t, False,
            params.cooling_storage.capacity, False,
            outage, solar_abs, cons_accum, t0(reset_cool), cfg)
    else:
        cool = inert(state.cooling_storage_soc)
    if cfg.any_heating:
        heat, cons_accum = _thermal_block(
            params.heating_device, params.heating_storage, state.heating_storage_soc,
            heating_demand, action("heating_storage"), outdoor_t, True,
            params.cooling_storage.capacity,  # quirk: building.py:1720
            True, outage, solar_abs, cons_accum, t0(reset_heat), cfg)
    else:
        heat = inert(state.heating_storage_soc)
    if cfg.any_dhw:
        dhw, cons_accum = _thermal_block(
            params.dhw_device, params.dhw_storage, state.dhw_storage_soc,
            dhw_demand, action("dhw_storage"), outdoor_t, True,
            params.heating_storage.capacity,  # quirk: building.py:1765
            True, outage, solar_abs, cons_accum, t0(reset_dhw), cfg)
    else:
        dhw = inert(state.dhw_storage_soc)

    # ---- non-shiftable load (building.py:1784-1789) ----
    nsl_met = r32(torch.minimum(nsl, _flex(outage, solar_abs, cons_accum)))
    cons_accum = cons_accum + nsl_met

    # ---- electrical storage, late variant (charging, building.py:1791-1812):
    # the request is capped by the flexibility left after every other
    # load, which only an outage makes finite; without one it is the
    # early variant's event ----
    if cfg.any_outage:
        bat_late = battery(torch.minimum(bat_energy, _flex(outage, solar_abs, cons_accum)))
        bat = type(bat_early)(*(torch.where(bat_discharging, e, l)
                                for e, l in zip(bat_early, bat_late)))
    else:
        bat = bat_early

    # ---- EV chargers and washing machines ----
    D = nsl.shape[0]
    if cfg.has_evs:
        a_ev = actions.get("electric_vehicle_storage")
        if a_ev is None:
            a_ev = nsl.new_zeros((D, cfg.n_chargers))
        ev = _ev_block(cfg, params, state, a_ev, hours_ratio)
    else:
        ev = _EVResult(
            chargers_consumption=zero, ev_soc=state.ev_soc,
            ev_efficiency=state.ev_efficiency,
            ev_degraded_capacity=state.ev_degraded_capacity,
            violation_kwh=zero, building_headroom=zero,
            phase_headroom=nsl.new_zeros((D, cfg.n_charging_phases)),
            charger_consumption=None, charger_energy=None, reward_inputs=None)
    wm_cons, wm_initiated = zero, state.wm_initiated
    if cfg.has_washing_machines:
        a_wm = actions.get("washing_machine")
        if a_wm is None:
            a_wm = nsl.new_zeros((D, cfg.n_washing_machines))
        wm_cons, wm_initiated = _washing_machines(cfg, params, state, a_wm)

    # ---- update_variables accounting (building.py:2615-2703): the t == 0
    # branch re-adds demand-derived consumption
    uv_cool = (r32(hvac.input_power(params.cooling_device,
                                    r32(cool.device_output) + cool.balance, outdoor_t, False,
                                    parity)) if cfg.any_cooling else zero)
    uv_heat = (heating_input(r32(heat.device_output) + heat.balance) if cfg.any_heating
               else zero)
    uv_dhw = (r32(hvac.input_power(params.dhw_device, r32(dhw.device_output) + dhw.balance,
                                   outdoor_t, True, parity)) if cfg.any_dhw else zero)
    cool_total = cool.apply_consumption + t0(reset_cool + uv_cool)
    heat_total = heat.apply_consumption + t0(reset_heat + uv_heat)
    dhw_total = dhw.apply_consumption + t0(reset_dhw + uv_dhw)
    nsl_total = nsl_met + t0(nsl + nsl_met)
    bat_total = bat.energy_balance + t0(bat.energy_balance)
    # the per-device electricity_consumption arrays are float64 in the
    # reference: only the net store rounds to float32 (building.py:2559)
    solar_neg = r32(-solar_abs)
    net = (cool_total + heat_total + dhw_total + nsl_total + bat_total + solar_neg
           + ev.chargers_consumption + wm_cons)
    net = r32(torch.where(outage, zero, net))
    cost = r32(net * pricing)
    emission = r32(torch.clamp(net * carbon, min=0.0))

    # storage electricity consumption series for counterfactual KPIs
    # (building.py:414-464): device input power of the tank balance
    store_cons = lambda dev, balance, heating: r32(hvac.input_power(
        dev, balance, outdoor_t, heating, parity))
    cool_store_cons = (store_cons(params.cooling_device, cool.balance, False)
                       if cfg.any_cooling else zero)
    heat_store_cons = (store_cons(params.heating_device, heat.balance, True)
                       if cfg.any_heating else zero)
    dhw_store_cons = (store_cons(params.dhw_device, dhw.balance, True)
                      if cfg.any_dhw else zero)

    # ---- LSTM temperature dynamics (building.py:2935-3078) on the fresh
    # demand observations (building.py:1435-1437) ----
    cooling_demand_obs = r32(cool.device_output) + torch.clamp(-cool.balance, min=0.0)
    heating_demand_obs = r32(heat.device_output) + torch.clamp(-heat.balance, min=0.0)
    temp_t, lstm_h, lstm_c, dyn_input = temp_ideal, state.lstm_h, state.lstm_c, state.dyn_input
    if cfg.has_dynamics:
        temp_t, lstm_h, lstm_c, dyn_input = dynamics_update(
            cfg, params, tau, t, cooling_demand_obs, heating_demand_obs, temp_ideal,
            lstm_h, lstm_c, dyn_input)
    cooling_sp = at(series.indoor_dry_bulb_temperature_cooling_set_point)
    heating_sp = at(series.indoor_dry_bulb_temperature_heating_set_point)
    # ---- occupant thermostat interaction on the predicted temperature
    # (building.py:3160-3353) ----
    occ_state = {f: getattr(state, f) for f in OCC_FIELDS}
    if cfg.has_occupant:
        cooling_sp, heating_sp, occ_state = occupant_update(
            cfg, params, state, cooling_sp, heating_sp, hvac_mode, temp_t, t)

    # ---- debug-mode physics assertions (reference building.py:1825-1834,
    # 657-665): built only when debug.enable_checks(True) was called ----
    if debug.checks_enabled():
        eps = 1e-3
        in_unit = lambda *socs: torch.stack(
            [(s >= -eps) & (s <= 1 + eps) for s in socs]).all(0)
        checks = {
            "soc_prev_in_[0,1]": in_unit(
                state.battery_soc, state.cooling_storage_soc,
                state.heating_storage_soc, state.dhw_storage_soc),
            "soc_new_in_[0,1]": in_unit(bat.soc, cool.soc, heat.soc, dhw.soc),
            # device apply-phase consumption >= 0 (building.py:1831-1834)
            "consumption_nonnegative": (
                (cool.apply_consumption >= -eps) & (heat.apply_consumption >= -eps)
                & (dhw.apply_consumption >= -eps) & (nsl_met >= -eps)),
            # met demand never exceeds requested demand (building.py:1825)
            "output_at_most_demand": (
                (cool.device_output <= cooling_demand + eps)
                & (heat.device_output <= heating_demand + eps)
                & (dhw.device_output <= dhw_demand + eps)),
            "net_finite": torch.isfinite(net),
        }
        if cfg.has_evs:
            checks["ev_soc_in_[0,1]"] = in_unit(ev.ev_soc)
        debug.runtime_check(checks)

    new_state = EnvState(
        t=t + 1,
        data_offset=state.data_offset,
        battery_soc=bat.soc,
        battery_efficiency=bat.efficiency,
        battery_degraded_capacity=bat.degraded_capacity,
        cooling_storage_soc=cool.soc,
        heating_storage_soc=heat.soc,
        dhw_storage_soc=dhw.soc,
        ev_soc=ev.ev_soc,
        ev_efficiency=ev.ev_efficiency,
        ev_degraded_capacity=ev.ev_degraded_capacity,
        wm_initiated=wm_initiated,
        lstm_h=lstm_h, lstm_c=lstm_c, dyn_input=dyn_input,
        **occ_state,
    )
    reward = compute_reward(cfg, ev=ev.reward_inputs, x=RewardInputs(
        net=net, solar=solar_abs, battery_soc=bat.soc,
        cooling_storage_soc=cool.soc, heating_storage_soc=heat.soc,
        dhw_storage_soc=dhw.soc,
        battery_capacity=params.battery.capacity,
        cooling_storage_capacity=params.cooling_storage.capacity,
        heating_storage_capacity=params.heating_storage.capacity,
        dhw_storage_capacity=params.dhw_storage.capacity,
        indoor_temperature=temp_t, hvac_mode=hvac_mode,
        cooling_set_point=cooling_sp, heating_set_point=heating_sp,
        comfort_band=at(series.comfort_band),
        cooling_demand=cooling_demand_obs, heating_demand=heating_demand_obs))
    out = StepOutput(
        net_electricity_consumption=net,
        net_electricity_consumption_cost=cost,
        net_electricity_consumption_emission=emission,
        reward=reward,
        cooling_consumption=cool_total,
        heating_consumption=heat_total,
        dhw_consumption=dhw_total,
        non_shiftable_consumption=nsl_total,
        battery_consumption=bat_total,
        cooling_storage_consumption=cool_store_cons,
        heating_storage_consumption=heat_store_cons,
        dhw_storage_consumption=dhw_store_cons,
        solar_generation=solar_neg,
        battery_soc=bat.soc,
        cooling_storage_soc=cool.soc,
        heating_storage_soc=heat.soc,
        dhw_storage_soc=dhw.soc,
        cooling_demand_met=cool.device_output,
        heating_demand_met=heat.device_output,
        dhw_demand_met=dhw.device_output,
        non_shiftable_load_met=nsl_met,
        cooling_storage_balance=cool.balance,
        heating_storage_balance=heat.balance,
        dhw_storage_balance=dhw.balance,
        battery_balance=bat.energy_balance,
        cooling_demand_actual=cooling_demand,
        heating_demand_actual=heating_demand,
        indoor_temperature=temp_t,
        cooling_set_point=cooling_sp,
        heating_set_point=heating_sp,
        chargers_consumption=ev.chargers_consumption,
        washing_machines_consumption=wm_cons,
        ev_soc=ev.ev_soc,
        charging_violation_kwh=ev.violation_kwh,
        charging_building_headroom=ev.building_headroom,
        charging_phase_headroom=ev.phase_headroom,
        charger_consumption=ev.charger_consumption,
        charger_action_kwh=ev.charger_energy,
    )
    return new_state, out
