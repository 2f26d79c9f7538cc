"""Reward functions (reference ``citylearn/reward_function.py``), computed
from the fresh step quantities (the reference computes rewards from
``Building.observations(include_all=True)`` *after* ``update_variables``,
i.e. from the just-written index-t values — ``citylearn.py:1022-1023``).

Inputs are ``(D, B)`` tensors: district-level terms reduce over the last
(building) axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from citylearn_tpu_torch.core.types import StaticConfig

ZERO = 1e-6


class RewardInputs(NamedTuple):
    """Per-building (D, B) values reward functions read, all at the
    *freshly written* index t."""
    net: torch.Tensor
    solar: torch.Tensor                   # abs PV generation
    battery_soc: torch.Tensor
    cooling_storage_soc: torch.Tensor
    heating_storage_soc: torch.Tensor
    dhw_storage_soc: torch.Tensor
    battery_capacity: torch.Tensor        # (B,)
    cooling_storage_capacity: torch.Tensor
    heating_storage_capacity: torch.Tensor
    dhw_storage_capacity: torch.Tensor
    # read by the comfort rewards only
    indoor_temperature: Optional[torch.Tensor] = None
    hvac_mode: Optional[torch.Tensor] = None          # int
    cooling_set_point: Optional[torch.Tensor] = None
    heating_set_point: Optional[torch.Tensor] = None
    comfort_band: Optional[torch.Tensor] = None
    cooling_demand: Optional[torch.Tensor] = None     # fresh demand observation
    heating_demand: Optional[torch.Tensor] = None


def _default(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """``-(max(net, 0) ** exponent)`` (reward_function.py:65-88)."""
    return -(torch.clamp(x.net, min=0.0) ** cfg.reward_exponent)


def _independent_sac(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """``min(net * -1**3, 0)`` (reward_function.py:159-168). Note the
    reference's ``v*-1**3`` parses as ``v * (-(1**3)) = -v``."""
    return torch.clamp(-x.net, max=0.0)


def _marl(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """``sign(-net) * 0.01 * net^2 * max(0, district_net)``
    (reward_function.py:132-143: building consumption is negated before the
    sign, and the district term is the *positive* total)."""
    district = torch.sum(x.net, dim=-1, keepdim=True)
    neg = -x.net
    return torch.sign(neg) * 0.01 * (neg ** 2) * torch.clamp(district, min=0.0)


def _solar_penalty(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """Per storage system: ``-(1 + sign(net)*soc) * |net|`` when the system
    has capacity (reward_function.py:170-214)."""
    e = x.net
    term = lambda soc, cap: torch.where(
        cap > ZERO, -(1.0 + torch.sign(e) * soc) * torch.abs(e), torch.zeros_like(e))
    return (term(x.cooling_storage_soc, x.cooling_storage_capacity)
            + term(x.heating_storage_soc, x.heating_storage_capacity)
            + term(x.dhw_storage_soc, x.dhw_storage_capacity)
            + term(x.battery_soc, x.battery_capacity))


def _comfort(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """ComfortReward (reward_function.py:216-340) vectorized."""
    T = x.indoor_temperature
    band = (x.comfort_band if cfg.reward_band is None
            else torch.full_like(T, cfg.reward_band))
    zero = torch.zeros_like(T)
    lo_e, hi_e = (torch.full_like(T, e) for e in (cfg.reward_lower_exponent,
                                                  cfg.reward_higher_exponent))
    heating = x.heating_demand > x.cooling_demand
    mode = x.hvac_mode

    # --- single-setpoint branch (mode 1 cooling / 2 heating) ---
    sp = torch.where(mode == 1, x.cooling_set_point, x.heating_set_point)
    delta = torch.abs(T - sp)
    exp_below = torch.where(mode == 2, lo_e, hi_e)
    exp_above = torch.where(heating, hi_e, lo_e)
    r_single = torch.where(
        T < sp - band, -(delta ** exp_below),
        torch.where(T < sp, torch.where(heating, zero, -delta),
                    torch.where(T <= sp + band, torch.where(heating, -delta, zero),
                                -(delta ** exp_above))))

    # --- dual-setpoint dead-band branch (mode 0 off / 3 auto) ---
    csp, hsp = x.cooling_set_point, x.heating_set_point
    cd = torch.abs(T - csp)
    hd = torch.abs(T - hsp)
    exp_cold = torch.where(heating, lo_e, hi_e)
    exp_hot = torch.where(heating, hi_e, lo_e)
    r_dual = torch.where(
        T < hsp - band, -(hd ** exp_cold),
        torch.where(T < hsp, -hd,
                    torch.where(T <= csp, zero,
                                torch.where(T < csp + band, -cd, -(cd ** exp_hot)))))

    return torch.where((mode == 1) | (mode == 2), r_single, r_dual)


def segment_sum(x: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Sum ``x`` (D, C) into ``n`` segments of the last axis by ``index``
    (C,) -> (D, n), as a product with the one-hot matrix of ``index``: the
    order of each sum is fixed on every device (``index_add_`` on a CUDA
    tensor adds in an order that changes from run to run)."""
    onehot = (index.long()[:, None] == torch.arange(n, device=x.device)).to(x.dtype)
    return x @ onehot


class EVRewardInputs(NamedTuple):
    """Per-charger (D, C) values for ``Electric_Vehicles_Reward_Function``
    (reference ``reward_function.py:389-517``), all at index t."""
    building_index: torch.Tensor          # (C,) int32
    connected: torch.Tensor               # bool
    last_charged_kwh: torch.Tensor        # past_charging_action_values_kwh[t]
    soc_prev: torch.Tensor
    soc_now: torch.Tensor
    capacity: torch.Tensor                # EV model battery capacity
    depth_of_discharge: torch.Tensor
    required_soc: torch.Tensor
    hours_until_departure: torch.Tensor
    max_charging_power: torch.Tensor      # (C,)
    max_discharging_power: torch.Tensor   # (C,)
    violation_kwh: torch.Tensor           # (D, B) charging-constraint violations


def _ev_reward(cfg: StaticConfig, x: RewardInputs, ev: EVRewardInputs) -> torch.Tensor:
    """The EV reward *replaces* the MARL base with per-charger shaping —
    the MARL value only scales the penalty via ``1/(1+|r|)``; buildings
    without chargers receive 0 (``reward_function.py:413-445``). The
    disconnected-charger 'no_car_charging' term is computed then discarded
    by the reference's early ``continue`` (``reward_function.py:459-463``)
    — reproduced by contributing nothing for disconnected chargers."""
    (w_ncc, w_bl, w_imposs, w_under, w_close, w_sc, w_esp) = cfg.ev_reward_weights
    marl = _marl(cfg, x)                       # (D, B)
    if cfg.central_agent:
        base = torch.sum(marl, dim=-1, keepdim=True)
        mult_b = (1.0 / (1.0 + torch.abs(base))).expand_as(marl)
    else:
        mult_b = 1.0 / (1.0 + torch.abs(marl))
    bidx = ev.building_index.long()
    mult = mult_b[:, bidx]                     # (D, C)
    zero = torch.zeros_like(mult)

    net_b = x.net[:, bidx]
    cap = ev.capacity
    min_cap = (1.0 - ev.depth_of_discharge) * cap
    last = ev.last_charged_kwh
    current_energy = ev.soc_prev * cap + last
    c_bl = torch.where((current_energy > cap) | (current_energy < min_cap), w_bl * mult, zero)

    soc_diff = ev.soc_now - ev.required_soc
    soc_diff_kwh = soc_diff * cap
    hours = ev.hours_until_departure
    mpc = ev.max_charging_power * hours
    mpd = ev.max_discharging_power * hours
    c_imposs = torch.where(soc_diff_kwh > mpc, w_imposs * mult, zero)
    at_dep = hours == 0
    c_under = torch.where(
        at_dep & (-0.25 < soc_diff) & (soc_diff <= -0.10), 2 * w_under * mult,
        torch.where(at_dep & (soc_diff <= -0.25), (w_under ** 2) * mult, zero))
    c_close = torch.where(at_dep & (-0.10 < soc_diff) & (soc_diff <= 0.10),
                          w_close * mult, zero)
    c_close = c_close + torch.where(
        torch.abs(soc_diff_kwh) <= torch.maximum(mpc, mpd),
        w_close * mult * (1.0 / (hours + 0.1)), zero)
    c_esp = torch.where((last > 0) & (net_b < 0), w_esp * mult,
                        torch.where((last < 0) & (net_b < 0), -0.5 * w_esp * mult, zero))
    c_sc = torch.where((last < 0) & (net_b > 0), w_sc * mult,
                       torch.where((last > 0) & (net_b > 0), -0.5 * w_sc * mult, zero))

    per_charger = torch.where(
        ev.connected, c_bl + c_imposs + c_under + c_close + c_esp + c_sc, zero)
    reward = segment_sum(per_charger, ev.building_index, x.net.shape[-1])
    # charging-constraint violation penalty (reward_function.py:431-436)
    reward = reward - torch.clamp(ev.violation_kwh, min=0.0) * cfg.charging_penalty_coefficient
    if cfg.central_agent:
        return torch.sum(reward, dim=-1, keepdim=True)
    return reward


def _marl_single(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """MARL under MultiBuildingRewardFunction: each building's function
    receives only that building's observation (``reward_function.py:96-103``),
    so the 'district' total degenerates to the building's own net."""
    neg = -x.net
    return torch.sign(neg) * 0.01 * (neg ** 2) * torch.clamp(x.net, min=0.0)


_REGISTRY = {
    "RewardFunction": _default,
    "IndependentSACReward": _independent_sac,
    "MARL": _marl,
    "SolarPenaltyReward": _solar_penalty,
    "ComfortReward": _comfort,
}


def _dispatch(cfg: StaticConfig, x: RewardInputs,
              single_building: bool = False) -> torch.Tensor:
    if cfg.reward_type == "SolarPenaltyAndComfortReward":
        c = cfg.reward_coefficients
        return c[0] * _solar_penalty(cfg, x) + c[1] * _comfort(cfg, x)
    if single_building and cfg.reward_type == "MARL":
        return _marl_single(cfg, x)
    if cfg.reward_type in _REGISTRY:
        return _REGISTRY[cfg.reward_type](cfg, x)
    raise NotImplementedError(f"reward {cfg.reward_type}")


def compute_reward(cfg: StaticConfig, x: RewardInputs,
                   ev: Optional[EVRewardInputs] = None) -> torch.Tensor:
    """Dispatch on ``cfg.reward_type`` (or per-building on
    ``cfg.reward_per_building``); a central agent sums to shape (D, 1)."""
    if cfg.reward_per_building is None \
            and cfg.reward_type == "Electric_Vehicles_Reward_Function":
        if ev is None:
            raise ValueError("the EV reward needs the charger inputs of an EV district")
        return _ev_reward(cfg, x, ev)
    if cfg.reward_per_building is not None:
        # MultiBuildingRewardFunction: group buildings sharing (type, attrs),
        # evaluate each group's function once over the full building axis,
        # and select members with static masks (citylearn.py:2108-2141)
        B = x.net.shape[-1]
        groups = {}
        for bi, prm in enumerate(cfg.reward_per_building):
            groups.setdefault(prm, []).append(bi)
        r = torch.zeros_like(x.net)
        for (t, expo, band, lo, hi, coef), members in groups.items():
            gcfg = dataclasses.replace(
                cfg, reward_type=t, reward_exponent=expo, reward_band=band,
                reward_lower_exponent=lo, reward_higher_exponent=hi,
                reward_coefficients=coef, reward_per_building=None)
            mask = torch.zeros(B, dtype=torch.bool, device=x.net.device)
            mask[members] = True
            r = torch.where(mask, _dispatch(gcfg, x, single_building=True), r)
    else:
        r = _dispatch(cfg, x)
    if cfg.central_agent:
        return torch.sum(r, dim=-1, keepdim=True)
    return r
