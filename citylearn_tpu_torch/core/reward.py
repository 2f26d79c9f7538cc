"""Reward functions (reference ``citylearn/reward_function.py``), computed
from the fresh step quantities (the reference computes rewards from
``Building.observations(include_all=True)`` *after* ``update_variables``,
i.e. from the just-written index-t values — ``citylearn.py:1022-1023``).

Inputs are ``(D, B)`` tensors: district-level terms reduce over the last
(building) axis. ComfortReward, SolarPenaltyAndComfortReward and the EV
reward need the dynamics and EV blocks and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
}


def _dispatch(cfg: StaticConfig, x: RewardInputs,
              single_building: bool = False) -> torch.Tensor:
    if single_building and cfg.reward_type == "MARL":
        return _marl_single(cfg, x)
    if cfg.reward_type in _REGISTRY:
        return _REGISTRY[cfg.reward_type](cfg, x)
    raise NotImplementedError(f"reward {cfg.reward_type}")


def compute_reward(cfg: StaticConfig, x: RewardInputs) -> torch.Tensor:
    """Dispatch on ``cfg.reward_type`` (or per-building on
    ``cfg.reward_per_building``); a central agent sums to shape (D, 1)."""
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
