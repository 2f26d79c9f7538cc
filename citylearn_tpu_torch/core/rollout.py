"""Batched episode rollouts: a Python loop over time steps, each step one
:func:`~citylearn_tpu_torch.core.step.district_step` over a leading
district axis ``D`` (the JAX package's ``lax.scan`` over a ``vmap``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.core.params import initial_state
from citylearn_tpu_torch.core.step import check_supported, district_step
from citylearn_tpu_torch.core.types import DistrictParams, EnvState, StaticConfig, map_tensors

ACTION_KEYS = ("cooling_storage", "heating_storage", "dhw_storage",
               "electrical_storage", "cooling_device", "heating_device",
               "cooling_or_heating_device")


def actions_dict_from_array(arr: torch.Tensor, keys=ACTION_KEYS) -> Dict[str, torch.Tensor]:
    """(D, A, B) action stack -> name dict of (D, B) (A = len(keys))."""
    return {k: arr[:, i] for i, k in enumerate(keys)}


def _n_reward(cfg: StaticConfig) -> int:
    return 1 if cfg.central_agent else cfg.n_buildings


def rollout_scripted(cfg: StaticConfig, params: DistrictParams, states: EnvState,
                     action_series: torch.Tensor,
                     collect: bool = False) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Run ``action_series`` of shape (D, S, A, B) through S steps of a
    (D, ...) district batch.

    Returns the final states and ``reward_sum`` (D, n_reward); with
    ``collect=True`` also the (D, S, B) net/cost/emission/reward/
    battery_soc series."""
    D = states.t.shape[0]
    reward_sum = torch.zeros((D, _n_reward(cfg)), dtype=torch.float32,
                             device=params.device)
    ys = {k: [] for k in ("net", "cost", "emission", "reward", "battery_soc")}
    for s in range(action_series.shape[1]):
        states, out = district_step(cfg, params, states,
                                    actions_dict_from_array(action_series[:, s]))
        reward_sum = reward_sum + out.reward
        if collect:
            ys["net"].append(out.net_electricity_consumption)
            ys["cost"].append(out.net_electricity_consumption_cost)
            ys["emission"].append(out.net_electricity_consumption_emission)
            ys["reward"].append(out.reward)
            ys["battery_soc"].append(out.battery_soc)
    result = {"reward_sum": reward_sum}
    if collect:
        result.update({k: torch.stack(v, dim=1) for k, v in ys.items()})
    return states, result


def rollout_policy(cfg: StaticConfig, params: DistrictParams, states: EnvState,
                   n_steps: int, policy: Callable) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Closed-loop rollout: ``policy(params, states) -> {name: (D, B)}``
    computes each step's actions from the current states; on an EV
    district the dict may also hold ``electric_vehicle_storage`` (D, C)
    over the chargers and ``washing_machine`` (D, W) over the machines."""
    D = states.t.shape[0]
    reward_sum = torch.zeros((D, _n_reward(cfg)), dtype=torch.float32,
                             device=params.device)
    for _ in range(n_steps):
        states, out = district_step(cfg, params, states, policy(params, states))
        reward_sum = reward_sum + out.reward
    return states, {"reward_sum": reward_sum}


def hour_rbc_policy(table, action_key: str = "electrical_storage"):
    """Hour-indexed RBC (reference ``agents/rbc.py:80-137``): a static
    (24,) action table gathered by the hour series."""
    def policy(params: DistrictParams, states: EnvState) -> Dict[str, torch.Tensor]:
        tab = torch.as_tensor(table, dtype=torch.float32, device=params.device)
        tau = (states.data_offset + states.t).long()
        hour = params.series.hour[tau].long()                 # (D, B) 1-24
        act = tab[hour - 1]
        zero = torch.zeros_like(act)
        return {k: (act if k == action_key else zero) for k in ACTION_KEYS}
    return policy


def rollout_districts(cfg: StaticConfig, params: DistrictParams,
                      states: EnvState, n_steps: int, policy: Callable,
                      device=None) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Batched closed-loop episode rollout over a (D, ...) state batch on
    ``device`` (the CUDA card by default) — the library-level entry point
    for large batched rollouts."""
    check_supported(cfg)
    dev = resolve_device(device)
    return rollout_policy(cfg, params.to(dev), states.to(dev), n_steps, policy)


def batched_initial_states(cfg: StaticConfig, params: DistrictParams,
                           n_districts: int, data_offset: int = 0,
                           device=None) -> EnvState:
    """(D, ...) stacked initial states on ``device`` (the CUDA card by
    default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    s = initial_state(cfg, params.to(dev), data_offset)
    return map_tensors(
        lambda x: x.expand((n_districts,) + x.shape).contiguous(), s)
