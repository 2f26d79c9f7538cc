"""The battery+PV district step: one function of tensors replacing the
reference's ``CityLearnEnv.step`` cascade (``citylearn/citylearn.py:978-1056``
-> ``building.py:1500-1834`` -> ``energy_model.py``) for districts whose
buildings hold a battery, PV and a non-shiftable load.

Everything is elementwise over a ``(D, B)`` batch of districts and
buildings. With no thermal end uses and no power outage, the JAX
package's early (discharging) and late (charging) battery variants see
the same unlimited flexibility and give the same result, so one battery
event serves both.

t == 0 quirks reproduced (``building.py:2526-2564, 2615-2652``): at reset
the non-shiftable load is prefilled and ``update_variables`` runs once;
during the first step the t == 0 branch adds it again — the
non-shiftable consumption at index 0 is triple-counted and the battery's
double-counted. Observations, rewards and KPI series see these values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from citylearn_tpu_torch.core.battery import battery_charge
from citylearn_tpu_torch.core.reward import RewardInputs, compute_reward
from citylearn_tpu_torch.core.types import (
    DistrictParams,
    EnvState,
    StaticConfig,
    StepOutput,
)

#: configuration flags of blocks this step does not carry
_UNSUPPORTED = ("any_cooling", "any_heating", "any_dhw", "has_dynamics",
                "has_evs", "has_washing_machines", "has_occupant",
                "any_outage", "has_stochastic_outage", "parity_f64")


def check_supported(cfg: StaticConfig):
    """Raise ``NotImplementedError`` for a configuration outside the
    battery+PV district."""
    on = [name for name in _UNSUPPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(
            f"the PyTorch port steps battery+PV districts only; this "
            f"configuration sets {', '.join(on)}")


def district_step(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                  actions: Dict[str, torch.Tensor]) -> Tuple[EnvState, StepOutput]:
    """Apply ``actions`` at the current step of a district batch and
    return the new state plus the per-step quantities.

    ``state`` carries a leading district axis ``D``; ``actions`` maps
    names to (D, B) tensors, of which this district reads
    ``electrical_storage`` (the other storages and devices are absent).
    """
    check_supported(cfg)
    series = params.series
    t = state.t
    tau = (state.data_offset + t).long()
    is_t0 = (t == 0)[:, None]
    ratio = cfg.time_step_ratio
    hours_ratio = cfg.seconds_per_time_step / 3600.0

    at = lambda arr: arr[tau]                      # (T, B) -> (D, B)
    nsl = at(series.non_shiftable_load)
    solar_abs = at(series.solar_generation)
    pricing = at(series.electricity_pricing)
    carbon = at(series.carbon_intensity)

    # ---- electrical storage (building.py:1606-1609, 1791-1812) ----
    bat_action = actions.get("electrical_storage", torch.zeros_like(nsl))
    bat_energy = bat_action * params.battery.nominal_power * hours_ratio
    bat = battery_charge(params.battery, state.battery_soc,
                         state.battery_efficiency,
                         state.battery_degraded_capacity,
                         bat_energy / ratio, ratio)

    # ---- update_variables accounting (building.py:2615-2703): the t == 0
    # branch re-adds the reset-time non-shiftable load and battery balance
    nsl_met = nsl
    t0 = lambda x: torch.where(is_t0, x, torch.zeros_like(x))
    nsl_total = nsl_met + t0(nsl + nsl_met)
    bat_total = bat.energy_balance + t0(bat.energy_balance)
    solar_neg = -solar_abs
    net = nsl_total + bat_total + solar_neg
    cost = net * pricing
    emission = torch.clamp(net * carbon, min=0.0)

    new_state = EnvState(
        t=t + 1,
        data_offset=state.data_offset,
        battery_soc=bat.soc,
        battery_efficiency=bat.efficiency,
        battery_degraded_capacity=bat.degraded_capacity,
    )
    reward = compute_reward(cfg, RewardInputs(
        net=net, solar=solar_abs, battery_soc=bat.soc,
        battery_capacity=params.battery.capacity))
    out = StepOutput(
        net_electricity_consumption=net,
        net_electricity_consumption_cost=cost,
        net_electricity_consumption_emission=emission,
        reward=reward,
        non_shiftable_consumption=nsl_total,
        battery_consumption=bat_total,
        solar_generation=solar_neg,
        battery_soc=bat.soc,
        battery_balance=bat.energy_balance,
        non_shiftable_load_met=nsl_met,
        cooling_demand_actual=at(series.cooling_demand),
        heating_demand_actual=at(series.heating_demand),
        indoor_temperature=at(series.indoor_dry_bulb_temperature),
        cooling_set_point=at(series.indoor_dry_bulb_temperature_cooling_set_point),
        heating_set_point=at(series.indoor_dry_bulb_temperature_heating_set_point),
    )
    return new_state, out
