"""The district step: one function of tensors replacing the reference's
``CityLearnEnv.step`` cascade (``citylearn/citylearn.py:978-1056``
-> ``building.py:1500-1834`` -> ``energy_model.py``) for districts whose
buildings hold cooling, heating and DHW end uses (heat pump or electric
heater plus a storage tank each), a battery, PV and a non-shiftable
load — the 2022 (battery+PV) and 2021 (thermal-storage) families.
Power outage, LSTM dynamics, EVs, washing machines, occupants and the
float64 parity mode raise ``NotImplementedError``.

Everything is elementwise over a ``(D, B)`` batch of districts and
buildings.

Order semantics (reference ``building.py:1566-1632``): the priority list is
reordered per building from the *signs* of the storage actions —
discharging electrical storage runs first, and a discharging end-use tank
runs before its device. Because each decision is local, both orderings of
every block are computed elementwise and selected with ``torch.where``;
the cross-block coupling (``downward_electrical_flexibility``,
``building.py:640-668``) is threaded through a consumption accumulator.
Without a power outage that flexibility is +inf: the blocks decouple and
the late battery variant equals the early one, so it is computed only
for a configuration with an outage.

t == 0 quirks reproduced (``building.py:2526-2564, 2615-2652``): at reset
the device-energy arrays are prefilled with the raw demand series and
``update_variables`` runs once; during the first step the t == 0 branch of
``update_variables`` adds demand-derived consumption again — so device
consumptions at index 0 are triple-counted (battery: double).
Observations, rewards and KPI series see these values.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from citylearn_tpu_torch.core import hvac
from citylearn_tpu_torch.core.battery import battery_charge
from citylearn_tpu_torch.core.reward import RewardInputs, compute_reward
from citylearn_tpu_torch.core.storage import tank_charge
from citylearn_tpu_torch.core.types import (
    DistrictParams,
    EnvState,
    HVACParams,
    StaticConfig,
    StepOutput,
    StorageTankParams,
)

#: configuration flags of blocks this step does not carry
_UNSUPPORTED = ("has_dynamics", "has_evs", "has_washing_machines", "has_occupant",
                "any_outage", "has_stochastic_outage", "parity_f64")


def check_supported(cfg: StaticConfig):
    """Raise ``NotImplementedError`` for a configuration outside the
    battery+PV and thermal-storage districts."""
    on = [name for name in _UNSUPPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(
            f"the PyTorch port steps battery+PV and thermal-storage districts "
            f"(cooling, heating and DHW devices and tanks, battery, PV); this "
            f"configuration sets {', '.join(on)}")


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


def _thermal_block(dev: HVACParams, tank: StorageTankParams, soc_prev: torch.Tensor,
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
    energy_req = action * conv_capacity * (hours_ratio if hours_ratio_applies else 1.0)
    ratio = cfg.time_step_ratio
    dev_cons = lambda out: torch.clamp(hvac.input_power(dev, out, outdoor_t, heating), min=0.0)
    store_cons = lambda bal: hvac.input_power(dev, torch.clamp(bal, min=0.0), outdoor_t, heating)

    # ---- variant A: device first, then storage charge (action >= 0) ----
    # update_energy_from_<end_use>_device (building.py:1641-1661): storage
    # balance at t is still 0, so storage_output = 0.
    flex1 = _flex(outage, solar_abs, cons_accum)
    max_out1 = hvac.max_output_power(dev, outdoor_t, heating, flex1, dev_cons_init)
    out_A = torch.minimum(demand, max_out1)
    cons_dev_A = dev_cons(out_A)
    # update_<end_use>_storage charging branch (building.py:1663-1687):
    # clamp by the device's max output given consumption booked so far.
    flex2 = _flex(outage, solar_abs, cons_accum + cons_dev_A)
    max_out2 = hvac.max_output_power(dev, outdoor_t, heating, flex2,
                                     dev_cons_init + cons_dev_A)
    charge_A = torch.minimum(max_out2, energy_req)
    tank_A = tank_charge(tank, soc_prev, charge_A / ratio, ratio)
    cons_store_A = store_cons(tank_A.energy_balance)

    # ---- variant B: storage discharge first, then device (action < 0) ----
    discharge_B = torch.maximum(-demand, energy_req)
    tank_B = tank_charge(tank, soc_prev, discharge_B / ratio, ratio)
    cons_store_B = store_cons(tank_B.energy_balance)     # 0 for a true discharge
    storage_out_B = -torch.clamp(tank_B.energy_balance, max=0.0)
    flex_B = _flex(outage, solar_abs, cons_accum + cons_store_B)
    max_out_B = hvac.max_output_power(dev, outdoor_t, heating, flex_B,
                                      dev_cons_init + cons_store_B)
    out_B = torch.minimum(demand - storage_out_B, max_out_B)
    cons_dev_B = dev_cons(out_B)

    discharging = action < 0.0
    pick = lambda a, b: torch.where(discharging, b, a)
    apply_cons = pick(cons_dev_A + cons_store_A, cons_dev_B + cons_store_B)
    return (_ThermalResult(soc=pick(tank_A.soc, tank_B.soc),
                           balance=pick(tank_A.energy_balance, tank_B.energy_balance),
                           device_output=pick(out_A, out_B),
                           apply_consumption=apply_cons),
            cons_accum + apply_cons)


def district_step(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                  actions: Dict[str, torch.Tensor]) -> Tuple[EnvState, StepOutput]:
    """Apply ``actions`` at the current step of a district batch and
    return the new state plus the per-step quantities.

    ``state`` carries a leading district axis ``D``; ``actions`` maps
    names to (D, B) tensors, of which this step reads
    ``electrical_storage``, ``cooling_storage``, ``heating_storage`` and
    ``dhw_storage``; a missing or inactive action is 0.0 (reference
    ``building.py:1561-1564``).
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
    cooling_demand = at(series.cooling_demand)
    heating_demand = at(series.heating_demand)
    dhw_demand = at(series.dhw_demand)
    solar_abs = at(series.solar_generation)
    outdoor_t = at(series.outdoor_dry_bulb_temperature)
    pricing = at(series.electricity_pricing)
    carbon = at(series.carbon_intensity)
    outage = at(series.power_outage) > 0.0
    zero = torch.zeros_like(nsl)
    action = lambda name: actions.get(name, zero)
    t0 = lambda x: torch.where(is_t0, x, zero)

    # reset-time update_variables consumption already booked at index 0
    # (building.py:2554-2558 prefill + 2618-2652), from the prefilled
    # demand. The heating branch uses the *dhw* device's efficiency when
    # the heating device is not a heat pump (building.py:2629-2632) —
    # shipped quirk.
    def heating_input(output):
        return torch.where(params.heating_device.is_heat_pump,
                           hvac.input_power(params.heating_device, output, outdoor_t, True),
                           output / params.dhw_device.efficiency)

    reset_cool = (hvac.input_power(params.cooling_device, cooling_demand, outdoor_t, False)
                  if cfg.any_cooling else zero)
    reset_heat = heating_input(heating_demand) if cfg.any_heating else zero
    reset_dhw = (hvac.input_power(params.dhw_device, dhw_demand, outdoor_t, True)
                 if cfg.any_dhw else zero)
    cons_accum = t0(reset_cool + reset_heat + reset_dhw + nsl)

    # ---- electrical storage, early variant (discharging runs first,
    # building.py:1606-1609) ----
    bat_action = action("electrical_storage")
    bat_energy = bat_action * params.battery.nominal_power * hours_ratio
    battery = lambda energy: battery_charge(
        params.battery, state.battery_soc, state.battery_efficiency,
        state.battery_degraded_capacity, energy / ratio, ratio)
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
    nsl_met = torch.minimum(nsl, _flex(outage, solar_abs, cons_accum))
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

    # ---- update_variables accounting (building.py:2615-2703): the t == 0
    # branch re-adds demand-derived consumption
    uv_cool = (hvac.input_power(params.cooling_device, cool.device_output + cool.balance,
                                outdoor_t, False) if cfg.any_cooling else zero)
    uv_heat = heating_input(heat.device_output + heat.balance) if cfg.any_heating else zero
    uv_dhw = (hvac.input_power(params.dhw_device, dhw.device_output + dhw.balance,
                               outdoor_t, True) if cfg.any_dhw else zero)
    cool_total = cool.apply_consumption + t0(reset_cool + uv_cool)
    heat_total = heat.apply_consumption + t0(reset_heat + uv_heat)
    dhw_total = dhw.apply_consumption + t0(reset_dhw + uv_dhw)
    nsl_total = nsl_met + t0(nsl + nsl_met)
    bat_total = bat.energy_balance + t0(bat.energy_balance)
    solar_neg = -solar_abs
    net = cool_total + heat_total + dhw_total + nsl_total + bat_total + solar_neg
    net = torch.where(outage, zero, net)
    cost = net * pricing
    emission = torch.clamp(net * carbon, min=0.0)

    # storage electricity consumption series for counterfactual KPIs
    # (building.py:414-464): device input power of the tank balance
    cool_store_cons = (hvac.input_power(params.cooling_device, cool.balance, outdoor_t, False)
                       if cfg.any_cooling else zero)
    heat_store_cons = (hvac.input_power(params.heating_device, heat.balance, outdoor_t, True)
                       if cfg.any_heating else zero)
    dhw_store_cons = (hvac.input_power(params.dhw_device, dhw.balance, outdoor_t, True)
                      if cfg.any_dhw else zero)

    new_state = EnvState(
        t=t + 1,
        data_offset=state.data_offset,
        battery_soc=bat.soc,
        battery_efficiency=bat.efficiency,
        battery_degraded_capacity=bat.degraded_capacity,
        cooling_storage_soc=cool.soc,
        heating_storage_soc=heat.soc,
        dhw_storage_soc=dhw.soc,
    )
    reward = compute_reward(cfg, RewardInputs(
        net=net, solar=solar_abs, battery_soc=bat.soc,
        cooling_storage_soc=cool.soc, heating_storage_soc=heat.soc,
        dhw_storage_soc=dhw.soc,
        battery_capacity=params.battery.capacity,
        cooling_storage_capacity=params.cooling_storage.capacity,
        heating_storage_capacity=params.heating_storage.capacity,
        dhw_storage_capacity=params.dhw_storage.capacity))
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
        indoor_temperature=at(series.indoor_dry_bulb_temperature),
        cooling_set_point=at(series.indoor_dry_bulb_temperature_cooling_set_point),
        heating_set_point=at(series.indoor_dry_bulb_temperature_heating_set_point),
    )
    return new_state, out
