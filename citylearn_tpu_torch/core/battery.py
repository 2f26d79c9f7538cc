"""Battery physics as a vectorized function of tensors.

Reproduces ``citylearn.energy_model.Battery.charge`` and its parents
(reference ``energy_model.py:719-768, 1027-1141``) over any leading
batch axes ending in the building axis: SOC-dependent max power
(capacity_power_curve), power-dependent efficiency
(power_efficiency_curve), depth-of-discharge floor, standby loss,
capacity clamp, round-trip-efficiency split, and per-cycle degradation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from citylearn_tpu_torch.core.curves import interp_reference
from citylearn_tpu_torch.core.types import BatteryParams

ZERO = 1e-6  # reference citylearn/data.py:19 ZERO_DIVISION_PLACEHOLDER


class BatteryStepResult(NamedTuple):
    soc: torch.Tensor                 # new SOC fraction
    energy_balance: torch.Tensor      # charged(+)/discharged(-) kWh incl. losses
    efficiency: torch.Tensor          # efficiency applied this event
    degraded_capacity: torch.Tensor   # capacity after this cycle's degradation


def battery_charge(bp: BatteryParams, soc_prev: torch.Tensor,
                   prev_efficiency: torch.Tensor, degraded_capacity: torch.Tensor,
                   energy: torch.Tensor, time_step_ratio: float,
                   parity_f64: bool = False) -> BatteryStepResult:
    """One charge/discharge event.

    ``energy`` is the requested kWh *before* the reference's internal
    ``energy *= time_step_ratio`` (``energy_model.py:1036``); the env path
    divides by the ratio first (``building.py:1814-1823``) so the two
    cancel. ``prev_efficiency`` is the efficiency history tail used by the
    DoD limit (``energy_model.py:1046-1049`` reads ``round_trip_efficiency``
    *before* the new efficiency is appended).

    ``parity_f64`` reproduces the reference's NumPy-2 scalar dtype flow:
    ``soc`` is read as an np.float32 scalar and Python-float (weak)
    parameters keep the chain in float32 until a strong np.float64 enters —
    so ``soc * capacity`` (``energy_model.py:666``) and the DoD limit chain
    (``energy_model.py:1045-1049``) round to float32 exactly when the
    parameter is a schema literal (``capacity_weak``/``dod_weak``), while
    autosized/sampled parameters (np.float64, strong) keep float64.
    """
    cap = bp.capacity
    energy = energy * time_step_ratio
    action_energy = energy

    if parity_f64:
        rw = lambda x, weak: torch.where(weak, x.float().to(x.dtype), x)
    else:
        rw = lambda x, weak: x

    energy_init = torch.clamp(rw(soc_prev * cap, bp.capacity_weak)
                              * (1.0 - bp.loss_coefficient), min=0.0)
    charging = energy >= 0.0

    # SOC-dependent max input/output power (energy_model.py:1070-1090)
    soc_norm = energy_init / torch.clamp(cap, min=ZERO)
    max_power = bp.nominal_power * interp_reference(
        soc_norm, bp.capacity_power_curve_x, bp.capacity_power_curve_y)

    # --- charging branch (energy_model.py:1039-1043) ---
    energy_wrt_degrade = degraded_capacity - energy_init
    e_charge = torch.minimum(
        torch.minimum(max_power, bp.nominal_power.expand_as(max_power)),
        torch.minimum(energy_wrt_degrade, energy))
    eff_charge = interp_reference(
        torch.abs(torch.minimum(action_energy, max_power))
        / torch.clamp(bp.nominal_power, min=ZERO),
        bp.power_efficiency_curve_x, bp.power_efficiency_curve_y)

    # --- discharging branch (energy_model.py:1045-1052) ---
    old_rt = torch.sqrt(prev_efficiency)
    soc_limit = 1.0 - bp.depth_of_discharge
    if parity_f64:
        # np.float32(soc) - weak soc_limit rounds f32; x weak capacity again
        soc_diff = rw(soc_prev - soc_limit, bp.dod_weak)
        diff_cap = rw(soc_diff * cap, bp.dod_weak & bp.capacity_weak)
    else:
        diff_cap = (soc_prev - soc_limit) * cap
    energy_limit_dod = -torch.clamp(diff_cap * old_rt, min=0.0)
    e_discharge = torch.maximum(torch.maximum(-max_power, energy_limit_dod), energy)
    eff_discharge = interp_reference(
        torch.minimum(torch.abs(action_energy), max_power)
        / torch.clamp(bp.nominal_power, min=ZERO),
        bp.power_efficiency_curve_x, bp.power_efficiency_curve_y)

    e = torch.where(charging, e_charge, e_discharge)
    efficiency = torch.where(charging, eff_charge, eff_discharge)
    rt = torch.sqrt(efficiency)

    # StorageDevice.charge with round-trip split (energy_model.py:729-739)
    energy_final = torch.where(
        e >= 0.0,
        torch.minimum(energy_init + e * rt, cap.expand_as(e)),
        torch.clamp(energy_init + e / rt, min=0.0))
    soc = energy_final / torch.clamp(cap, min=ZERO)

    # set_energy_balance (energy_model.py:744-768)
    delta = energy_final - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)

    # degradation (energy_model.py:1130-1141)
    degrade = (bp.capacity_loss_coefficient * cap * torch.abs(balance)
               / (2.0 * torch.clamp(degraded_capacity, min=ZERO))) * time_step_ratio
    new_degraded = torch.clamp(degraded_capacity - degrade, min=0.0)

    return BatteryStepResult(soc=soc, energy_balance=balance,
                             efficiency=efficiency, degraded_capacity=new_degraded)
