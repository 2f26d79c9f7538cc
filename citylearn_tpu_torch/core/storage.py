"""Thermal storage tank physics (reference ``energy_model.py:603-871``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from citylearn_tpu_torch.core.types import StorageTankParams

ZERO = 1e-6


class TankStepResult(NamedTuple):
    soc: torch.Tensor
    energy_balance: torch.Tensor


def tank_charge(sp: StorageTankParams, soc_prev: torch.Tensor, energy: torch.Tensor,
                time_step_ratio: float, parity_f64: bool = False) -> TankStepResult:
    """One StorageTank charge/discharge event of a ``(D, B)`` batch.

    The reference applies ``time_step_ratio`` twice for tanks —
    ``StorageTank.charge`` (``energy_model.py:863``) and then
    ``StorageDevice.charge`` (``energy_model.py:732``) — while the env
    divides once in ``Building._convert_energy_for_storage``
    (``building.py:1814-1823``); that is reproduced exactly, callers pass
    the pre-divided energy.

    ``parity_f64``: the reference reads ``soc`` as an np.float32 scalar, so
    ``soc * capacity`` (``energy_model.py:666``) rounds to float32 when the
    capacity is a weak Python float (schema literal, NEP 50) OR itself an
    np.float32 (tank autosize = ``np.nanmax`` over the float32 demand
    series, ``energy_model.py:793``); only a strong np.float64 capacity
    keeps the chain in float64.
    """
    energy = energy * time_step_ratio
    energy = torch.where(energy >= 0.0,
                         torch.minimum(energy, sp.max_input_power),
                         torch.maximum(-sp.max_output_power, energy))
    energy = energy * time_step_ratio

    cap = sp.capacity
    soc_cap = soc_prev * cap
    if parity_f64:
        rounds_f32 = sp.capacity_weak
        if sp.capacity_npf32 is not None:
            rounds_f32 = rounds_f32 | sp.capacity_npf32
        soc_cap = torch.where(rounds_f32, soc_cap.float().to(soc_cap.dtype), soc_cap)
    energy_init = torch.clamp(soc_cap * (1.0 - sp.loss_coefficient), min=0.0)
    rt = torch.sqrt(sp.efficiency)
    energy_final = torch.where(
        energy >= 0.0,
        torch.minimum(energy_init + energy * rt, cap),
        torch.clamp(energy_init + energy / rt, min=0.0))
    soc = energy_final / torch.clamp(cap, min=ZERO)
    delta = energy_final - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)
    return TankStepResult(soc=soc, energy_balance=balance)
