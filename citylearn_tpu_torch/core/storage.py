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
                time_step_ratio: float) -> TankStepResult:
    """One StorageTank charge/discharge event of a ``(D, B)`` batch.

    The reference applies ``time_step_ratio`` twice for tanks —
    ``StorageTank.charge`` (``energy_model.py:863``) and then
    ``StorageDevice.charge`` (``energy_model.py:732``) — while the env
    divides once in ``Building._convert_energy_for_storage``
    (``building.py:1814-1823``); that is reproduced exactly, callers pass
    the pre-divided energy.
    """
    energy = energy * time_step_ratio
    energy = torch.where(energy >= 0.0,
                         torch.minimum(energy, sp.max_input_power),
                         torch.maximum(-sp.max_output_power, energy))
    energy = energy * time_step_ratio

    cap = sp.capacity
    energy_init = torch.clamp(soc_prev * cap * (1.0 - sp.loss_coefficient), min=0.0)
    rt = torch.sqrt(sp.efficiency)
    energy_final = torch.where(
        energy >= 0.0,
        torch.minimum(energy_init + energy * rt, cap),
        torch.clamp(energy_init + energy / rt, min=0.0))
    soc = energy_final / torch.clamp(cap, min=ZERO)
    delta = energy_final - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)
    return TankStepResult(soc=soc, energy_balance=balance)
