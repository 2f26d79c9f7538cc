"""CityLearn's battery (``citylearn/energy_model.py`` ``Battery.charge``)
for a (D, B) batch in float32: the capacity-power and power-efficiency
curve lookups, the depth-of-discharge floor, round-trip efficiency, losses
and capacity degradation."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

ZERO = 1e-6   # citylearn/data.py's ZERO_DIVISION_PLACEHOLDER


@dataclass
class Batteries:
    """(B,) parameters and the (B, n) curves of B batteries, a shorter
    curve padded by repeating its last knot (which no lookup reaches)."""
    capacity: torch.Tensor
    nominal_power: torch.Tensor
    loss_coefficient: torch.Tensor
    depth_of_discharge: torch.Tensor
    capacity_loss_coefficient: torch.Tensor
    efficiency: torch.Tensor
    initial_soc: torch.Tensor
    pec: Tuple[torch.Tensor, torch.Tensor]     # power efficiency curve: x, y (B, n)
    cpc: Tuple[torch.Tensor, torch.Tensor]     # capacity power curve

    @classmethod
    def of(cls, buildings, device, dtype=torch.float32) -> "Batteries":
        f = lambda key: torch.tensor([getattr(b, key) for b in buildings], dtype=dtype,
                                     device=device)

        def curves(key):
            knots = [getattr(b, key) for b in buildings]
            n = max(len(k) for k in knots)
            padded = np.stack([np.concatenate([k, np.repeat(k[-1:], n - len(k), 0)]) for k in knots])
            t = torch.tensor(padded, dtype=dtype, device=device)
            return t[..., 0], t[..., 1]

        return cls(capacity=f("capacity"), nominal_power=f("nominal_power"),
                   loss_coefficient=f("loss_coefficient"),
                   depth_of_discharge=f("depth_of_discharge"),
                   capacity_loss_coefficient=f("capacity_loss_coefficient"),
                   efficiency=f("efficiency"), initial_soc=f("initial_soc"),
                   pec=curves("pec"), cpc=curves("cpc"))


def lookup(q: torch.Tensor, curve) -> torch.Tensor:
    """Piecewise-linear value at ``q`` (D, B) of each building's curve: the
    segment starts at the knot before the first knot at or above ``q``
    (``idx = max(0, argmax(q <= x) - 1)``; no such knot: the first
    segment)."""
    x, y = (c.expand(q.shape + c.shape[-1:]) for c in curve)
    above = q[..., None] <= x
    first = torch.where(above.any(-1), above.float().argmax(-1), 0)
    i = torch.clamp(first - 1, min=0)[..., None]
    take = lambda a, j: torch.gather(a, -1, j)[..., 0]
    x0, x1, y0, y1 = take(x, i), take(x, i + 1), take(y, i), take(y, i + 1)
    return y0 + (q - x0) * (y1 - y0) / (x1 - x0)


def charge(bat: Batteries, soc, eff, deg, energy, time_step_ratio: float = 1.0):
    """One charge or discharge request of ``energy`` kWh (D, B) from state
    (soc, efficiency, degraded capacity). Returns the new state and the
    energy drawn from (positive) or given to (negative) the building."""
    cap, nominal = bat.capacity, bat.nominal_power
    cap_safe = torch.clamp(cap, min=ZERO)
    nominal_safe = torch.clamp(nominal, min=ZERO)
    energy_init = torch.clamp(soc * cap * (1.0 - bat.loss_coefficient), min=0.0)
    max_power = nominal * lookup(energy_init / cap_safe, bat.cpc)
    charging = energy >= 0.0

    e_charge = torch.minimum(torch.minimum(max_power, nominal.expand_as(max_power)),
                             torch.minimum(deg - energy_init, energy))
    floor = -torch.clamp((soc - (1.0 - bat.depth_of_discharge)) * cap * torch.sqrt(eff), min=0.0)
    e_discharge = torch.maximum(torch.maximum(-max_power, floor), energy)
    e = torch.where(charging, e_charge, e_discharge)
    power_share = torch.where(charging, torch.abs(torch.minimum(energy, max_power)),
                              torch.minimum(torch.abs(energy), max_power)) / nominal_safe
    new_eff = lookup(power_share, bat.pec)

    root = torch.sqrt(new_eff)
    final = torch.where(e >= 0.0, torch.minimum(energy_init + e * root, cap.expand_as(e)),
                        torch.clamp(energy_init + e / root, min=0.0))
    delta = final - energy_init
    balance = torch.where(delta >= 0.0, delta / root, delta * root)
    loss = bat.capacity_loss_coefficient * cap * torch.abs(balance) / (
        2.0 * torch.clamp(deg, min=ZERO))
    new_deg = torch.clamp(deg - loss * time_step_ratio, min=0.0)
    return final / cap_safe, new_eff, new_deg, balance
