"""Heat pump / electric heater physics (reference ``energy_model.py:157-451``),
elementwise over ``(D, B)`` batches with ``(B,)`` device parameters.

All-float32: the JAX package's float64 reference-parity mode is not
carried."""

from __future__ import annotations

import torch

from citylearn_tpu_torch.core.types import HVACParams


def heat_pump_cop(hp: HVACParams, outdoor_t: torch.Tensor, heating: bool) -> torch.Tensor:
    """Carnot COP clamped to (0, 20] (``energy_model.py:216-250``).

    NaN/inf (division by zero at target == outdoor) follows the reference's
    ``cop[cop < 0] = 20; cop[cop > 20] = 20`` numpy comparisons, where NaN
    compares False and would propagate — non-finite maps to 20 as the
    reference's datasets never hit exact equality in practice.
    """
    target = hp.target_heating_temperature if heating else hp.target_cooling_temperature
    denom = target - outdoor_t if heating else outdoor_t - target
    cop = hp.efficiency * (target + 273.15) / denom
    twenty = torch.full_like(cop, 20.0)
    cop = torch.where(cop < 0, twenty, cop)
    cop = torch.where(cop > 20, twenty, cop)
    return torch.where(torch.isfinite(cop), cop, twenty)


def device_cop(dev: HVACParams, outdoor_t: torch.Tensor, heating: bool) -> torch.Tensor:
    """COP for heat pumps, static efficiency passthrough for heaters."""
    return torch.where(dev.is_heat_pump, heat_pump_cop(dev, outdoor_t, heating),
                       dev.efficiency)


def input_power(dev: HVACParams, output: torch.Tensor, outdoor_t: torch.Tensor,
                heating: bool) -> torch.Tensor:
    """Electric input for thermal ``output`` (``energy_model.py:283-307,403-423``)."""
    return torch.where(dev.is_heat_pump,
                       output / heat_pump_cop(dev, outdoor_t, heating),
                       output / dev.efficiency)


def max_output_power(dev: HVACParams, outdoor_t: torch.Tensor, heating: bool,
                     max_electric_power: torch.Tensor,
                     consumed_so_far: torch.Tensor) -> torch.Tensor:
    """``min(max_electric_power, available_nominal_power) * cop`` for heat
    pumps, ``min(...) * efficiency`` for heaters (``energy_model.py:252-281,
    378-401``). ``available_nominal_power`` = ``nominal_power -
    electricity_consumption[t]`` accrued earlier in this step
    (``energy_model.py:121-124``). ``max_electric_power`` is +inf when
    there is no power outage."""
    limit = torch.minimum(max_electric_power, dev.nominal_power - consumed_so_far)
    return torch.where(dev.is_heat_pump,
                       limit * heat_pump_cop(dev, outdoor_t, heating),
                       limit * dev.efficiency)
