"""Heat pump / electric heater physics (reference ``energy_model.py:157-451``),
elementwise over ``(D, B)`` batches with ``(B,)`` device parameters.

Parity-mode dtype notes (``parity``): the reference wraps the per-step
np.float32 outdoor temperature in ``np.array`` (``energy_model.py:240``),
producing a 0-d float32 array; weak Python-float parameters then keep the
whole Carnot chain in float32 under NumPy 2 / NEP 50 — the COP numerator is
cast to float32, the ``target - outdoor`` subtraction rounds to float32 and
the division happens in float32. ``available_nominal_power`` subtracts a
float32 consumption store and rounds likewise. The max-output product is
float64 (``np.min([...])`` of a list promotes to np.float64,
``energy_model.py:281``). ``parity=False`` is the identity (the all-float32
path)."""

from __future__ import annotations

import torch

from citylearn_tpu_torch.core.types import HVACParams


def _r32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float32 and kept in its own dtype."""
    return x.float().to(x.dtype)


def heat_pump_cop(hp: HVACParams, outdoor_t: torch.Tensor, heating: bool,
                  parity: bool = False) -> torch.Tensor:
    """Carnot COP clamped to (0, 20] (``energy_model.py:216-250``).

    NaN/inf (division by zero at target == outdoor) follows the reference's
    ``cop[cop < 0] = 20; cop[cop > 20] = 20`` numpy comparisons, where NaN
    compares False and would propagate — non-finite maps to 20 as the
    reference's datasets never hit exact equality in practice.
    """
    target = hp.target_heating_temperature if heating else hp.target_cooling_temperature
    denom = target - outdoor_t if heating else outdoor_t - target
    num = hp.efficiency * (target + 273.15)
    if parity:
        num, denom = _r32(num), _r32(denom)
    cop = num / denom
    if parity:
        cop = _r32(cop)
    twenty = torch.full_like(cop, 20.0)
    cop = torch.where(cop < 0, twenty, cop)
    cop = torch.where(cop > 20, twenty, cop)
    return torch.where(torch.isfinite(cop), cop, twenty)


def device_cop(dev: HVACParams, outdoor_t: torch.Tensor, heating: bool,
               parity: bool = False) -> torch.Tensor:
    """COP for heat pumps, static efficiency passthrough for heaters."""
    return torch.where(dev.is_heat_pump, heat_pump_cop(dev, outdoor_t, heating, parity),
                       dev.efficiency)


def input_power(dev: HVACParams, output: torch.Tensor, outdoor_t: torch.Tensor,
                heating: bool, parity: bool = False, round_result: bool = True) -> torch.Tensor:
    """Electric input for thermal ``output`` (``energy_model.py:283-307,403-423``).

    ``round_result=False`` keeps the division unrounded in parity mode —
    the reference's division dtype follows the OBJECT dtype of ``output``
    (a float64 ``get_max_output_power`` product stays float64 end to end;
    a float32 demand-series value makes it float32). Callers that know
    which object won a ``min()`` select per value."""
    res = torch.where(dev.is_heat_pump,
                      output / heat_pump_cop(dev, outdoor_t, heating, parity),
                      output / dev.efficiency)
    # the reference's output operand is float32 in the common paths (demand
    # series / float32 consumption stores), making the division float32
    return _r32(res) if (parity and round_result) else res


def max_output_power(dev: HVACParams, outdoor_t: torch.Tensor, heating: bool,
                     max_electric_power: torch.Tensor, consumed_so_far: torch.Tensor,
                     parity: bool = False) -> torch.Tensor:
    """``min(max_electric_power, available_nominal_power) * cop`` for heat
    pumps, ``min(...) * efficiency`` for heaters (``energy_model.py:252-281,
    378-401``). ``available_nominal_power`` = ``nominal_power -
    electricity_consumption[t]`` accrued earlier in this step
    (``energy_model.py:121-124``). ``max_electric_power`` is +inf when
    there is no power outage."""
    available = dev.nominal_power - consumed_so_far
    if parity:
        # py-float nominal minus a float32 consumption store rounds to f32
        available = _r32(available)
    limit = torch.minimum(max_electric_power, available)
    # the product stays float64 in the reference (np.min list -> np.float64)
    return torch.where(dev.is_heat_pump,
                       limit * heat_pump_cop(dev, outdoor_t, heating, parity),
                       limit * dev.efficiency)
