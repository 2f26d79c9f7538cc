"""KPI / cost functions (reference ``citylearn/cost_function.py``) as
tensor reductions over the leading time axis of ``(T, ...)`` series —
the counterparts of the JAX package's in-graph ``*_jnp`` versions.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max ignoring NaN; NaN where every value is NaN (``jnp.nanmax``)."""
    nan = torch.isnan(x)
    mx = torch.where(nan, torch.full_like(x, -torch.inf), x).amax(dim)
    return torch.where(nan.all(dim), torch.full_like(mx, torch.nan), mx)


def _grouped(x: torch.Tensor, window: int, fill: float) -> torch.Tensor:
    """(T, ...) -> (ceil(T / window), window, ...), the ragged tail
    filled with ``fill``."""
    T = x.shape[0]
    n_groups = -(-T // window)
    pad = n_groups * window - T
    x = F.pad(x.movedim(0, -1), (0, pad), value=fill).movedim(-1, 0)
    return x.reshape((n_groups, window) + x.shape[1:])


def ramping(net: torch.Tensor) -> torch.Tensor:
    d = torch.clamp(torch.diff(net, dim=0), min=0.0)
    return torch.sum(d, dim=0)


def one_minus_load_factor(net: torch.Tensor, window: int) -> torch.Tensor:
    x = _grouped(net, window, torch.nan)
    mean = torch.nanmean(x, dim=1)
    mx = _nanmax(x, dim=1)
    return torch.nanmean(1.0 - mean / mx, dim=0)


def peak(net: torch.Tensor, window: int) -> torch.Tensor:
    x = _grouped(net, window, -torch.inf)
    return torch.mean(x.amax(dim=1), dim=0)


def electricity_consumption(net: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(net, min=0.0), dim=0)


def zero_net_energy(net: torch.Tensor) -> torch.Tensor:
    return torch.sum(net, dim=0)


def carbon_emissions(emission: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(emission, min=0.0), dim=0)


def cost(cost: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(cost, min=0.0), dim=0)


def discomfort(indoor_t: torch.Tensor, cooling_set_point: torch.Tensor,
               heating_set_point: torch.Tensor, band: torch.Tensor,
               occupant_count: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``CostFunction.discomfort`` final values (reference
    ``cost_function.py:224-321``) over ``(T, ...)`` series: (unmet, cold,
    hot, cold_min, cold_max, cold_avg, hot_min, hot_max, hot_avg).
    Unoccupied steps zero the deltas; zero occupied steps -> NaN
    proportions, like the pandas division by a zero count."""
    occ = occupant_count
    zero = torch.zeros_like(indoor_t)
    cooling_delta = torch.where(occ == 0.0, zero, indoor_t - cooling_set_point)
    heating_delta = torch.where(occ == 0.0, zero, indoor_t - heating_set_point)
    hot = cooling_delta > band
    cold = heating_delta < -band
    unmet = hot | cold
    occupied = torch.sum(occ > 0.0, dim=0).to(indoor_t.dtype)
    denom = torch.where(occupied > 0, occupied, torch.full_like(occupied, torch.nan))
    cold_d = torch.abs(torch.clamp(heating_delta, max=0.0))
    hot_d = torch.abs(torch.clamp(cooling_delta, min=0.0))
    count = lambda m: torch.sum(m, dim=0).to(indoor_t.dtype)
    return (count(unmet) / denom, count(cold) / denom, count(hot) / denom,
            cold_d.amin(dim=0), cold_d.amax(dim=0), cold_d.mean(dim=0),
            hot_d.amin(dim=0), hot_d.amax(dim=0), hot_d.mean(dim=0))


def one_minus_thermal_resilience(power_outage: torch.Tensor,
                                 indoor_t: torch.Tensor,
                                 cooling_set_point: torch.Tensor,
                                 heating_set_point: torch.Tensor,
                                 band: torch.Tensor,
                                 occupant_count: torch.Tensor) -> torch.Tensor:
    """Discomfort proportion restricted to outage steps (reference
    ``cost_function.py:324-353``: occupant count zeroed where no outage)."""
    occ = torch.where(power_outage == 0.0, torch.zeros_like(occupant_count),
                      occupant_count)
    return discomfort(indoor_t, cooling_set_point, heating_set_point,
                      band, occ)[0]


def normalized_unserved_energy(expected: torch.Tensor, served: torch.Tensor,
                               power_outage: torch.Tensor = None) -> torch.Tensor:
    """Reference ``cost_function.py:356-388``: unmet/expected over outage
    steps (all steps when no signal given); 0/0 -> NaN like pandas."""
    if power_outage is None:
        power_outage = torch.ones_like(expected)
    zero = torch.zeros_like(expected)
    unserved = torch.where(power_outage == 0.0, zero, expected - served)
    e = torch.where(power_outage == 0.0, zero, expected)
    return torch.sum(unserved, dim=0) / torch.sum(e, dim=0)
