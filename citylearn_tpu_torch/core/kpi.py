"""KPI / cost functions (reference ``citylearn/cost_function.py``).

Two implementations share the same math:
  - tensor reductions over the leading time axis of ``(T, ...)`` series,
    the counterparts of the JAX package's in-graph ``*_jnp`` versions
    (used by the batched evaluator);
  - numpy final-value versions (host-side, used by the Gym env's
    ``evaluate()``) that reproduce the pandas rolling/groupby semantics
    including NaN handling, the same code as the JAX package's ``*_np``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


# ----------------------------------------------------------------------
# numpy (exact pandas-equivalent) final values
# ----------------------------------------------------------------------

def ramping_np(net: np.ndarray, down_ramp: bool = False, net_export: bool = True) -> float:
    """Reference ``cost_function.py:10-59`` final rolling value."""
    d = np.diff(np.asarray(net, dtype=np.float64))
    d = np.abs(d) if down_ramp else np.clip(d, 0.0, None)
    if not net_export:
        d = np.where(np.asarray(net[1:], dtype=np.float64) < 0, 0.0, d)
    return float(np.nansum(d))


def one_minus_load_factor_np(net: np.ndarray, window: int = 730) -> float:
    """Reference ``cost_function.py:61-86``: per-``window`` group
    ``1 - mean/max``, then mean over groups (NaN groups skipped, as pandas
    rolling mean does)."""
    net = np.asarray(net, dtype=np.float64)
    n = len(net)
    groups = np.arange(n) // window
    vals = []
    for g in range(groups[-1] + 1 if n else 0):
        seg = net[groups == g]
        mx = seg.max()
        with np.errstate(divide="ignore", invalid="ignore"):
            vals.append(1.0 - seg.mean() / mx)
    vals = np.asarray(vals, dtype=np.float64)
    return float(np.nanmean(vals)) if len(vals) else float("nan")


def peak_np(net: np.ndarray, window: int = 24) -> float:
    """Reference ``cost_function.py:88-111``: mean of per-window maxima."""
    net = np.asarray(net, dtype=np.float64)
    n = len(net)
    groups = np.arange(n) // window
    vals = [net[groups == g].max() for g in range(groups[-1] + 1 if n else 0)]
    return float(np.mean(vals)) if vals else float("nan")


def electricity_consumption_np(net: np.ndarray) -> float:
    return float(np.clip(np.asarray(net, np.float64), 0, None).sum())


def zero_net_energy_np(net: np.ndarray) -> float:
    return float(np.asarray(net, np.float64).sum())


def carbon_emissions_np(emission: np.ndarray) -> float:
    return float(np.clip(np.asarray(emission, np.float64), 0, None).sum())


def cost_np(cost: np.ndarray) -> float:
    return float(np.clip(np.asarray(cost, np.float64), 0, None).sum())


def quadratic_np(net: np.ndarray) -> float:
    c = np.clip(np.asarray(net, np.float64), 0, None)
    return float((c ** 2).sum())


def discomfort_np(indoor_t, cooling_set_point, heating_set_point, band,
                  occupant_count=None) -> Tuple[float, ...]:
    """Reference ``cost_function.py:224-321`` final values:
    (unmet, cold, hot, cold_min_delta, cold_max_delta, cold_avg_delta,
    hot_min_delta, hot_max_delta, hot_avg_delta)."""
    t = np.asarray(indoor_t, np.float64)
    csp = np.asarray(cooling_set_point, np.float64)
    hsp = np.asarray(heating_set_point, np.float64)
    band = np.broadcast_to(np.asarray(band, np.float64), t.shape)
    occ = np.ones_like(t) if occupant_count is None else np.asarray(occupant_count, np.float64)
    occupied = float((occ > 0.0).sum())
    cooling_delta = np.where(occ == 0.0, 0.0, t - csp)
    heating_delta = np.where(occ == 0.0, 0.0, t - hsp)
    hot = cooling_delta > band
    cold = heating_delta < -band
    unmet = hot | cold
    denom = occupied if occupied > 0 else np.nan
    cold_d = np.abs(np.clip(heating_delta, None, 0.0))
    hot_d = np.abs(np.clip(cooling_delta, 0.0, None))
    return (
        float(unmet.sum() / denom), float(cold.sum() / denom), float(hot.sum() / denom),
        float(cold_d.min()), float(cold_d.max()), float(cold_d.mean()),
        float(hot_d.min()), float(hot_d.max()), float(hot_d.mean()),
    )


def one_minus_thermal_resilience_np(power_outage, **discomfort_kwargs) -> float:
    """Reference ``cost_function.py:324-353``: discomfort restricted to
    outage time steps by zeroing occupant count elsewhere."""
    po = np.asarray(power_outage, np.float64)
    occ = discomfort_kwargs.get("occupant_count")
    occ = (np.ones_like(po) if occ is None else np.asarray(occ, np.float64)).copy()
    occ[po == 0.0] = 0.0
    discomfort_kwargs = dict(discomfort_kwargs)
    discomfort_kwargs["occupant_count"] = occ
    return discomfort_np(**discomfort_kwargs)[0]


def normalized_unserved_energy_np(expected, served, power_outage=None) -> float:
    """Reference ``cost_function.py:356-388``."""
    e = np.asarray(expected, np.float64).copy()
    s = np.asarray(served, np.float64).copy()
    po = np.ones_like(e) if power_outage is None else np.asarray(power_outage, np.float64)
    unserved = e - s
    unserved[po == 0] = 0.0
    e = e.copy()
    e[po == 0] = 0.0
    total_expected = e.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(unserved.sum() / total_expected)


def safe_div(control: float, baseline: float) -> Optional[float]:
    """Reference ``citylearn.py:1172-1189``: non-finite -> 0; 0/0 -> 1;
    x/0 -> None."""
    def coerce(x):
        try:
            v = float(x)
            return v if np.isfinite(v) else 0.0
        except Exception:
            return 0.0
    c, b = coerce(control), coerce(baseline)
    if b == 0.0:
        return 1.0 if c == 0.0 else None
    return c / b
