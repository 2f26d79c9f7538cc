"""K1: whole-episode battery+PV rollout of a district batch.

:func:`battery_episode` replaces ``citylearn_tpu/ops/pallas_battery.py::
battery_episode``. On CUDA tensors it launches the hand-written kernels of
``csrc/battery_episode.cu`` in one launch call: a prelude writes the
per-step rows every district reads (the energy request, the non-shiftable
load's term, solar, price and carbon) building-major into a scratch, then
a district pass runs the S-step recurrence, a block per (district tile,
building) with the building's battery knots and the staged rows in shared
memory and a thread per district with its state in registers. The kernel
is bound by the latency of each step's dependent chain of curve lookups,
divisions and square roots, not by bytes (a few MB in all) nor by fp32
throughput; a step runs its divisions and square roots without the branch
to a slow path that nvcc puts around each, and is redone with IEEE
operations when an operand leaves their fast range, so the bits are
IEEE's either way. On CPU tensors the wrapper runs
:func:`battery_episode_reference`, the plain PyTorch version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel against.

Layout at the public function follows the JAX kernel's, minus its TPU
padding: the plan and series are (S, B), ``bparams`` the same (8, B)
rows, curves knot-major (n_knots, B), state (D, B); any D >= 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.ops import _build

ZERO = 1e-6       # reference citylearn/data.py:19
MAX_KNOTS = 12    # csrc/battery_common.cuh MAX_KNOTS (compiler/spec.CURVE_PAD)
N_REC = 3         # recorded series rows: net, battery balance, battery soc
# the district pass stages its per-step rows in chunks of this many steps
# (csrc/battery_episode.cu CHUNK, N_STAGE)
STAGE_CHUNK, N_STAGE = 128, 5


def operation_count(actions: torch.Tensor, n_knots: int, n_districts: int,
                    request_once: bool = False) -> int:
    """fp32 operations (add, sub, mul, div, sqrt, min, max, abs, compare)
    the kernel executes for this plan: per building-step, two curve
    lookups of ``n_knots`` compares and 6 arithmetic operations each, plus
    42 other operations on a charging step (action >= 0) or 47 on a
    discharging one. With ``request_once`` the energy request's two
    multiplications (``action * nominal * hours_ratio``) are counted once
    per building-step, not per district: K1's and K3's preludes compute it
    for every district."""
    lookups = 2 * (n_knots + 6)
    charging = int((actions >= 0).sum())
    steps = actions.numel()
    request = 2 * steps
    count = n_districts * (steps * (42 + lookups) + 5 * (steps - charging))
    return count - (n_districts - 1) * request if request_once else count


def _interp(q: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Reference curve lookup on (D, B) queries and knot-major (K, B)
    curves: ``idx = max(0, count(x < q) - 1)``, no match -> segment 0."""
    n = xs.shape[0]
    first = (xs[:, None, :] < q[None]).sum(0)
    idx = torch.where(first >= n, torch.zeros_like(first), torch.clamp(first - 1, min=0))
    take = lambda a, i: torch.gather(a.t().expand(q.shape + (n,)), -1, i[..., None])[..., 0]
    x0, x1 = take(xs, idx), take(xs, idx + 1)
    y0, y1 = take(ys, idx), take(ys, idx + 1)
    return y0 + (q - x0) * (y1 - y0) / (x1 - x0)


def battery_event(bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                  soc: torch.Tensor, eff: torch.Tensor, deg: torch.Tensor,
                  action: torch.Tensor, hours_ratio: float, ratio: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One battery event of a (D, B) batch under ``action`` ((B,) or
    (D, B)): the request ``action * nominal * hours_ratio``, in that order,
    then the event, rounding every operation as ``csrc/battery_common.cuh``'s
    ``battery::event`` does. Returns (soc, efficiency, degraded capacity,
    energy balance) after the event."""
    return battery_event_energy(bparams, curves, soc, eff, deg,
                                action * bparams[1] * hours_ratio, ratio)


def battery_event_energy(bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                         soc: torch.Tensor, eff: torch.Tensor, deg: torch.Tensor,
                         energy: torch.Tensor, ratio: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`battery_event` for a requested ``energy`` in kWh
    (``csrc/battery_common.cuh``'s ``event``)."""
    pec_x, pec_y, cpc_x, cpc_y = curves
    cap, nominal = bparams[0], bparams[1]
    keep = 1.0 - bparams[2]
    soc_floor = 1.0 - bparams[4]
    clc = bparams[5]
    cap_safe = torch.clamp(cap, min=ZERO)
    nominal_safe = torch.clamp(nominal, min=ZERO)
    energy_init = torch.clamp(soc * cap * keep, min=0.0)
    max_power = nominal * _interp(energy_init / cap_safe, cpc_x, cpc_y)

    charging = energy >= 0.0
    e_chg = torch.minimum(torch.minimum(max_power, nominal.expand_as(max_power)),
                          torch.minimum(deg - energy_init, energy))
    eff_chg = _interp(torch.abs(torch.minimum(energy, max_power)) / nominal_safe,
                      pec_x, pec_y)
    e_dod = -torch.clamp((soc - soc_floor) * cap * torch.sqrt(eff), min=0.0)
    e_dis = torch.maximum(torch.maximum(-max_power, e_dod), energy)
    eff_dis = _interp(torch.minimum(torch.abs(energy), max_power) / nominal_safe,
                      pec_x, pec_y)
    e = torch.where(charging, e_chg, e_dis)
    new_eff = torch.where(charging, eff_chg, eff_dis)
    rt = torch.sqrt(new_eff)
    fin = torch.where(e >= 0.0, torch.minimum(energy_init + e * rt, cap.expand_as(e)),
                      torch.clamp(energy_init + e / rt, min=0.0))
    new_soc = fin / cap_safe
    delta = fin - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)
    new_deg = torch.clamp(
        deg - (clc * cap * torch.abs(balance) / (2.0 * torch.clamp(deg, min=ZERO))) * ratio,
        min=0.0)
    return new_soc, new_eff, new_deg, balance


def battery_episode_reference(actions: torch.Tensor, series: Sequence[torch.Tensor],
                              bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                              soc0: torch.Tensor, eff0: torch.Tensor, deg0: torch.Tensor,
                              hours_ratio: float, ratio: float,
                              record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`battery_episode`: a loop over the S
    steps on (D, B) tensors, rounding every operation as the kernel does."""
    nsl, solar, price, carbon = series
    soc, eff, deg = soc0, eff0, deg0
    rew = torch.zeros_like(soc0)
    cost = torch.zeros_like(soc0)
    emis = torch.zeros_like(soc0)
    rec = []
    for t in range(actions.shape[0]):
        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, actions[t],
                                               hours_ratio, ratio)
        # net accounting with the t == 0 triple/double count
        nsl_term = 3.0 * nsl[t] if t == 0 else nsl[t]
        bat_term = 2.0 * balance if t == 0 else balance
        net = nsl_term + bat_term - solar[t]
        if record:
            rec.append(torch.stack([net[0], balance[0], soc[0]]))
        rew = rew - torch.clamp(net, min=0.0)
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
    out = (rew, cost, emis, soc, eff, deg)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("battery_episode").battery_episode_launch
    fn.argtypes = [_PTR] * 21 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


@tracing.traced("battery_episode")
def battery_episode(actions: torch.Tensor, series: Sequence[torch.Tensor],
                    bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                    soc0: torch.Tensor, eff0: torch.Tensor, deg0: torch.Tensor,
                    hours_ratio: float, ratio: float,
                    record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a full S-step episode for a (D, B) district batch.

    ``actions``: (S, B) open-loop plan shared by the districts;
    ``series``: (nsl, solar, price, carbon), each (S, B) float32;
    ``bparams``: (8, B) rows capacity, nominal_power, loss_coefficient,
    initial_soc, depth_of_discharge, capacity_loss_coefficient (the last
    two rows unused); ``curves``: (pec_x, pec_y, cpc_x, cpc_y), each
    knot-major (n_knots, B) with 2 <= n_knots <= 12; state ``soc0``,
    ``eff0``, ``deg0``: (D, B). Returns (reward_sum, cost_sum,
    emission_sum, soc, eff, degraded) each (D, B) and, with
    ``record=True``, an (N_REC, S, B) per-step stream of district 0's
    (net, raw battery balance, soc).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    if soc0.device.type == "cpu":
        return battery_episode_reference(actions, series, bparams, curves, soc0,
                                         eff0, deg0, hours_ratio, ratio, record)
    if soc0.device.type != "cuda":
        raise ValueError(f"battery_episode runs on CPU or CUDA tensors, not {soc0.device}")
    S, B = actions.shape
    D = soc0.shape[0]
    n_knots = curves[0].shape[0]
    inputs = [actions, *series, bparams, *curves, soc0, eff0, deg0]
    shapes = [(S, B)] * 5 + [(8, B)] + [(n_knots, B)] * 4 + [(D, B)] * 3
    for x, shape in zip(inputs, shapes):
        if x.device != soc0.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"battery_episode wants contiguous float32 {shape} on "
                             f"{soc0.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 2 <= n_knots <= MAX_KNOTS:
        raise ValueError(f"battery_episode takes 2 to {MAX_KNOTS} curve knots, got {n_knots}")
    outs = [torch.empty((D, B), dtype=torch.float32, device=soc0.device) for _ in range(6)]
    rec = (torch.empty((N_REC, S, B), dtype=torch.float32, device=soc0.device)
           if record else None)
    s_pad = -(-S // STAGE_CHUNK) * STAGE_CHUNK
    stage = torch.empty((B, N_STAGE, s_pad), dtype=torch.float32, device=soc0.device)
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(soc0.device):
        stream = torch.cuda.current_stream(soc0.device).cuda_stream
        err = _launcher()(*[x.data_ptr() for x in inputs + outs],
                          None if rec is None else rec.data_ptr(), stage.data_ptr(),
                          D, B, S, s_pad, n_knots, hours_ratio, ratio, stream)
    if err != 0:
        raise RuntimeError(f"battery_episode kernel launch failed: CUDA error {err}")
    battery_episode.launches += 1
    return tuple(outs) + ((rec,) if record else ())


battery_episode.launches = 0
