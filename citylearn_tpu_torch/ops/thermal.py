"""K3: whole-episode rollout of a thermal-storage district batch.

:func:`thermal_episode` replaces ``citylearn_tpu/ops/pallas_thermal.py::
thermal_episode``: cooling and DHW end uses (heat pump or electric
heater plus a storage tank each), the battery and PV, under three shared
open-loop plans — the full no-outage district step fused over the
episode. On CUDA tensors it launches the hand-written kernels of
``csrc/thermal_episode.cu`` in one launch call: a prelude computes once
per (step, building) what every district shares under open-loop plans
(the COPs, the reset-time consumptions, each end use's request and, on a
charging step, its device side), then a district pass runs the two tank
events, the battery, the net and the sums, a block per (district tile,
building) with its building's battery knots and the staged per-step rows
in shared memory. The kernel is bound by the latency of each step's
dependent chain (the battery event beside the two tank events), not by
bytes nor by fp32 throughput; as in K1, a step runs its divisions and
square roots without nvcc's branch to a slow path and is redone with IEEE
operations when an operand leaves their fast range. On CPU tensors the wrapper runs
:func:`thermal_episode_reference`, the plain PyTorch version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel against;
:func:`thermal_prelude_reference` and :func:`thermal_district_reference`
are the plain versions of the two halves, whose composition the tests
hold bit-equal to it.

Layout at the public function follows the JAX kernel's, minus its TPU
padding: plans and series are (S, B), ``bparams`` (8, B), curves
knot-major (n_knots, B), ``tparams`` (N_TROWS, B), state (D, B); any
D >= 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as _battery
from citylearn_tpu_torch.ops.battery import MAX_KNOTS, ZERO, battery_event, battery_event_energy

# thermal parameter rows (core/rollout_fast.thermal_episode_inputs packs
# them; csrc/thermal_common.cuh's Row)
(CN, CE, CTC, CHP,              # cooling device: nominal power, efficiency, target, is heat pump
 DN, DE, DTH, DHP,              # dhw device
 CT_CAP, CT_RT, CT_LOSS, CT_MI, CT_MO, CT_CONV,   # cooling tank
 DT_CAP, DT_RT, DT_LOSS, DT_MI, DT_MO, DT_CONV,   # dhw tank
 N_TROWS) = range(21)

# recorded per-step series rows (record=True)
(R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT,
 N_TREC) = range(10)
# the district pass stages its per-step rows in chunks of this many steps
# (csrc/thermal_episode.cu CHUNK, N_STAGE)
STAGE_CHUNK, N_STAGE = 128, 16


def operation_count(actions: Sequence[torch.Tensor], n_knots: int, n_districts: int) -> int:
    """fp32 operations (add, sub, mul, div, sqrt, min, max, abs, negate,
    compare) the kernel executes for these plans. Per district and
    building-step: the battery event and the sums
    (:func:`ops.battery.operation_count` with the energy request counted
    once), K1's two net operations, 14 for the update-time consumptions,
    the totals, the battery's t == 0 term and the net's other two terms,
    and per end use 12 for the tank event and the consumption when it
    charges or idles (action >= 0) or 21 when it discharges. Once per
    building-step, in the prelude that every district shares: 14 for the
    two COPs, 4 for the reset-time consumptions, 3 for the non-shiftable
    load's term, and per end use 18 for the request, the device side and
    the tank's clamp when it charges or idles or 11 when it discharges."""
    a_cool, a_dhw, a_bat = actions
    steps = a_bat.numel()
    discharging = int((a_cool < 0).sum()) + int((a_dhw < 0).sum())
    district = steps * (14 + 2 * 12) + 9 * discharging
    prelude = steps * (14 + 4 + 3 + 2 * 18) - 7 * discharging
    return (_battery.operation_count(a_bat, n_knots, n_districts, request_once=True)
            + n_districts * district + prelude)


def _cop(tparams: torch.Tensor, dev_off: int, outdoor: torch.Tensor,
         heating: bool) -> torch.Tensor:
    """Carnot COP for heat pumps, constant efficiency for heaters
    (``energy_model.py:216-250``; the is-heat-pump row selects)."""
    eff = tparams[dev_off + 1]
    target = tparams[dev_off + 2]
    denom = target - outdoor if heating else outdoor - target
    cop = eff * (target + 273.15) / denom
    twenty = torch.full_like(cop, 20.0)
    cop = torch.where(cop < 0, twenty, cop)
    cop = torch.where(cop > 20, twenty, cop)
    cop = torch.where(torch.isnan(cop), twenty, cop)
    return torch.where(tparams[dev_off + 3] > 0.5, cop, eff)


def _tank(tparams: torch.Tensor, off: int, soc: torch.Tensor, energy: torch.Tensor,
          ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """StorageTank charge event (``energy_model.py:603-871`` with the env's
    pre-divide). Returns (soc', balance)."""
    cap, rt, loss, max_in, max_out = (tparams[off + k] for k in range(5))
    e = torch.where(energy >= 0.0, torch.minimum(energy, max_in),
                    torch.maximum(-max_out, energy))
    e = e * ratio
    energy_init = torch.clamp(soc * cap * (1.0 - loss), min=0.0)
    final = torch.where(e >= 0.0,
                        torch.minimum(energy_init + e * rt, cap),
                        torch.clamp(energy_init + e / rt, min=0.0))
    new_soc = final / torch.clamp(cap, min=ZERO)
    delta = final - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)
    return new_soc, balance


def flexibility(outage: torch.Tensor, solar: torch.Tensor, accum: torch.Tensor) -> torch.Tensor:
    """``downward_electrical_flexibility`` (reference ``building.py:640-668``):
    under an outage the solar generation left after the consumption booked
    so far, +inf otherwise."""
    cap = torch.clamp(solar - accum, min=0.0)
    return torch.where(outage > 0.0, cap, torch.full_like(cap, torch.inf))


def _thermal_block(tparams: torch.Tensor, dev_off: int, tank_off: int, conv_row: int,
                   soc: torch.Tensor, demand: torch.Tensor, action: torch.Tensor,
                   cop: torch.Tensor, dev_init: torch.Tensor, hours_mul: float,
                   ratio: float, outage: Optional[torch.Tensor] = None,
                   solar: Optional[torch.Tensor] = None,
                   cons_accum: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """One end use, both priority orders, selected by the action's sign
    (the stepped ``core/step._thermal_block``). Without ``outage`` the
    electrical flexibility is +inf and the blocks decouple; with it the
    device's electric power is capped by ``max(0, solar - cons_accum)``
    during an outage, ``cons_accum`` being the district-level consumption
    booked before this block. Returns (soc', balance, device_output,
    apply_consumption)."""
    nominal = tparams[dev_off]
    energy_req = action * tparams[conv_row] * hours_mul
    if outage is None:
        max_out = lambda booked, extra: (nominal - booked) * cop
    else:
        max_out = lambda booked, extra: torch.minimum(
            flexibility(outage, solar, cons_accum + extra), nominal - booked) * cop
    zero = torch.zeros_like(dev_init)

    # variant A: device first, then storage charge
    out_A = torch.minimum(demand, max_out(dev_init, zero))
    cons_dev_A = torch.clamp(out_A / cop, min=0.0)
    charge_A = torch.minimum(max_out(dev_init + cons_dev_A, cons_dev_A), energy_req)
    soc_A, bal_A = _tank(tparams, tank_off, soc, charge_A / ratio, ratio)
    cons_store_A = torch.clamp(bal_A, min=0.0) / cop

    # variant B: storage discharge first, then device
    discharge_B = torch.maximum(-demand, energy_req)
    soc_B, bal_B = _tank(tparams, tank_off, soc, discharge_B / ratio, ratio)
    cons_store_B = torch.clamp(bal_B, min=0.0) / cop     # 0 for a true discharge
    storage_out_B = -torch.clamp(bal_B, max=0.0)
    out_B = torch.minimum(demand - storage_out_B,
                          max_out(dev_init + cons_store_B, cons_store_B))
    cons_dev_B = torch.clamp(out_B / cop, min=0.0)

    pick = lambda a, b: torch.where(action < 0.0, b, a)
    return (pick(soc_A, soc_B), pick(bal_A, bal_B),
            pick(out_A, out_B).expand_as(soc),
            pick(cons_dev_A + cons_store_A, cons_dev_B + cons_store_B))


def thermal_episode_reference(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                              bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                              tparams: torch.Tensor, csoc0: torch.Tensor,
                              dsoc0: torch.Tensor, soc0: torch.Tensor, eff0: torch.Tensor,
                              deg0: torch.Tensor, hours_ratio: float, ratio: float,
                              record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`thermal_episode`: a loop over the S
    steps on (D, B) tensors, rounding every operation as the kernel does."""
    a_cool, a_dhw, a_bat = actions
    nsl, solar, price, carbon, cool_demand, dhw_demand, outdoor = series
    csoc, dsoc, soc, eff, deg = csoc0, dsoc0, soc0, eff0, deg0
    rew = torch.zeros_like(soc0)
    cost = torch.zeros_like(soc0)
    emis = torch.zeros_like(soc0)
    rec = []
    for t in range(a_bat.shape[0]):
        t0f = 1.0 if t == 0 else 0.0
        cop_c = _cop(tparams, CN, outdoor[t], False)
        cop_d = _cop(tparams, DN, outdoor[t], True)
        # reset-time update_variables consumptions, booked at t == 0
        reset_cool = cool_demand[t] / cop_c
        reset_dhw = dhw_demand[t] / cop_d

        # cooling takes no hours ratio, DHW does
        csoc, cbal, cout, ccons = _thermal_block(
            tparams, CN, CT_CAP, CT_CONV, csoc, cool_demand[t], a_cool[t], cop_c,
            t0f * reset_cool, 1.0, ratio)
        dsoc, dbal, dout, dcons = _thermal_block(
            tparams, DN, DT_CAP, DT_CONV, dsoc, dhw_demand[t], a_dhw[t], cop_d,
            t0f * reset_dhw, hours_ratio, ratio)
        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, a_bat[t],
                                               hours_ratio, ratio)

        # update_variables accounting with the t == 0 multi-count
        uv_cool = (cout + cbal) / cop_c
        uv_dhw = (dout + dbal) / cop_d
        cool_total = ccons + t0f * (reset_cool + uv_cool)
        dhw_total = dcons + t0f * (reset_dhw + uv_dhw)
        nsl_term = nsl[t] + t0f * 2.0 * nsl[t]
        bat_term = balance + t0f * balance
        net = cool_total + dhw_total + nsl_term + bat_term - solar[t]
        if record:
            rec.append(torch.stack([net[0], cbal[0], dbal[0], balance[0], csoc[0], dsoc[0],
                                    soc[0], cout[0], dout[0]]))
        rew = rew - torch.clamp(net, min=0.0)
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
    out = (rew, cost, emis, csoc, dsoc, soc, eff, deg)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


# the prelude's rows per end use (thermal_prelude_reference; the kernel's
# scratch rows ST_C_STEP ... ST_C_RESET and its flag bits)
END_USE_ROWS = ("step", "a", "b", "cop", "reset", "charge", "up")


def _request(tparams: torch.Tensor, dev_off: int, tank_off: int, conv_row: int,
             demand: torch.Tensor, action: torch.Tensor, cop: torch.Tensor,
             reset: torch.Tensor, t0f: torch.Tensor, hours_mul: float,
             ratio: float) -> dict:
    """The district-independent half of :func:`_thermal_block`
    (``EndUse::request`` in ``csrc/thermal_common.cuh``): the energy
    request, the device side of a charging or idle step and the tank's
    clamp of the request. Returns the rows of ``END_USE_ROWS``:
    the tank's step (``e * rt`` or ``e / rt`` by the sign of its request
    ``e``), ``a`` and ``b`` (charging: the device's output and
    consumption; discharging: the demand and the consumption booked before
    the block), the COP, the reset-time consumption and the two signs."""
    nominal = tparams[dev_off]
    max_in, max_out, rt = tparams[tank_off + 3], tparams[tank_off + 4], tparams[tank_off + 1]
    dev_init = t0f * reset
    energy_req = action * tparams[conv_row] * hours_mul
    charge = ~(action < 0.0)
    out = torch.minimum(demand, (nominal - dev_init) * cop)
    cons_dev = torch.clamp(out / cop, min=0.0)
    charge_e = torch.minimum((nominal - (dev_init + cons_dev)) * cop, energy_req) / ratio
    discharge_e = torch.maximum(-demand, energy_req) / ratio
    energy = torch.where(charge, charge_e, discharge_e)
    e = torch.where(energy >= 0.0, torch.minimum(energy, max_in),
                    torch.maximum(-max_out, energy))
    e = e * ratio
    up = e >= 0.0
    return dict(step=torch.where(up, e * rt, e / rt), a=torch.where(charge, out, demand),
                b=torch.where(charge, cons_dev, dev_init), cop=cop, reset=reset,
                charge=charge, up=up)


def thermal_prelude_reference(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                              bparams: torch.Tensor, tparams: torch.Tensor,
                              hours_ratio: float, ratio: float) -> dict:
    """Plain PyTorch version of the kernel's prelude: what every district
    shares under open-loop plans, for all S steps at once, rounding every
    operation as :func:`thermal_episode_reference` does. Returns (S, B)
    rows: ``cooling`` and ``dhw``, each a dict of ``END_USE_ROWS``
    (:func:`_request`); ``nsl_term``, the non-shiftable load with its
    t == 0 triple count; ``solar``, ``price``, ``carbon``; and ``energy``,
    the battery's request ``a_bat * nominal * hours_ratio``."""
    a_cool, a_dhw, a_bat = actions
    nsl, solar, price, carbon, cool_demand, dhw_demand, outdoor = series
    t0f = (torch.arange(a_bat.shape[0], device=a_bat.device)[:, None] == 0).to(a_bat.dtype)
    cop_c = _cop(tparams, CN, outdoor, False)
    cop_d = _cop(tparams, DN, outdoor, True)
    # cooling takes no hours ratio, DHW does
    cooling = _request(tparams, CN, CT_CAP, CT_CONV, cool_demand, a_cool, cop_c,
                       cool_demand / cop_c, t0f, 1.0, ratio)
    dhw = _request(tparams, DN, DT_CAP, DT_CONV, dhw_demand, a_dhw, cop_d,
                   dhw_demand / cop_d, t0f, hours_ratio, ratio)
    return dict(cooling=cooling, dhw=dhw, nsl_term=nsl + t0f * 2.0 * nsl, solar=solar,
                price=price, carbon=carbon, energy=a_bat * bparams[1] * hours_ratio)


def _serve(tparams: torch.Tensor, dev_off: int, tank_off: int, rows: dict, t: int,
           soc: torch.Tensor, t0f: float) -> Tuple[torch.Tensor, ...]:
    """The district's half of :func:`_thermal_block` at step ``t``
    (``EndUse::serve`` in ``csrc/thermal_common.cuh``): the tank event
    on the prelude's request and what depends on its balance. Returns
    (soc', balance, device_output, total consumption with the t == 0
    multi-count)."""
    nominal = tparams[dev_off]
    cap, rt, loss = tparams[tank_off], tparams[tank_off + 1], tparams[tank_off + 2]
    step, a, b, cop, reset = (rows[k][t] for k in END_USE_ROWS[:5])
    energy_init = torch.clamp(soc * cap * (1.0 - loss), min=0.0)
    final = torch.where(rows["up"][t], torch.minimum(energy_init + step, cap),
                        torch.clamp(energy_init + step, min=0.0))
    new_soc = final / torch.clamp(cap, min=ZERO)
    delta = final - energy_init
    balance = torch.where(delta >= 0.0, delta / rt, delta * rt)
    cons_store = torch.clamp(balance, min=0.0) / cop
    out_dis = torch.minimum(a - (-torch.clamp(balance, max=0.0)),
                            (nominal - (b + cons_store)) * cop)
    charge = rows["charge"][t]
    out = torch.where(charge, a, out_dis)
    cons = torch.where(charge, b + cons_store,
                       torch.clamp(out_dis / cop, min=0.0) + cons_store)
    uv = (out + balance) / cop
    return new_soc, balance, out, cons + t0f * (reset + uv)


def thermal_district_reference(pre: dict, tparams: torch.Tensor, bparams: torch.Tensor,
                               curves: Sequence[torch.Tensor], csoc0: torch.Tensor,
                               dsoc0: torch.Tensor, soc0: torch.Tensor, eff0: torch.Tensor,
                               deg0: torch.Tensor, ratio: float,
                               record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel's district pass: from the rows
    of :func:`thermal_prelude_reference`, the two tank events and what
    depends on their balances, the battery event, ``net = (((cool_total +
    dhw_total) + nsl_term) + bat_term) - solar`` and the sums. Returns
    the outputs of :func:`thermal_episode`."""
    csoc, dsoc, soc, eff, deg = csoc0, dsoc0, soc0, eff0, deg0
    rew, cost, emis = (torch.zeros_like(soc0) for _ in range(3))
    rec = []
    for t in range(pre["energy"].shape[0]):
        t0f = 1.0 if t == 0 else 0.0
        csoc, cbal, cout, cool_total = _serve(tparams, CN, CT_CAP, pre["cooling"], t, csoc, t0f)
        dsoc, dbal, dout, dhw_total = _serve(tparams, DN, DT_CAP, pre["dhw"], t, dsoc, t0f)
        soc, eff, deg, balance = battery_event_energy(bparams, curves, soc, eff, deg,
                                                      pre["energy"][t], ratio)
        bat_term = balance + t0f * balance
        net = cool_total + dhw_total + pre["nsl_term"][t] + bat_term - pre["solar"][t]
        if record:
            row = lambda x: x.expand_as(soc)[0]
            rec.append(torch.stack([row(x) for x in (net, cbal, dbal, balance, csoc, dsoc, soc,
                                                     cout, dout)]))
        rew = rew - torch.clamp(net, min=0.0)
        cost = cost + net * pre["price"][t]
        emis = emis + torch.clamp(net * pre["carbon"][t], min=0.0)
    out = (rew, cost, emis, csoc, dsoc, soc, eff, deg)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("thermal_episode").thermal_episode_launch
    fn.argtypes = [_PTR] * 31 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def thermal_episode(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                    bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                    tparams: torch.Tensor, csoc0: torch.Tensor, dsoc0: torch.Tensor,
                    soc0: torch.Tensor, eff0: torch.Tensor, deg0: torch.Tensor,
                    hours_ratio: float, ratio: float,
                    record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a full S-step episode for a (D, B) thermal district batch.

    ``actions``: (cooling_storage, dhw_storage, electrical_storage) open-loop
    plans, each (S, B), shared by the districts; ``series``: (nsl, solar,
    price, carbon, cooling_demand, dhw_demand, outdoor temperature), each
    (S, B) float32; ``bparams`` and ``curves`` as
    :func:`ops.battery.battery_episode` takes them; ``tparams``:
    (N_TROWS, B) rows named by this module's constants; state ``csoc0``,
    ``dsoc0``, ``soc0``, ``eff0``, ``deg0``: (D, B). Returns (reward_sum,
    cost_sum, emission_sum, cooling_soc, dhw_soc, battery_soc, battery_eff,
    battery_degraded) each (D, B) and, with ``record=True``, an
    (N_TREC, S, B) per-step stream of district 0's (net, cooling, dhw and
    battery balances, the three SOCs, cooling and dhw device outputs).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    if soc0.device.type == "cpu":
        return thermal_episode_reference(actions, series, bparams, curves, tparams, csoc0,
                                         dsoc0, soc0, eff0, deg0, hours_ratio, ratio, record)
    if soc0.device.type != "cuda":
        raise ValueError(f"thermal_episode runs on CPU or CUDA tensors, not {soc0.device}")
    if len(actions) != 3 or len(series) != 7 or len(curves) != 4:
        raise ValueError("thermal_episode takes 3 plans, 7 series and 4 curves")
    S, B = actions[2].shape
    D = soc0.shape[0]
    n_knots = curves[0].shape[0]
    inputs = [*actions, *series, bparams, *curves, tparams, csoc0, dsoc0, soc0, eff0, deg0]
    shapes = [(S, B)] * 10 + [(8, B)] + [(n_knots, B)] * 4 + [(N_TROWS, B)] + [(D, B)] * 5
    for x, shape in zip(inputs, shapes):
        if x.device != soc0.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"thermal_episode wants contiguous float32 {shape} on "
                             f"{soc0.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 2 <= n_knots <= MAX_KNOTS:
        raise ValueError(f"thermal_episode takes 2 to {MAX_KNOTS} curve knots, got {n_knots}")
    outs = [torch.empty((D, B), dtype=torch.float32, device=soc0.device) for _ in range(8)]
    rec = (torch.empty((N_TREC, S, B), dtype=torch.float32, device=soc0.device)
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
        raise RuntimeError(f"thermal_episode kernel launch failed: CUDA error {err}")
    thermal_episode.launches += 1
    return tuple(outs) + ((rec,) if record else ())


thermal_episode.launches = 0
