"""K6: whole-episode rollout of a neighborhood district batch.

:func:`neighborhood_episode` replaces ``citylearn_tpu/ops/pallas_neighborhood.py::
neighborhood_episode``: the per-district physics of the EULP county
neighborhoods and the quebec occupant sets — partial-load cooling and
heating demand from the signed ``cooling_or_heating_device`` action or the
``cooling_device`` / ``heating_device`` actions, device-only dispatch of
the three end uses (every tank of the family is inert, so the DHW tank
only loses charge by its standby loss), the battery, the net consumption
and the sums of the default reward, cost and emission — under four shared
open-loop plans. The LSTM temperature and the occupant interaction are
not part of it: under open-loop plans they are the same for every
district and run once, after the launch, in the post-pass of
:mod:`citylearn_tpu_torch.ops.postpass`.

On CUDA tensors it launches the hand-written kernels of
``csrc/neighborhood_episode.cu`` in one launch call: a prelude computes
once per (step, building) what every district shares under open-loop plans
(the COPs, the partial loads, the three end uses and their consumptions),
then a district pass runs the battery, the DHW tank's decay, the net and
the sums, a block per (district tile, building) with its building's
battery knots and the staged per-step rows in shared memory. On CPU
tensors the wrapper runs :func:`neighborhood_episode_reference`, the plain
PyTorch version of the same function, which the tests and
``chip_smoke.py`` hold the kernel against;
:func:`neighborhood_prelude_reference` and
:func:`neighborhood_district_reference` are the plain versions of the two
halves, whose composition the tests hold bit-equal to it.

Layout at the public function follows the JAX kernel's without its TPU
padding: plans and series are (S, B), ``bparams`` (8, B), curves
knot-major (n_knots, B), ``nparams`` (N_NROWS, B), state (D, B); any
D >= 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as _battery
from citylearn_tpu_torch.ops.battery import MAX_KNOTS, ZERO, battery_event
from citylearn_tpu_torch.ops.thermal import _cop

# neighborhood parameter rows (nparams, (N_NROWS, B)); device rows are
# (nominal, efficiency, target temperature, is heat pump), the layout
# ops/thermal._cop reads
(CN, CE, CTC, CHP,            # cooling device
 HN, HE, HTH, HHP,            # heating device
 DN, DE, DTH, DHP,            # dhw device
 DT_CAP, DT_LOSS,             # dhw tank (standby-loss decay only)
 COOL_ACT, HEAT_ACT, COH_ACT,  # partial-load action availability
 N_NROWS) = range(18)

# recorded per-step series rows (record=True): the district pass writes the
# first N_DISTRICT_REC, the prelude the rest
(R_NET, R_BBAL, R_BSOC, R_DSOC, R_COUT, R_HOUT, R_DOUT, R_CDEM, R_HDEM,
 N_NREC) = range(10)
N_DISTRICT_REC = R_COUT
# the district pass stages its per-step rows in chunks of this many steps
# (csrc/neighborhood_episode.cu CHUNK, N_STAGE)
STAGE_CHUNK, N_STAGE = 128, 5


def operation_count(actions: Sequence[torch.Tensor], n_knots: int, n_districts: int) -> int:
    """fp32 operations (add, sub, mul, div, min, max, abs, compare) the
    kernel executes for these plans. Per district and building-step: the
    battery event and the sums (:func:`ops.battery.operation_count`, whose
    net counts two terms) and 5 for the DHW tank's decay. Once per
    building-step, in the prelude that every district shares: 21 for the
    three COPs, 3 for the reset-time consumptions, 10 for the partial-load
    fractions and their gates, 10 for the partial loads, 12 for the three
    device outputs and their consumptions, 3 for the update-time
    consumptions and 11 for the accounting's other terms."""
    a_bat = actions[3]
    return (_battery.operation_count(a_bat, n_knots, n_districts)
            + n_districts * a_bat.numel() * 5
            + a_bat.numel() * (21 + 3 + 10 + 10 + 12 + 3 + 11))


def neighborhood_episode_reference(actions: Sequence[torch.Tensor],
                                   series: Sequence[torch.Tensor], bparams: torch.Tensor,
                                   curves: Sequence[torch.Tensor], nparams: torch.Tensor,
                                   dsoc0: torch.Tensor, soc0: torch.Tensor,
                                   eff0: torch.Tensor, deg0: torch.Tensor,
                                   hours_ratio: float, ratio: float, lookback: int,
                                   record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`neighborhood_episode`: a loop over the
    S steps on (D, B) tensors, rounding every operation as the kernel does.
    Every step is live: the plans and series hold exactly S rows."""
    a_coh, a_cdev, a_hdev, a_bat = actions
    nsl, solar, price, carbon, cool_d, heat_d, dhw_d, outdoor, mode = series
    cn, hn, dn = nparams[CN], nparams[HN], nparams[DN]
    de_eff = nparams[DE]
    hhp = nparams[HHP] > 0.5
    dt_cap, dt_loss = nparams[DT_CAP], nparams[DT_LOSS]
    coh_active = nparams[COH_ACT] > 0.5
    cool_ctl = (nparams[COOL_ACT] > 0.5) | coh_active
    heat_ctl = (nparams[HEAT_ACT] > 0.5) | coh_active
    dsoc, soc, eff, deg = dsoc0, soc0, eff0, deg0
    rew, cost, emis = (torch.zeros_like(soc0) for _ in range(3))
    zero = torch.zeros_like(cn)
    rec = []
    for t in range(a_bat.shape[0]):
        t0f = 1.0 if t == 0 else 0.0
        cop_c = _cop(nparams, CN, outdoor[t], False)
        cop_h = _cop(nparams, HN, outdoor[t], True)
        cop_d = _cop(nparams, DN, outdoor[t], True)
        # reset-time update_variables consumptions, booked at t == 0; a
        # heating device that is not a heat pump books through the DHW
        # device's efficiency (building.py:2629-2632)
        reset_cool = cool_d[t] / cop_c
        reset_heat = torch.where(hhp, heat_d[t] / cop_h, heat_d[t] / de_eff)
        reset_dhw = dhw_d[t] / cop_d
        dev_init_c, dev_init_h, dev_init_d = t0f * reset_cool, t0f * reset_heat, t0f * reset_dhw

        # partial-load demand (building.py:3080-3158): the signed
        # cooling_or_heating action splits into the device fractions;
        # control starts once the LSTM's input window is full, and heating
        # takes no hours ratio (building.py:3146)
        cool_frac = torch.where(coh_active, torch.abs(torch.clamp(a_coh[t], max=0.0)), a_cdev[t])
        heat_frac = torch.where(coh_active, torch.abs(torch.clamp(a_coh[t], min=0.0)), a_hdev[t])
        elec_c = cool_frac * cn * hours_ratio
        partial_c = torch.minimum(elec_c, cn - dev_init_c) * cop_c
        partial_c = torch.where((mode[t] == 1.0) | (mode[t] == 3.0), partial_c, zero)
        elec_h = heat_frac * hn
        partial_h = torch.minimum(elec_h, hn - dev_init_h) * cop_h
        partial_h = torch.where((mode[t] == 2.0) | (mode[t] == 3.0), partial_h, zero)
        warm = t >= lookback + 1
        cooling_demand = torch.where(cool_ctl, partial_c, cool_d[t]) if warm else cool_d[t]
        heating_demand = torch.where(heat_ctl, partial_h, heat_d[t]) if warm else heat_d[t]

        # device-only dispatch: every tank is inert and there is no outage
        cout = torch.minimum(cooling_demand, (cn - dev_init_c) * cop_c)
        ccons = torch.clamp(cout / cop_c, min=0.0)
        hout = torch.minimum(heating_demand, (hn - dev_init_h) * cop_h)
        hcons = torch.clamp(hout / cop_h, min=0.0)
        dout = torch.minimum(dhw_d[t], (dn - dev_init_d) * cop_d)
        dcons = torch.clamp(dout / cop_d, min=0.0)
        # the DHW tank charges 0 each step: its standby loss alone
        denergy = torch.clamp(dsoc * dt_cap * (1.0 - dt_loss), min=0.0)
        dsoc = denergy / torch.clamp(dt_cap, min=ZERO)

        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, a_bat[t],
                                               hours_ratio, ratio)

        # update_variables accounting with the t == 0 multi-count
        uv_cool = cout / cop_c
        uv_heat = torch.where(hhp, hout / cop_h, hout / de_eff)
        uv_dhw = dout / cop_d
        cool_total = ccons + t0f * (reset_cool + uv_cool)
        heat_total = hcons + t0f * (reset_heat + uv_heat)
        dhw_total = dcons + t0f * (reset_dhw + uv_dhw)
        nsl_term = nsl[t] + t0f * 2.0 * nsl[t]
        bat_term = balance + t0f * balance
        net = cool_total + heat_total + dhw_total + nsl_term + bat_term - solar[t]
        if record:
            row = lambda x: x.expand_as(soc)[0]
            rec.append(torch.stack([row(x) for x in (
                net, balance, soc, dsoc, cout, hout, dout, cooling_demand, heating_demand)]))
        rew = rew - torch.clamp(net, min=0.0)
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
    out = (rew, cost, emis, dsoc, soc, eff, deg)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


def neighborhood_prelude_reference(actions: Sequence[torch.Tensor],
                                   series: Sequence[torch.Tensor], nparams: torch.Tensor,
                                   hours_ratio: float, lookback: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's prelude: what every district
    shares under open-loop plans, for all S steps at once. Returns ``pre``
    (S, B), the net consumption up to the battery's term
    ``((cool_total + heat_total) + dhw_total) + nsl_term``, and the
    (N_NREC - N_DISTRICT_REC, S, B) rows ``R_COUT`` ... ``R_HDEM``, rounding
    every operation as :func:`neighborhood_episode_reference` does."""
    a_coh, a_cdev, a_hdev, _ = actions
    nsl, _, _, _, cool_d, heat_d, dhw_d, outdoor, mode = series
    S = nsl.shape[0]
    cn, hn, dn = nparams[CN], nparams[HN], nparams[DN]
    de_eff = nparams[DE]
    hhp = nparams[HHP] > 0.5
    coh_active = nparams[COH_ACT] > 0.5
    cool_ctl = (nparams[COOL_ACT] > 0.5) | coh_active
    heat_ctl = (nparams[HEAT_ACT] > 0.5) | coh_active
    steps = torch.arange(S, device=nsl.device)[:, None]
    t0f = (steps == 0).to(nsl.dtype)
    warm = steps >= lookback + 1
    zero = torch.zeros_like(nsl)
    cop_c = _cop(nparams, CN, outdoor, False)
    cop_h = _cop(nparams, HN, outdoor, True)
    cop_d = _cop(nparams, DN, outdoor, True)
    reset_cool = cool_d / cop_c
    reset_heat = torch.where(hhp, heat_d / cop_h, heat_d / de_eff)
    reset_dhw = dhw_d / cop_d
    dev_init_c, dev_init_h, dev_init_d = t0f * reset_cool, t0f * reset_heat, t0f * reset_dhw
    cool_frac = torch.where(coh_active, torch.abs(torch.clamp(a_coh, max=0.0)), a_cdev)
    heat_frac = torch.where(coh_active, torch.abs(torch.clamp(a_coh, min=0.0)), a_hdev)
    elec_c = cool_frac * cn * hours_ratio
    partial_c = torch.minimum(elec_c, cn - dev_init_c) * cop_c
    partial_c = torch.where((mode == 1.0) | (mode == 3.0), partial_c, zero)
    elec_h = heat_frac * hn
    partial_h = torch.minimum(elec_h, hn - dev_init_h) * cop_h
    partial_h = torch.where((mode == 2.0) | (mode == 3.0), partial_h, zero)
    cooling_demand = torch.where(warm & cool_ctl, partial_c, cool_d)
    heating_demand = torch.where(warm & heat_ctl, partial_h, heat_d)
    cout = torch.minimum(cooling_demand, (cn - dev_init_c) * cop_c)
    ccons = torch.clamp(cout / cop_c, min=0.0)
    hout = torch.minimum(heating_demand, (hn - dev_init_h) * cop_h)
    hcons = torch.clamp(hout / cop_h, min=0.0)
    dout = torch.minimum(dhw_d, (dn - dev_init_d) * cop_d)
    dcons = torch.clamp(dout / cop_d, min=0.0)
    uv_cool = cout / cop_c
    uv_heat = torch.where(hhp, hout / cop_h, hout / de_eff)
    uv_dhw = dout / cop_d
    cool_total = ccons + t0f * (reset_cool + uv_cool)
    heat_total = hcons + t0f * (reset_heat + uv_heat)
    dhw_total = dcons + t0f * (reset_dhw + uv_dhw)
    nsl_term = nsl + t0f * 2.0 * nsl
    pre = cool_total + heat_total + dhw_total + nsl_term
    return pre, torch.stack([cout, hout, dout, cooling_demand, heating_demand])


def neighborhood_district_reference(pre: torch.Tensor, series: Sequence[torch.Tensor],
                                    a_bat: torch.Tensor, bparams: torch.Tensor,
                                    curves: Sequence[torch.Tensor], nparams: torch.Tensor,
                                    dsoc0: torch.Tensor, soc0: torch.Tensor,
                                    eff0: torch.Tensor, deg0: torch.Tensor,
                                    hours_ratio: float, ratio: float,
                                    record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel's district pass: from the
    prelude's ``pre`` and the (solar, price, carbon) rows of ``series``,
    the battery, the DHW tank's decay, ``net = (pre + bat_term) - solar``
    and the sums. Returns the seven outputs of
    :func:`neighborhood_episode` and, with ``record=True``, the
    (N_DISTRICT_REC, S, B) rows ``R_NET`` ... ``R_DSOC``."""
    solar, price, carbon = series
    dt_cap, dt_loss = nparams[DT_CAP], nparams[DT_LOSS]
    dsoc, soc, eff, deg = dsoc0, soc0, eff0, deg0
    rew, cost, emis = (torch.zeros_like(soc0) for _ in range(3))
    rec = []
    for t in range(pre.shape[0]):
        t0f = 1.0 if t == 0 else 0.0
        denergy = torch.clamp(dsoc * dt_cap * (1.0 - dt_loss), min=0.0)
        dsoc = denergy / torch.clamp(dt_cap, min=ZERO)
        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, a_bat[t],
                                               hours_ratio, ratio)
        bat_term = balance + t0f * balance
        net = pre[t] + bat_term - solar[t]
        if record:
            rec.append(torch.stack([net[0], balance[0], soc[0], dsoc[0]]))
        rew = rew - torch.clamp(net, min=0.0)
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
    out = (rew, cost, emis, dsoc, soc, eff, deg)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("neighborhood_episode").neighborhood_episode_launch
    fn.argtypes = [_PTR] * 32 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def neighborhood_episode(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                         bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                         nparams: torch.Tensor, dsoc0: torch.Tensor, soc0: torch.Tensor,
                         eff0: torch.Tensor, deg0: torch.Tensor, hours_ratio: float,
                         ratio: float, lookback: int,
                         record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a full S-step episode for a (D, B) neighborhood district batch.

    ``actions``: (cooling_or_heating_device, cooling_device, heating_device,
    electrical_storage) open-loop plans, each (S, B), shared by the
    districts; ``series``: (nsl, solar, price, carbon, cooling_demand,
    heating_demand, dhw_demand, outdoor temperature, hvac_mode), each (S, B)
    float32; ``bparams`` and ``curves`` as
    :func:`ops.battery.battery_episode` takes them; ``nparams``:
    (N_NROWS, B) rows named by this module's constants; state ``dsoc0``,
    ``soc0``, ``eff0``, ``deg0``: (D, B). Partial-load control starts at
    step ``lookback + 1``. Returns (reward_sum, cost_sum, emission_sum,
    dhw_soc, battery_soc, battery_eff, battery_degraded) each (D, B) and,
    with ``record=True``, an (N_NREC, S, B) per-step stream of district
    0's rows ``R_NET`` ... ``R_HDEM``.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    if len(actions) != 4 or len(series) != 9 or len(curves) != 4:
        raise ValueError("neighborhood_episode takes 4 plans, 9 series and 4 curves")
    if soc0.device.type == "cpu":
        return neighborhood_episode_reference(actions, series, bparams, curves, nparams, dsoc0,
                                              soc0, eff0, deg0, hours_ratio, ratio, lookback,
                                              record)
    if soc0.device.type != "cuda":
        raise ValueError(f"neighborhood_episode runs on CPU or CUDA tensors, not {soc0.device}")
    S, B = actions[3].shape
    D = soc0.shape[0]
    n_knots = curves[0].shape[0]
    inputs = [*actions, *series, bparams, *curves, nparams, dsoc0, soc0, eff0, deg0]
    shapes = [(S, B)] * 13 + [(8, B)] + [(n_knots, B)] * 4 + [(N_NROWS, B)] + [(D, B)] * 4
    for x, shape in zip(inputs, shapes):
        if x.device != soc0.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"neighborhood_episode wants contiguous float32 {shape} on "
                             f"{soc0.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 2 <= n_knots <= MAX_KNOTS:
        raise ValueError(f"neighborhood_episode takes 2 to {MAX_KNOTS} curve knots, "
                         f"got {n_knots}")
    outs = [torch.empty((D, B), dtype=torch.float32, device=soc0.device) for _ in range(7)]
    rec = (torch.empty((N_NREC, S, B), dtype=torch.float32, device=soc0.device)
           if record else None)
    s_pad = -(-S // STAGE_CHUNK) * STAGE_CHUNK
    stage = torch.empty((B, N_STAGE, s_pad), dtype=torch.float32, device=soc0.device)
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(soc0.device):
        stream = torch.cuda.current_stream(soc0.device).cuda_stream
        err = _launcher()(*[x.data_ptr() for x in inputs + outs],
                          None if rec is None else rec.data_ptr(), stage.data_ptr(),
                          D, B, S, s_pad, n_knots, lookback, hours_ratio, ratio, stream)
    if err != 0:
        raise RuntimeError(f"neighborhood_episode kernel launch failed: CUDA error {err}")
    neighborhood_episode.launches += 1
    return tuple(outs) + ((rec,) if record else ())


neighborhood_episode.launches = 0
