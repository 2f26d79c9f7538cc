"""K5: whole-episode rollout of an LSTM-dynamics district batch.

:func:`lstm_episode` replaces ``citylearn_tpu/ops/pallas_lstm.py::
lstm_episode``: partial-load cooling from the ``cooling_device`` action,
the cooling and DHW end uses and the battery with the power-outage
coupling, the lookback-window stacked LSTM that predicts the indoor
temperature (re-run every step from its carried state) and the
ComfortReward, under four shared open-loop plans — the whole district step
of the 2023 family fused over the episode. On CUDA tensors it launches the
hand-written kernel ``csrc/lstm_episode.cu``: a block holds districts of
one building; a group of eight lanes per district runs its LSTM,
each lane the four gate rows of its hidden units, the group's hidden vector
exchanged through shared memory, and one thread per district runs its
physics, one step ahead of the LSTM; the building's weights and the static
channels' products (once per row, for every district of the block) sit in
shared memory. It is bound by operations (about 2e4 per building-step,
nearly all of them in the gate products). On CPU tensors the wrapper runs
:func:`lstm_episode_reference`, the plain PyTorch version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel against.

Layout at the public function follows the JAX kernel's without its TPU
padding, block-diagonal weight matrices and one-hot scatter matrices:
plans and series are (S, B), ``bparams`` (8, B), curves knot-major
(n_knots, B), ``tparams`` (N_TROWS, B), ``lparams`` (N_LROWS, B), the
static channels (S, X) with each building's channels at its own offset,
the weights one flat buffer (:func:`pack_weights`), state (D, B); any
D >= 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.core.dynamics import lstm_predict
from citylearn_tpu_torch.core.types import DynamicsParams
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as _battery
from citylearn_tpu_torch.ops.battery import MAX_KNOTS, battery_event_energy
from citylearn_tpu_torch.ops.thermal import (
    CN,
    CT_CAP,
    CT_CONV,
    DN,
    DT_CAP,
    DT_CONV,
    N_TROWS,
    _cop,
    _thermal_block,
    flexibility,
)

# lstm parameter rows (lparams, (N_LROWS, B))
(L_NMIN_CC, L_NSPAN_CC,      # cooling-demand channel: norm minimum and span
 L_NMIN_TC, L_NSPAN_TC,      # temperature channel: norm minimum and span
 L_LIN_B,                    # linear head bias
 L_COOL_ACTIVE,              # cooling_device action availability
 N_LROWS) = range(7)

# recorded per-step series rows (record=True)
(R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT,
 R_TEMP, R_REWARD, R_CDEM, R_NSLMET, N_LREC) = range(14)

# per-building columns of LstmWeights.meta (csrc/lstm_common.cuh); the
# heating-demand channel is read by the neighborhood post-pass only
(M_LAYERS, M_HIDDEN, M_CHANNELS, M_TEMP_CH, M_COOL_CH, M_X_OFF, M_W_OFF, M_HEAT_CH,
 N_META) = range(9)

MAX_HIDDEN = 64      # csrc/lstm_common.cuh MAX_H
MAX_CHANNELS = 32    # csrc/lstm_common.cuh MAX_F
MAX_LOOKBACK = 95    # the limit of the first kernel, kept


def pad4(n: int) -> int:
    """``n`` rounded up to a multiple of 4: rows of the weight buffer and
    each building's static channels start on 16 bytes."""
    return (n + 3) // 4 * 4


class LstmWeights(NamedTuple):
    """The LSTMs of a district's buildings for :func:`lstm_episode`.

    ``flat`` holds, for each building from ``meta[b, M_W_OFF]`` on and with
    the input and hidden widths padded by zeros to multiples of 4
    (F -> FP, H -> HP): layer 1 input by input, that is FP + HP columns of
    [w_ih | w_hh] with 4H weights each (the transpose of torch's (4H, F)
    and (4H, H) matrices), its bias (4H), then for a second layer HP + HP
    such columns and its bias (4H), then the head's weights (HP). Gate
    rows follow torch's order i, f, g, o. ``meta`` (B, N_META) int32 holds per building the
    layer count, hidden size, channel count, the temperature and
    cooling-demand channel, the offset of its channels in the static
    stream, the offset of its weights and the heating-demand channel (-1
    where a channel is absent); ``units`` the same numbers on the host."""
    flat: torch.Tensor
    meta: torch.Tensor
    units: Tuple[Tuple[int, ...], ...]


def pack_weights(buildings: Sequence[Dict], device) -> LstmWeights:
    """:class:`LstmWeights` from one dict per building with ``w_ih``,
    ``w_hh``, ``bias`` (a list per layer of (4H, F or H), (4H, H), (4H,)
    arrays), ``lin_w`` (H,), ``tc``, ``cc`` and optionally ``hc`` (channel
    indices, -1 for an absent one). Each building's static channels take
    ``pad4(F)`` columns of the stream."""
    chunks: List[np.ndarray] = []
    units = []
    x_off = w_off = 0
    for u in buildings:
        w_ih = [np.asarray(w, np.float32) for w in u["w_ih"]]
        w_hh = [np.asarray(w, np.float32) for w in u["w_hh"]]
        L, H, F = len(w_ih), w_hh[0].shape[1], w_ih[0].shape[1]
        HP, FP = pad4(H), pad4(F)
        units.append((L, H, F, int(u["tc"]), int(u["cc"]), x_off, w_off, int(u.get("hc", -1))))
        mine = []
        for l in range(L):
            in_p = FP if l == 0 else HP
            rows = np.zeros((4 * H, in_p + HP), np.float32)
            rows[:, :w_ih[l].shape[1]] = w_ih[l]
            rows[:, in_p:in_p + H] = w_hh[l]
            mine += [rows.T.ravel(), np.asarray(u["bias"][l], np.float32)]
        head = np.zeros(HP, np.float32)
        head[:H] = np.asarray(u["lin_w"], np.float32)
        mine.append(head)
        chunks += mine
        w_off += sum(c.size for c in mine)
        x_off += FP
    flat = torch.tensor(np.concatenate(chunks), device=device)
    meta = torch.tensor(np.asarray(units, np.int32), device=device)
    return LstmWeights(flat=flat, meta=meta, units=tuple(units))


def static_width(weights: LstmWeights) -> int:
    """Columns of the static-channel stream these buildings read."""
    last = weights.units[-1]
    return last[M_X_OFF] + pad4(last[M_CHANNELS])


def _groups(weights: LstmWeights) -> List[Tuple[List[int], DynamicsParams]]:
    """The buildings grouped by identical LSTM shape and channels, each
    group's weights unpacked from the flat buffer into the stacks
    :func:`core.dynamics.lstm_predict` reads."""
    members: Dict[Tuple[int, ...], List[int]] = {}
    for b, u in enumerate(weights.units):
        members.setdefault(u[:5], []).append(b)
    out = []
    for (L, H, F, tc, cc), bs in members.items():
        HP, FP = pad4(H), pad4(F)
        w_ih, w_hh, bias = ([[] for _ in range(L)] for _ in range(3))
        lin_w = []
        for b in bs:
            o = weights.units[b][M_W_OFF]
            for l in range(L):
                in_p, n_in = (FP, F) if l == 0 else (HP, H)
                rows = weights.flat[o:o + 4 * H * (in_p + HP)].reshape(in_p + HP, 4 * H).t()
                w_ih[l].append(rows[:, :n_in])
                w_hh[l].append(rows[:, in_p:in_p + H])
                o += rows.numel()
                bias[l].append(weights.flat[o:o + 4 * H])
                o += 4 * H
            lin_w.append(weights.flat[o:o + H])
        stack = lambda per_layer: tuple(torch.stack(x) for x in per_layer)
        out.append((bs, DynamicsParams(
            member_indices=None, w_ih=stack(w_ih), w_hh=stack(w_hh), bias=stack(bias),
            lin_w=torch.stack(lin_w), lin_b=None, norm_min=None, norm_max=None,
            static_channels=None, cooling_device_active=None, heating_device_active=None,
            cooling_or_heating_active=None)))
    return out


def operation_count(actions: Sequence[torch.Tensor], weights: LstmWeights, n_knots: int,
                    lookback: int, n_districts: int) -> int:
    """fp32 operations the kernel executes for these plans. Per
    building-step from ``t >= lookback`` on: ``lookback`` cells per layer,
    each ``2 * 4H * (n_in + H)`` for the gate products (``n_in``: layer 1's
    two dynamic channels, the cooling demand and the temperature; layer 2's
    H inputs), 4H gate activations, H more for ``tanh(c)`` and 4H for the
    new (c, h); the head's 2H + 2. Per building and row of the static
    stream that a window reads (rows 1 to S - 1 once S > lookback), shared by
    all districts: ``2 * 4H`` per static channel for layer 1's static
    products. Per building-step of the physics: one battery event and the
    sums (:func:`ops.battery.operation_count`; the kernel runs the early or
    the late event, never both), the thermal blocks as
    :func:`ops.thermal.operation_count` counts them, 12 for the partial
    load, 8 for the flexibility caps, 6 for the normalizations and 14 for
    the reward."""
    a_cdev, a_cstor, a_dstor, a_bat = actions
    S = a_bat.shape[0]
    lstm = static = 0
    windows = max(S - lookback, 0)
    for L, H, F, *_ in weights.units:
        cell = 2 * 4 * H * (2 + H) + 9 * H
        if L == 2:
            cell += 2 * 4 * H * (H + H) + 9 * H
        lstm += windows * (lookback * cell + 2 * H + 2)
        static += (S - 1 if windows else 0) * 2 * 4 * H * (F - 2)
    discharging = int((a_cstor < 0).sum()) + int((a_dstor < 0).sum())
    physics = a_bat.numel() * (14 + 4 + 17 + 2 * 30 + 12 + 8 + 6 + 14) + 2 * discharging
    return (_battery.operation_count(a_bat, n_knots, n_districts)
            + n_districts * (physics + lstm) + static)


def _powe(d: torch.Tensor, e: float) -> torch.Tensor:
    """``d ** e`` as the kernel computes it: exponents 1, 2 and 3 are
    products."""
    if e == 1.0:
        return d
    if e == 2.0:
        return d * d
    if e == 3.0:
        return d * d * d
    return torch.pow(d, e)


def comfort_reward(T: torch.Tensor, mode: torch.Tensor, csp: torch.Tensor, hsp: torch.Tensor,
                   band: torch.Tensor, heating: torch.Tensor, lo_exp: float,
                   hi_exp: float) -> torch.Tensor:
    """ComfortReward (reward_function.py:216-340) as the kernel computes
    it; ``mode`` holds the HVAC mode as floats."""
    zero = torch.zeros_like(T)
    sp = torch.where(mode == 1.0, csp, hsp)
    d_sp = torch.abs(T - sp)
    lo, hi = _powe(d_sp, lo_exp), _powe(d_sp, hi_exp)
    r_single = torch.where(
        T < sp - band, -torch.where(mode == 2.0, lo, hi),
        torch.where(T < sp, torch.where(heating, zero, -d_sp),
                    torch.where(T <= sp + band, torch.where(heating, -d_sp, zero),
                                -torch.where(heating, hi, lo))))
    cd, hd = torch.abs(T - csp), torch.abs(T - hsp)
    r_dual = torch.where(
        T < hsp - band, -torch.where(heating, _powe(hd, lo_exp), _powe(hd, hi_exp)),
        torch.where(T < hsp, -hd,
                    torch.where(T <= csp, zero,
                                torch.where(T < csp + band, -cd,
                                            -torch.where(heating, _powe(cd, hi_exp),
                                                         _powe(cd, lo_exp))))))
    return torch.where((mode == 1.0) | (mode == 2.0), r_single, r_dual)


def lstm_episode_reference(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                           bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                           tparams: torch.Tensor, lparams: torch.Tensor,
                           weights: LstmWeights, csoc0: torch.Tensor, dsoc0: torch.Tensor,
                           soc0: torch.Tensor, eff0: torch.Tensor, deg0: torch.Tensor,
                           hours_ratio: float, ratio: float, lookback: int,
                           lo_exp: float = 2.0, hi_exp: float = 2.0,
                           record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`lstm_episode`: a loop over the S
    steps on (D, B) tensors. The physics rounds every operation as the
    kernel does; the LSTM goes through :func:`core.dynamics.lstm_predict`,
    whose sums run in another order than the kernel's."""
    a_cdev, a_cstor, a_dstor, a_bat = actions
    (nsl, solar, price, carbon, cool_ideal, dhw_demand, outdoor, mode, temp_ideal, csp, hsp,
     band, schan, outage) = series
    csoc, dsoc, soc, eff, deg = csoc0, dsoc0, soc0, eff0, deg0
    D, B = soc0.shape
    rew, cost, emis = (torch.zeros_like(soc0) for _ in range(3))
    temp_last = torch.zeros_like(soc0)
    zero = torch.zeros_like(soc0)
    nominal = bparams[1]
    cool_active = lparams[L_COOL_ACTIVE] > 0.5

    # per group of identical LSTMs: carried (h, c), zero until the window is
    # full, and the window of normalized inputs (D, Bg, F, lookback + 1)
    groups = []
    for bs, dyn in _groups(weights):
        L, H, F, tc, cc = weights.units[bs[0]][:5]
        cols = torch.tensor([[weights.units[b][M_X_OFF] + f for f in range(F)] for b in bs],
                            device=soc0.device)
        dyn.lin_b = lparams[L_LIN_B][bs]
        groups.append(dict(
            bs=torch.tensor(bs, device=soc0.device), dyn=dyn, tc=tc, cc=cc, cols=cols,
            h=soc0.new_zeros((D, L, len(bs), H)), c=soc0.new_zeros((D, L, len(bs), H)),
            buf=soc0.new_zeros((D, len(bs), F, lookback + 1))))

    rec = []
    for t in range(a_bat.shape[0]):
        t0f = 1.0 if t == 0 else 0.0
        out_now = outage[t]
        cop_c = _cop(tparams, CN, outdoor[t], False)
        cop_d = _cop(tparams, DN, outdoor[t], True)
        # reset-time update_variables consumptions, booked at t == 0
        reset_cool = cool_ideal[t] / cop_c
        reset_dhw = dhw_demand[t] / cop_d
        dev_init_c, dev_init_d = t0f * reset_cool, t0f * reset_dhw

        # partial-load cooling demand (building.py:3080-3121): the device
        # action sets the available electric power once the LSTM's input
        # window is full
        elec_c = a_cdev[t] * tparams[CN] * hours_ratio
        partial_c = torch.minimum(elec_c, tparams[CN] - dev_init_c) * cop_c
        partial_c = torch.where((mode[t] == 1.0) | (mode[t] == 3.0), partial_c,
                                torch.zeros_like(partial_c))
        cooling_demand = (torch.where(cool_active, partial_c, cool_ideal[t])
                          if t >= lookback + 1 else cool_ideal[t])

        # a discharging battery runs first and books its balance; a
        # charging one runs last under the flexibility left
        bat_energy = a_bat[t] * nominal * hours_ratio
        early = battery_event_energy(bparams, curves, soc, eff, deg, bat_energy, ratio)
        bat_dis = bat_energy < 0.0
        accum = t0f * (reset_cool + reset_dhw + nsl[t]) + torch.where(bat_dis, early[3], zero)

        csoc, cbal, cout, ccons = _thermal_block(
            tparams, CN, CT_CAP, CT_CONV, csoc, cooling_demand, a_cstor[t], cop_c, dev_init_c,
            1.0, ratio, out_now, solar[t], accum)
        accum = accum + ccons
        dsoc, dbal, dout, dcons = _thermal_block(
            tparams, DN, DT_CAP, DT_CONV, dsoc, dhw_demand[t], a_dstor[t], cop_d, dev_init_d,
            hours_ratio, ratio, out_now, solar[t], accum)
        accum = accum + dcons
        nsl_met = torch.minimum(nsl[t], flexibility(out_now, solar[t], accum))
        accum = accum + nsl_met
        late = battery_event_energy(
            bparams, curves, soc, eff, deg,
            torch.minimum(bat_energy, flexibility(out_now, solar[t], accum)), ratio)
        soc, eff, deg, balance = (torch.where(bat_dis, e, l) for e, l in zip(early, late))

        # update_variables accounting with the t == 0 multi-count
        uv_cool = (cout + cbal) / cop_c
        uv_dhw = (dout + dbal) / cop_d
        cool_total = ccons + t0f * (reset_cool + uv_cool)
        dhw_total = dcons + t0f * (reset_dhw + uv_dhw)
        nsl_term = nsl_met + t0f * (nsl[t] + nsl_met)
        bat_term = balance + t0f * balance
        net = cool_total + dhw_total + nsl_term + bat_term - solar[t]
        net = torch.where(out_now > 0.0, zero, net)

        # LSTM temperature prediction (building.py:2935-3078)
        cool_obs = cout + torch.clamp(-cbal, min=0.0)
        cool_obs_n = (cool_obs - lparams[L_NMIN_CC]) / lparams[L_NSPAN_CC]
        temp_ideal_n = (temp_ideal[t] - lparams[L_NMIN_TC]) / lparams[L_NSPAN_TC]
        temp_t = temp_ideal[t].expand(D, B)
        for g in groups:
            bs, tc, cc = g["bs"], g["tc"], g["cc"]
            vals = schan[t][g["cols"]].expand(D, -1, -1).clone()         # (D, Bg, F)
            vals[..., cc] = cool_obs_n[:, bs]
            vals[..., tc] = temp_ideal_n[bs]
            buf = torch.cat([g["buf"][..., 1:], vals[..., None]], dim=-1)
            if t >= lookback:
                # every channel reads the last `lookback` entries, the
                # temperature the first `lookback`: one step older
                model_in = buf[..., 1:].clone()
                model_in[:, :, tc, :] = buf[:, :, tc, :-1]
                pred_n, g["h"], g["c"] = lstm_predict(g["dyn"], model_in.transpose(2, 3),
                                                      g["h"], g["c"])
                buf[:, :, tc, -1] = pred_n
                temp_t = temp_t.index_copy(
                    1, bs, pred_n * lparams[L_NSPAN_TC][bs] + lparams[L_NMIN_TC][bs])
            g["buf"] = buf

        # the kernel's heating test: the heating observation is 0 here
        r = comfort_reward(temp_t, mode[t].expand(D, B), csp[t], hsp[t], band[t],
                           0.0 > cool_obs, lo_exp, hi_exp)
        if record:
            row = lambda x: x.expand(D, B)[0]
            rec.append(torch.stack([row(x) for x in (
                net, cbal, dbal, balance, csoc, dsoc, soc, cout, dout, temp_t, r,
                cooling_demand, nsl_met)]))
        rew = rew + r
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
        temp_last = temp_t
    out = (rew, cost, emis, csoc, dsoc, soc, eff, deg, temp_last.expand(D, B).contiguous())
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("lstm_episode").lstm_episode_launch
    fn.argtypes = [_PTR] * 42 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


@tracing.traced("lstm_episode")
def lstm_episode(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                 bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                 tparams: torch.Tensor, lparams: torch.Tensor, weights: LstmWeights,
                 csoc0: torch.Tensor, dsoc0: torch.Tensor, soc0: torch.Tensor,
                 eff0: torch.Tensor, deg0: torch.Tensor, hours_ratio: float, ratio: float,
                 lookback: int, lo_exp: float = 2.0, hi_exp: float = 2.0,
                 record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a full S-step episode for a (D, B) LSTM-dynamics district batch.

    ``actions``: (cooling_device, cooling_storage, dhw_storage,
    electrical_storage) open-loop plans, each (S, B), shared by the
    districts; ``series``: (nsl, solar, price, carbon, cooling_demand,
    dhw_demand, outdoor temperature, hvac_mode, indoor temperature, cooling
    set point, heating set point, comfort band, static channels,
    power_outage), each (S, B) float32 except the static channels, (S, X)
    with building b's pre-normalized channels in columns
    ``meta[b, M_X_OFF]`` on and its dynamic channels zero; ``bparams``
    and ``curves`` as :func:`ops.battery.battery_episode` takes them;
    ``tparams`` as :func:`ops.thermal.thermal_episode` does; ``lparams``
    (N_LROWS, B) rows named by this module's constants; ``weights`` from
    :func:`pack_weights`; state ``csoc0``, ``dsoc0``, ``soc0``, ``eff0``,
    ``deg0``: (D, B). ``lookback`` is the LSTMs' shared window length,
    ``lo_exp`` and ``hi_exp`` the reward's exponents. Returns (reward_sum,
    cost_sum, emission_sum, cooling_soc, dhw_soc, battery_soc, battery_eff,
    battery_degraded, last_temperature) each (D, B) and, with
    ``record=True``, an (N_LREC, S, B) per-step stream of district 0's rows
    ``R_NET`` ... ``R_NSLMET``.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    if len(actions) != 4 or len(series) != 14 or len(curves) != 4:
        raise ValueError("lstm_episode takes 4 plans, 14 series and 4 curves")
    S, B = actions[3].shape
    D = soc0.shape[0]
    X = static_width(weights)
    if len(weights.units) != B:
        raise ValueError(f"lstm_episode got weights of {len(weights.units)} buildings for {B}")
    for L, H, F, tc, cc, *_ in weights.units:
        if L not in (1, 2) or not 1 <= H <= MAX_HIDDEN or not 2 <= F <= MAX_CHANNELS \
                or not (0 <= tc < F and 0 <= cc < F and tc != cc):
            raise ValueError(
                f"lstm_episode takes 1 or 2 layers of up to {MAX_HIDDEN} units over up to "
                f"{MAX_CHANNELS} channels with a temperature and a cooling-demand channel, "
                f"got {L} layers, {H} units, {F} channels, channels {tc} and {cc}")
    if not 1 <= lookback <= MAX_LOOKBACK:
        raise ValueError(f"lstm_episode takes a lookback of 1 to {MAX_LOOKBACK}, got {lookback}")
    if soc0.device.type == "cpu":
        return lstm_episode_reference(actions, series, bparams, curves, tparams, lparams,
                                      weights, csoc0, dsoc0, soc0, eff0, deg0, hours_ratio,
                                      ratio, lookback, lo_exp, hi_exp, record)
    if soc0.device.type != "cuda":
        raise ValueError(f"lstm_episode runs on CPU or CUDA tensors, not {soc0.device}")
    n_knots = curves[0].shape[0]
    inputs = [*actions, *series, bparams, *curves, tparams, lparams, weights.flat,
              csoc0, dsoc0, soc0, eff0, deg0]
    shapes = [(S, B)] * 16 + [(S, X), (S, B)] + [(8, B)] + [(n_knots, B)] * 4 \
        + [(N_TROWS, B), (N_LROWS, B), tuple(weights.flat.shape)] + [(D, B)] * 5
    for x, shape in zip(inputs, shapes):
        if x.device != soc0.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"lstm_episode wants contiguous float32 {shape} on "
                             f"{soc0.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    meta = weights.meta
    if meta.device != soc0.device or meta.dtype != torch.int32 \
            or tuple(meta.shape) != (B, N_META) or not meta.is_contiguous():
        raise ValueError(f"lstm_episode wants contiguous int32 ({B}, {N_META}) weight "
                         f"metadata on {soc0.device}")
    if not 2 <= n_knots <= MAX_KNOTS:
        raise ValueError(f"lstm_episode takes 2 to {MAX_KNOTS} curve knots, got {n_knots}")
    outs = [torch.empty((D, B), dtype=torch.float32, device=soc0.device) for _ in range(9)]
    rec = (torch.empty((N_LREC, S, B), dtype=torch.float32, device=soc0.device)
           if record else None)
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(soc0.device):
        stream = torch.cuda.current_stream(soc0.device).cuda_stream
        err = _launcher()(*[x.data_ptr() for x in inputs], meta.data_ptr(),
                          *[x.data_ptr() for x in outs],
                          None if rec is None else rec.data_ptr(),
                          D, B, S, X, n_knots, lookback,
                          max(u[M_HIDDEN] for u in weights.units), hours_ratio, ratio, lo_exp,
                          hi_exp, stream)
    if err != 0:
        raise RuntimeError(f"lstm_episode kernel launch failed: CUDA error {err}")
    lstm_episode.launches += 1
    return tuple(outs) + ((rec,) if record else ())


lstm_episode.launches = 0
