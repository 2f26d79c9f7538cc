"""K4: whole-episode rollout of an EV district batch.

:func:`ev_episode` replaces ``citylearn_tpu/ops/pallas_ev.py::ev_episode``:
battery+PV buildings plus EV chargers, electric vehicles and washing
machines under three shared open-loop plans (per building, per charger,
per machine), with the default reward or the
``Electric_Vehicles_Reward_Function``. On CUDA tensors it launches the
hand-written kernels of ``csrc/ev_episode.cu`` in one launch call: a
prelude computes once per step what every district shares (each
charger's request, each machine's window test) and packs it with the
step's other rows; then a warp per district runs the episode, the carried
state and the block's copy of the tables and of a chunk of packed rows in
shared memory, lanes taking buildings, chargers, EVs and machines in turn;
a charger lane reads and writes the state of the EV connected to it by
index. Like K1 and K3 the kernel is bound by the latency of each step's
dependent chain, not by bytes nor by fp32 throughput. On CPU tensors the
wrapper runs :func:`ev_episode_reference`, the plain PyTorch version of
the same function, which the tests and ``chip_smoke.py`` hold the kernel
against. :func:`ev_prelude_reference` and :func:`ev_district_reference`
are the plain versions of the two halves, which the tests put together
to rebuild :func:`ev_episode_reference` bit for bit.

Every floating-point sum that crosses lanes has one fixed order in both
versions, so that they agree bit for bit: chargers and machines add into
their building in index order, starting from 0, and the district's net
load is a pairwise tree over the next power of two of buildings
(:func:`_tree_sum`).

Layout at the public function follows the JAX kernel's, minus its TPU
padding: plans and streams are (S, n) over their own lanes (B buildings,
C chargers, V EVs, W machines, each at most 128), the connected-EV stream
is int32 with -1 for none, battery tables are (8, n) rows with knot-major
(knots, n) curves, state is (D, n); any D >= 1. One EV connected to two
chargers in the same step is outside the contract (the data never holds
it): the two updates would collide.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as _battery
from citylearn_tpu_torch.ops.battery import MAX_KNOTS, _interp, battery_event

MAX_LANES = 128   # buildings, chargers, EVs or machines of one district

# charger parameter rows (C lanes)
(CH_MAXC, CH_MINC, CH_MAXD, CH_MIND, N_CROWS) = range(5)
# rows of a battery table that the EV lanes read beside the event
# (ops/battery.py bparams rows)
ROW_CAP, ROW_INIT, ROW_DOD = 0, 3, 4

# recorded per-step series rows (record=True), building lanes
(R_NET, R_BBAL, R_BSOC, R_CHC, R_WMC, R_REW, N_EREC) = range(7)
# floats of one step's packed row per building, charger, EV and machine
# (csrc/ev_episode.cu Row), the row rounded up to 4
STAGE_ROWS = (6, 7, 2, 3)


def operation_count(actions: Sequence[torch.Tensor], conn: torch.Tensor, n_knots: int,
                    ev_knots: int, ch_knots: int, n_evs: int, n_districts: int,
                    use_ev_reward: bool) -> int:
    """fp32 operations (add, sub, mul, div, sqrt, min, max, abs, negate,
    compare) the kernel executes for these plans and this connection
    stream. Once per step, in the prelude that every district shares: per
    charger 12 for the request and one lookup of ``ch_knots`` compares and
    6 operations, per machine 7 for the window test. Per district: the
    building battery events, the sums and the net's two operations as K1
    counts them (:func:`ops.battery.operation_count`), 2 more for the
    charger and machine terms of the net and 1 add per charger and per
    machine; per EV-step 6 for the SOC events; per machine-step 2 for the
    trigger; per charger-step an EV battery event only where an EV is
    connected (42 and two lookups, 5 more when it discharges, 4 for the
    consumption). With the EV reward: per building-step 9 for the
    multiplier, 2 for the penalty and 1 for the tree sum, and per connected
    charger-step 41 for the terms and 1 add into the building."""
    a_bat, a_ev, a_wm = actions
    S, C = a_ev.shape
    connected = conn >= 0
    n_connected = int(connected.sum())
    discharging = int(((a_ev <= 0) & connected).sum())
    per_district = (
        _battery.operation_count(a_bat, n_knots, 1) + a_bat.numel() * 2
        + S * C + a_wm.numel() * (2 + 1) + S * n_evs * 6
        + n_connected * (42 + 2 * (ev_knots + 6) + 4) + 5 * discharging)
    if use_ev_reward:
        per_district += a_bat.numel() * (9 + 2 + 1) + n_connected * (41 + 1)
    return n_districts * per_district + S * C * (12 + ch_knots + 6) + a_wm.numel() * 7


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis of (D, n) as the kernel's pairwise tree: pad
    with zeros to the next power of two, then add the upper half onto the
    lower until one column is left. Returns (D, 1)."""
    n = x.shape[-1]
    p2 = 1
    while p2 < n:
        p2 <<= 1
    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p2 - n,))], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x


def _segment_sum(x: torch.Tensor, index: Sequence[int], n: int) -> torch.Tensor:
    """Columns of (D, C) added into ``n`` segments in column order,
    starting from 0, as a building lane of the kernel adds its chargers."""
    out = x.new_zeros((x.shape[0], n))
    for j, b in enumerate(index):
        out[:, b] += x[:, j]
    return out


def ev_prelude_reference(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                         cparams: torch.Tensor, ch_curves: Sequence[torch.Tensor],
                         hours_ratio: float) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel's prelude: what every district
    shares under open-loop plans, for all S steps at once. Returns the
    charger requests (energy handed to the EV's battery event, the
    action's energy where the charger acts and 0 elsewhere, the charger's
    efficiency), each (S, C), and the machines' window tests (the trigger's
    conditions but the machine's own flag, the re-arm on a changed window),
    each (S, W) bool, rounding as :func:`ev_episode_reference` does."""
    _, a_ev, a_wm = actions
    wm_s, wm_e = series[9], series[10]
    maxc, minc, maxd, mind = (cparams[r] for r in (CH_MAXC, CH_MINC, CH_MAXD, CH_MIND))
    ch_cx, ch_cy, ch_dx, ch_dy = ch_curves
    chg = a_ev > 0.0
    energy_c = torch.where(
        chg,
        torch.maximum(torch.minimum(a_ev * maxc * hours_ratio, maxc), minc),
        torch.maximum(torch.minimum(a_ev * maxd * hours_ratio, -mind), -maxd))
    eff_c = torch.where(chg, _interp(torch.abs(a_ev), ch_cx, ch_cy),
                        _interp(torch.abs(a_ev), ch_dx, ch_dy))
    energy_kwh = torch.where(chg, energy_c * eff_c, energy_c / eff_c)
    last = torch.where(a_ev != 0.0, energy_c, torch.zeros_like(energy_c))
    steps = torch.arange(wm_s.shape[0], device=wm_s.device, dtype=wm_s.dtype)[:, None]
    window_ok = ((a_wm > 0.0) & (wm_s != -1.0) & (wm_e != -1.0) & (wm_s <= steps)
                 & (steps <= wm_e))
    changed = torch.zeros_like(window_ok)
    changed[1:] = (wm_s[:-1] != wm_s[1:]) | (wm_e[:-1] != wm_e[1:])
    return energy_kwh, last, eff_c, window_ok, changed


def ev_episode_reference(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
                         bparams: torch.Tensor, curves: Sequence[torch.Tensor],
                         cparams: torch.Tensor, ch_curves: Sequence[torch.Tensor],
                         evparams: torch.Tensor, ev_curves: Sequence[torch.Tensor],
                         ch_bld: torch.Tensor, wm_bld: torch.Tensor,
                         state0: Sequence[torch.Tensor], hours_ratio: float, ratio: float,
                         ev_weights: Sequence[float], use_ev_reward: bool,
                         viol: torch.Tensor = None, penalty_coefficient: float = 1.0,
                         record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`ev_episode`: a loop over the S steps
    on (D, n) tensors, rounding every operation and ordering every sum as
    the kernel does."""
    a_bat, a_ev, a_wm = actions
    nsl, solar, price, carbon, conn, req, dep, force, drift, wm_s, wm_e, wm_l = series
    soc, eff, deg, evsoc, eveff, evdeg, wmi = state0
    S, B = a_bat.shape
    V = evsoc.shape[1]
    if viol is None:
        viol = torch.zeros_like(nsl)
    bld, wbld = ch_bld.tolist(), wm_bld.tolist()
    bld_t = ch_bld.long()
    maxc, minc, maxd, mind = (cparams[r] for r in (CH_MAXC, CH_MINC, CH_MAXD, CH_MIND))
    ch_cx, ch_cy, ch_dx, ch_dy = ch_curves
    ev_init = evparams[ROW_INIT]
    (w_ncc, w_bl, w_imposs, w_under, w_close, w_sc, w_esp) = ev_weights
    zero_v = torch.zeros_like(ev_init)
    rew = torch.zeros_like(soc)
    cost = torch.zeros_like(soc)
    emis = torch.zeros_like(soc)
    rec = []
    for t in range(S):
        # ---- EV SOC events: force, else drift, else the initial SOC at
        # t == 0 and 0 after; the charge reads them only at t == 0 ----
        f, dr = force[t], drift[t]
        soc_evented = torch.where(
            ~torch.isnan(f), f,
            torch.where(~torch.isnan(dr), torch.clamp(evsoc * dr, 0.0, 1.0),
                        ev_init if t == 0 else zero_v))
        soc_read = soc_evented if t == 0 else evsoc

        # ---- washing machines ----
        changed = ((wm_s[t - 1] != wm_s[t]) | (wm_e[t - 1] != wm_e[t]) if t > 0
                   else torch.zeros_like(wm_s[t], dtype=torch.bool))
        initiated = (wmi > 0.5) & ~changed
        trigger = (~initiated & (a_wm[t] > 0.0) & (wm_s[t] != -1.0) & (wm_e[t] != -1.0)
                   & (wm_s[t] <= float(t)) & (float(t) <= wm_e[t]))
        wm_cons = torch.where(trigger, wm_l[t].expand_as(wmi), torch.zeros_like(wmi))
        wmi = (initiated | trigger).to(torch.float32)

        # ---- building battery ----
        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, a_bat[t],
                                               hours_ratio, ratio)

        # ---- charger request (electric_vehicle_charger.py:252-329) ----
        a_c = a_ev[t]
        chg = a_c > 0.0
        energy_c = torch.where(
            chg,
            torch.maximum(torch.minimum(a_c * maxc * hours_ratio, maxc), minc),
            torch.maximum(torch.minimum(a_c * maxd * hours_ratio, -mind), -maxd))
        eff_c = torch.where(chg, _interp(torch.abs(a_c)[None], ch_cx, ch_cy)[0],
                            _interp(torch.abs(a_c)[None], ch_dx, ch_dy)[0])
        energy_kwh = torch.where(chg, energy_c * eff_c, energy_c / eff_c)

        # ---- the connected EV's battery event; a lane with no EV steps
        # EV 0 and drops the result ----
        connected = conn[t] >= 0
        gidx = torch.clamp(conn[t], min=0).long()
        newsoc_c, neweff_c, newdeg_c, bal_c = _battery.battery_event_energy(
            evparams[:, gidx], tuple(c[:, gidx] for c in ev_curves), soc_read[:, gidx],
            eveff[:, gidx], evdeg[:, gidx], energy_kwh, ratio)
        applied = (a_c != 0.0) & connected
        zero_c = torch.zeros_like(bal_c)
        bal_c = torch.where(applied, bal_c, zero_c)
        cons_c = torch.where(applied,
                             torch.where(bal_c >= 0.0, bal_c / eff_c, bal_c * eff_c), zero_c)
        last = torch.where(a_c != 0.0, energy_c, torch.zeros_like(energy_c))
        # write the applied charges back to their EVs; the others go to a
        # spare column that is dropped
        sidx = torch.where(applied, gidx, torch.full_like(gidx, V))
        put = lambda old, new: torch.cat([old, old[:, :1]], dim=1).index_copy(
            1, sidx, new)[:, :V]
        evsoc_n = put(soc_evented, newsoc_c)
        eveff_n = put(eveff, neweff_c)
        evdeg_n = put(evdeg, newdeg_c)

        # ---- accounting incl. the t == 0 multi-count ----
        chc_b = _segment_sum(cons_c, bld, B)
        wmc_b = _segment_sum(wm_cons, wbld, B)
        nsl_term = 3.0 * nsl[t] if t == 0 else nsl[t]
        bat_term = 2.0 * balance if t == 0 else balance
        net = nsl_term + bat_term + chc_b + wmc_b - solar[t]

        # ---- reward ----
        if use_ev_reward:
            neg = -net
            marl = torch.sign(neg) * 0.01 * (neg * neg) * torch.clamp(_tree_sum(net), min=0.0)
            mult = (1.0 / (1.0 + torch.abs(marl)))[:, bld_t]
            net_c = net[:, bld_t]
            g_cap, g_dod = evparams[ROW_CAP, gidx], evparams[ROW_DOD, gidx]
            soc_prev_c = (ev_init.expand_as(evsoc) if t == 0 else evsoc)[:, gidx]
            zero = torch.zeros_like(mult)
            cur_e = soc_prev_c * g_cap + last
            c_bl = torch.where((cur_e > g_cap) | (cur_e < (1.0 - g_dod) * g_cap),
                               w_bl * mult, zero)
            soc_diff = evsoc_n[:, gidx] - req[t]
            diff_kwh = soc_diff * g_cap
            mpc, mpd = maxc * dep[t], maxd * dep[t]
            c_imp = torch.where(diff_kwh > mpc, w_imposs * mult, zero)
            at_dep = dep[t] == 0.0
            c_under = torch.where(
                at_dep & (-0.25 < soc_diff) & (soc_diff <= -0.10), (2.0 * w_under) * mult,
                torch.where(at_dep & (soc_diff <= -0.25), (w_under * w_under) * mult, zero))
            c_close = torch.where(at_dep & (-0.10 < soc_diff) & (soc_diff <= 0.10),
                                  w_close * mult, zero)
            c_close = c_close + torch.where(
                torch.abs(diff_kwh) <= torch.maximum(mpc, mpd),
                w_close * mult * (1.0 / (dep[t] + 0.1)), zero)
            c_esp = torch.where((last > 0) & (net_c < 0), w_esp * mult,
                                torch.where((last < 0) & (net_c < 0),
                                            (-0.5 * w_esp) * mult, zero))
            c_sc = torch.where((last < 0) & (net_c > 0), w_sc * mult,
                               torch.where((last > 0) & (net_c > 0),
                                           (-0.5 * w_sc) * mult, zero))
            per_c = torch.where(connected, c_bl + c_imp + c_under + c_close + c_esp + c_sc,
                                zero)
            step_rew = _segment_sum(per_c, bld, B) \
                - penalty_coefficient * torch.clamp(viol[t], min=0.0)
        else:
            step_rew = -torch.clamp(net, min=0.0)

        if record:
            rec.append(torch.stack([net[0], balance[0], soc[0], chc_b[0], wmc_b[0],
                                    step_rew[0]]))
        rew = rew + step_rew
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
        evsoc, eveff, evdeg = evsoc_n, eveff_n, evdeg_n
    out = (rew, cost, emis, soc, eff, deg, evsoc, eveff, evdeg, wmi)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


def ev_district_reference(prelude: Sequence[torch.Tensor], actions: Sequence[torch.Tensor],
                          series: Sequence[torch.Tensor], bparams: torch.Tensor,
                          curves: Sequence[torch.Tensor], cparams: torch.Tensor,
                          evparams: torch.Tensor, ev_curves: Sequence[torch.Tensor],
                          ch_bld: torch.Tensor, wm_bld: torch.Tensor,
                          state0: Sequence[torch.Tensor], hours_ratio: float, ratio: float,
                          ev_weights: Sequence[float], use_ev_reward: bool,
                          viol: torch.Tensor = None, penalty_coefficient: float = 1.0,
                          record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel's district pass: the loop of
    :func:`ev_episode_reference` with each step's charger requests and
    machine window tests read from ``prelude``, the output of
    :func:`ev_prelude_reference`. Returns what :func:`ev_episode` returns."""
    energy_kwh_s, last_s, eff_c_s, window_ok_s, changed_s = prelude
    a_bat, a_ev, _ = actions
    nsl, solar, price, carbon, conn, req, dep, force, drift, _, _, wm_l = series
    soc, eff, deg, evsoc, eveff, evdeg, wmi = state0
    S, B = a_bat.shape
    V = evsoc.shape[1]
    if viol is None:
        viol = torch.zeros_like(nsl)
    bld, wbld = ch_bld.tolist(), wm_bld.tolist()
    bld_t = ch_bld.long()
    maxc, maxd = cparams[CH_MAXC], cparams[CH_MAXD]
    ev_init = evparams[ROW_INIT]
    (w_ncc, w_bl, w_imposs, w_under, w_close, w_sc, w_esp) = ev_weights
    zero_v = torch.zeros_like(ev_init)
    rew = torch.zeros_like(soc)
    cost = torch.zeros_like(soc)
    emis = torch.zeros_like(soc)
    rec = []
    for t in range(S):
        # ---- EV SOC events: force, else drift, else the initial SOC at
        # t == 0 and 0 after; the charge reads them only at t == 0 ----
        f, dr = force[t], drift[t]
        soc_evented = torch.where(
            ~torch.isnan(f), f,
            torch.where(~torch.isnan(dr), torch.clamp(evsoc * dr, 0.0, 1.0),
                        ev_init if t == 0 else zero_v))
        soc_read = soc_evented if t == 0 else evsoc

        # ---- washing machines ----
        initiated = (wmi > 0.5) & ~changed_s[t]
        trigger = ~initiated & window_ok_s[t]
        wm_cons = torch.where(trigger, wm_l[t].expand_as(wmi), torch.zeros_like(wmi))
        wmi = (initiated | trigger).to(torch.float32)

        # ---- building battery ----
        soc, eff, deg, balance = battery_event(bparams, curves, soc, eff, deg, a_bat[t],
                                               hours_ratio, ratio)

        # ---- charger request, from the prelude ----
        a_c = a_ev[t]
        energy_kwh, last, eff_c = energy_kwh_s[t], last_s[t], eff_c_s[t]

        # ---- the connected EV's battery event; a lane with no EV steps
        # EV 0 and drops the result ----
        connected = conn[t] >= 0
        gidx = torch.clamp(conn[t], min=0).long()
        newsoc_c, neweff_c, newdeg_c, bal_c = _battery.battery_event_energy(
            evparams[:, gidx], tuple(c[:, gidx] for c in ev_curves), soc_read[:, gidx],
            eveff[:, gidx], evdeg[:, gidx], energy_kwh, ratio)
        applied = (a_c != 0.0) & connected
        zero_c = torch.zeros_like(bal_c)
        bal_c = torch.where(applied, bal_c, zero_c)
        cons_c = torch.where(applied,
                             torch.where(bal_c >= 0.0, bal_c / eff_c, bal_c * eff_c), zero_c)
        # write the applied charges back to their EVs; the others go to a
        # spare column that is dropped
        sidx = torch.where(applied, gidx, torch.full_like(gidx, V))
        put = lambda old, new: torch.cat([old, old[:, :1]], dim=1).index_copy(
            1, sidx, new)[:, :V]
        evsoc_n = put(soc_evented, newsoc_c)
        eveff_n = put(eveff, neweff_c)
        evdeg_n = put(evdeg, newdeg_c)

        # ---- accounting incl. the t == 0 multi-count ----
        chc_b = _segment_sum(cons_c, bld, B)
        wmc_b = _segment_sum(wm_cons, wbld, B)
        nsl_term = 3.0 * nsl[t] if t == 0 else nsl[t]
        bat_term = 2.0 * balance if t == 0 else balance
        net = nsl_term + bat_term + chc_b + wmc_b - solar[t]

        # ---- reward ----
        if use_ev_reward:
            neg = -net
            marl = torch.sign(neg) * 0.01 * (neg * neg) * torch.clamp(_tree_sum(net), min=0.0)
            mult = (1.0 / (1.0 + torch.abs(marl)))[:, bld_t]
            net_c = net[:, bld_t]
            g_cap, g_dod = evparams[ROW_CAP, gidx], evparams[ROW_DOD, gidx]
            soc_prev_c = (ev_init.expand_as(evsoc) if t == 0 else evsoc)[:, gidx]
            zero = torch.zeros_like(mult)
            cur_e = soc_prev_c * g_cap + last
            c_bl = torch.where((cur_e > g_cap) | (cur_e < (1.0 - g_dod) * g_cap),
                               w_bl * mult, zero)
            soc_diff = evsoc_n[:, gidx] - req[t]
            diff_kwh = soc_diff * g_cap
            mpc, mpd = maxc * dep[t], maxd * dep[t]
            c_imp = torch.where(diff_kwh > mpc, w_imposs * mult, zero)
            at_dep = dep[t] == 0.0
            c_under = torch.where(
                at_dep & (-0.25 < soc_diff) & (soc_diff <= -0.10), (2.0 * w_under) * mult,
                torch.where(at_dep & (soc_diff <= -0.25), (w_under * w_under) * mult, zero))
            c_close = torch.where(at_dep & (-0.10 < soc_diff) & (soc_diff <= 0.10),
                                  w_close * mult, zero)
            c_close = c_close + torch.where(
                torch.abs(diff_kwh) <= torch.maximum(mpc, mpd),
                w_close * mult * (1.0 / (dep[t] + 0.1)), zero)
            c_esp = torch.where((last > 0) & (net_c < 0), w_esp * mult,
                                torch.where((last < 0) & (net_c < 0),
                                            (-0.5 * w_esp) * mult, zero))
            c_sc = torch.where((last < 0) & (net_c > 0), w_sc * mult,
                               torch.where((last > 0) & (net_c > 0),
                                           (-0.5 * w_sc) * mult, zero))
            per_c = torch.where(connected, c_bl + c_imp + c_under + c_close + c_esp + c_sc,
                                zero)
            step_rew = _segment_sum(per_c, bld, B) \
                - penalty_coefficient * torch.clamp(viol[t], min=0.0)
        else:
            step_rew = -torch.clamp(net, min=0.0)

        if record:
            rec.append(torch.stack([net[0], balance[0], soc[0], chc_b[0], wmc_b[0],
                                    step_rew[0]]))
        rew = rew + step_rew
        cost = cost + net * price[t]
        emis = emis + torch.clamp(net * carbon[t], min=0.0)
        evsoc, eveff, evdeg = evsoc_n, eveff_n, evdeg_n
    out = (rew, cost, emis, soc, eff, deg, evsoc, eveff, evdeg, wmi)
    if record:
        out = out + (torch.stack(rec, dim=1),)
    return out


@functools.cache
def _launcher():
    fn = _build.load("ev_episode").ev_episode_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@tracing.traced("ev_episode")
def ev_episode(actions: Sequence[torch.Tensor], series: Sequence[torch.Tensor],
               bparams: torch.Tensor, curves: Sequence[torch.Tensor],
               cparams: torch.Tensor, ch_curves: Sequence[torch.Tensor],
               evparams: torch.Tensor, ev_curves: Sequence[torch.Tensor],
               ch_bld: torch.Tensor, wm_bld: torch.Tensor,
               state0: Sequence[torch.Tensor], hours_ratio: float, ratio: float,
               ev_weights: Sequence[float], use_ev_reward: bool,
               viol: torch.Tensor = None, penalty_coefficient: float = 1.0,
               record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a full S-step episode for a (D, ...) EV district batch.

    ``actions``: (electrical_storage (S, B), electric_vehicle_storage
    (S, C), washing_machine (S, W)) open-loop plans shared by the
    districts; ``series``: (nsl, solar, price, carbon) (S, B), (connected
    EV index int32 with -1 for none, required SOC, hours to departure)
    (S, C), (force, drift) (S, V) with NaN for no event, (window start,
    window end, triggered load) (S, W); ``bparams``/``curves`` and
    ``evparams``/``ev_curves``: battery tables of the buildings and of the
    EVs as :func:`ops.battery.battery_episode` takes them; ``cparams``:
    (N_CROWS, C) power limits; ``ch_curves``: (charge x, charge y,
    discharge x, discharge y) efficiency knots (knots, C); ``ch_bld`` (C,)
    and ``wm_bld`` (W,): int32 building of each charger and machine;
    ``state0``: (soc, eff, degraded) (D, B), (EV soc, eff, degraded)
    (D, V), machine flag (D, W); ``ev_weights``: the seven weights of the
    EV reward, used when ``use_ev_reward``; ``viol``: (S, B) violation kWh,
    0 when absent.

    Returns (reward_sum, cost_sum, emission_sum, soc, eff, degraded) each
    (D, B), the EV triple (D, V), the machine flag (D, W) and, with
    ``record=True``, an (N_EREC, S, B) per-step stream of district 0's
    (net, raw battery balance, battery soc, charger and machine
    consumption, reward).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    soc0 = state0[0]
    if soc0.device.type == "cpu":
        return ev_episode_reference(actions, series, bparams, curves, cparams, ch_curves,
                                    evparams, ev_curves, ch_bld, wm_bld, state0, hours_ratio,
                                    ratio, ev_weights, use_ev_reward, viol,
                                    penalty_coefficient, record)
    if soc0.device.type != "cuda":
        raise ValueError(f"ev_episode runs on CPU or CUDA tensors, not {soc0.device}")
    if (len(actions), len(series), len(curves), len(ch_curves), len(ev_curves),
            len(state0), len(ev_weights)) != (3, 12, 4, 4, 4, 7, 7):
        raise ValueError("ev_episode takes 3 plans, 12 series, 3 x 4 curves, 7 states "
                         "and 7 reward weights")
    S, B = actions[0].shape
    C, W = actions[1].shape[1], actions[2].shape[1]
    D, V = state0[3].shape
    if not 1 <= B <= MAX_LANES or max(C, V, W) > MAX_LANES:
        raise ValueError(f"ev_episode takes 1 to {MAX_LANES} buildings and up to {MAX_LANES} "
                         f"chargers, EVs and machines, got {B}, {C}, {V}, {W}")
    if C > 0 and V == 0:
        raise ValueError("ev_episode needs an EV for its chargers to connect")
    n_knots, ev_knots, ch_knots = curves[0].shape[0], ev_curves[0].shape[0], ch_curves[0].shape[0]
    if viol is None:
        viol = torch.zeros_like(series[0])
    f32, i32 = torch.float32, torch.int32
    inputs = [*actions, viol, *series, bparams, *curves, cparams, *ch_curves, evparams,
              *ev_curves, ch_bld, wm_bld, *state0]
    wants = ([((S, B), f32), ((S, C), f32), ((S, W), f32)] + [((S, B), f32)] * 5
             + [((S, C), i32)] + [((S, C), f32)] * 2 + [((S, V), f32)] * 2 + [((S, W), f32)] * 3
             + [((8, B), f32)] + [((n_knots, B), f32)] * 4
             + [((N_CROWS, C), f32)] + [((ch_knots, C), f32)] * 4
             + [((8, V), f32)] + [((ev_knots, V), f32)] * 4
             + [((C,), i32), ((W,), i32)]
             + [((D, B), f32)] * 3 + [((D, V), f32)] * 3 + [((D, W), f32)])
    for x, (shape, dtype) in zip(inputs, wants):
        if x.device != soc0.device or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"ev_episode wants contiguous {dtype} {shape} on {soc0.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    for knots in (n_knots, ev_knots, ch_knots):
        if not 2 <= knots <= MAX_KNOTS:
            raise ValueError(f"ev_episode takes 2 to {MAX_KNOTS} curve knots, got {knots}")
    new = lambda *shape: torch.empty(shape, dtype=f32, device=soc0.device)
    outs = [new(D, B) for _ in range(6)] + [new(D, V) for _ in range(3)] + [new(D, W)]
    rec = new(N_EREC, S, B) if record else None
    row = -(-sum(k * n for k, n in zip(STAGE_ROWS, (B, C, V, W))) // 4) * 4
    stage = new(S, row)
    (w_ncc, w_bl, w_imposs, w_under, w_close, w_sc, w_esp) = (float(w) for w in ev_weights)
    ptrs = [x.data_ptr() for x in inputs + outs] + [None if rec is None else rec.data_ptr(),
                                                    stage.data_ptr()]
    dims = [D, B, C, V, W, S, n_knots, ev_knots, ch_knots, int(bool(use_ev_reward)), row]
    scalars = [hours_ratio, ratio, penalty_coefficient, w_bl, w_imposs, 2.0 * w_under,
               w_under * w_under, w_close, w_esp, -0.5 * w_esp, w_sc, -0.5 * w_sc]
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(soc0.device):
        stream = torch.cuda.current_stream(soc0.device).cuda_stream
        err = _launcher()((ctypes.c_void_p * len(ptrs))(*ptrs),
                          (ctypes.c_int * len(dims))(*dims),
                          (ctypes.c_float * len(scalars))(*scalars), stream)
    if err != 0:
        raise RuntimeError(f"ev_episode kernel launch failed: CUDA error {err}")
    ev_episode.launches += 1
    return tuple(outs) + ((rec,) if record else ())


ev_episode.launches = 0
