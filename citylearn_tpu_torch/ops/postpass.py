"""P6: the temperature and occupant post-pass of the neighborhood family.

:func:`neighborhood_postpass` replaces the single-district ``lax.scan`` of
``citylearn_tpu/core/neighborhood_eval.py::temp_setpoint_series`` (there is
no Pallas kernel behind it): over the S steps of one district it runs the
LSTM temperature prediction of every building (reference
``building.py:2935-3078``) on the demand observations that K6 recorded, then
the occupant thermostat interaction (``building.py:3160-3353``) on the
predicted temperature. Under open-loop plans both are the same for every
district, so they run once, not D times.

On CUDA tensors it launches the hand-written kernel
``csrc/neighborhood_postpass.cu``: a block per building runs all S steps,
a thread per gate row of each layer (:func:`block_threads`), the hidden
vectors exchanged through shared memory with one barrier per window
position, layer 1 of one position beside layer 2 of the one before; the
bias and static channels' products once per row and the dynamic channels,
staged in shared memory a chunk of steps at a time, the head a warp-shuffle
reduction, then on one thread the logistic interaction probability, the
decision-tree walk, the hold counter and the NaN-coded set-point
overrides. What bounds it is the chain of 2 x lookback dependent cells a
step, ~10-16 ms for a year, far above its operations bound. Buildings
never couple, so blocks never meet. On CPU tensors the wrapper runs
:func:`neighborhood_postpass_reference`, the plain version: a step loop over
the port's own :func:`core.step.dynamics_update` and
:func:`core.step.occupant_update`, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.core.params import initial_state
from citylearn_tpu_torch.core.rollout_fast import lstm_tables
from citylearn_tpu_torch.core.step import OCC_FIELDS, dynamics_update, occupant_update
from citylearn_tpu_torch.core.types import DistrictParams, StaticConfig
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops.lstm import (
    M_COOL_CH,
    M_HEAT_CH,
    M_HIDDEN,
    M_TEMP_CH,
    MAX_CHANNELS,
    MAX_HIDDEN,
    MAX_LOOKBACK,
    LstmWeights,
    pack_weights,
    static_width,
)

# post-pass parameter rows (prows, (N_PROWS, B)): normalization minimum
# and span of the temperature, cooling- and heating-demand channels, and
# the head's bias
(P_NMIN_TC, P_NSPAN_TC, P_NMIN_CC, P_NSPAN_CC, P_NMIN_HC, P_NSPAN_HC, P_LIN_B,
 N_PROWS) = range(8)
# rows of ``occ_end``: the data at the episode's final row, which the
# occupant update reads at t == 0
(E_TEMP, E_CSP, E_HSP, N_EROWS) = range(4)


class OccState(NamedTuple):
    """The occupant carry after the last step, (1, B) each, with the
    window's ``data_offset`` (1,): what :func:`core.step.occupant_update`
    and :func:`core.evaluate.kpi_table`'s final-row patch read."""
    data_offset: torch.Tensor
    occ_csp_override: torch.Tensor
    occ_hsp_override: torch.Tensor
    occ_hold_counter: torch.Tensor
    occ_prev_temp: torch.Tensor
    occ_prev_csp: torch.Tensor
    occ_prev_hsp: torch.Tensor


def _dynamic_channels(unit) -> int:
    """How many of the temperature, cooling- and heating-demand channels a
    building of :class:`LstmWeights` ``units`` reads."""
    return sum(unit[k] >= 0 for k in (M_TEMP_CH, M_COOL_CH, M_HEAT_CH))


def operation_count(weights: LstmWeights, lookback: int, n_steps: int) -> int:
    """fp32 operations the kernel executes over ``n_steps`` steps for the
    buildings of ``weights`` on a district without occupants. Per building
    and row of the static stream that a window reads (rows 1 to S - 1 once
    ``n_steps > lookback``): ``2 * 4H`` per static channel for layer 1's
    static products. Per building-step from ``t >= lookback`` on:
    ``lookback`` cells per layer, each ``2 * 4H * (n_in + H)`` for the gate
    products (``n_in``: layer 1's dynamic channels, layer 2's H inputs), 4H
    gate activations, H for ``tanh(c)`` and 4H for the new (c, h); the
    head's 2H + 2. Per building-step: 6 for the normalizations."""
    total = 0
    for u in weights.units:
        L, H, F = u[:3]
        n_dyn = _dynamic_channels(u)
        cell = 2 * 4 * H * (n_dyn + H) + 9 * H
        if L == 2:
            cell += 2 * 4 * H * (H + H) + 9 * H
        windows = max(n_steps - lookback, 0)
        rows = n_steps - 1 if windows else 0
        total += windows * (lookback * cell + 2 * H + 2) + rows * 2 * 4 * H * (F - n_dyn)
    return total + len(weights.units) * n_steps * 6


def block_threads(weights: LstmWeights) -> int:
    """Threads per block of the kernel's launch: a thread per gate row of
    the widest building's layer, rounded up to whole warps."""
    widest = max(u[M_HIDDEN] for u in weights.units)
    return (4 * widest + 31) // 32 * 32


def neighborhood_postpass_reference(cfg: StaticConfig, params: DistrictParams,
                                    cool_obs: torch.Tensor, heat_obs: torch.Tensor,
                                    n_steps: int, data_offset: int = 0
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                               Optional[OccState]]:
    """Plain PyTorch version of :func:`neighborhood_postpass`: a loop over
    the S steps of one district through :func:`core.step.dynamics_update`
    and :func:`core.step.occupant_update`. The LSTM carry starts from the
    initial state at offset 0, while ``data_offset`` reaches the occupant
    update through its state, as in the JAX package's post-pass."""
    dev = cool_obs.device
    init = initial_state(cfg, params, 0)
    one = lambda x: x[None]
    lstm_h, lstm_c, dyn_input = (tuple(one(x) for x in v)
                                 for v in (init.lstm_h, init.lstm_c, init.dyn_input))
    off = torch.tensor([int(data_offset)], dtype=torch.int32, device=dev)
    occ = {f: one(getattr(init, f)) for f in OCC_FIELDS}
    ser = params.series
    temps, csps, hsps = [], [], []
    for t in range(int(n_steps)):
        tau = int(data_offset) + t
        step = torch.tensor([t], dtype=torch.int32, device=dev)
        temp_t, lstm_h, lstm_c, dyn_input = dynamics_update(
            cfg, params, torch.tensor([tau], device=dev), step, cool_obs[t][None],
            heat_obs[t][None], ser.indoor_dry_bulb_temperature[tau][None],
            lstm_h, lstm_c, dyn_input)
        csp = ser.indoor_dry_bulb_temperature_cooling_set_point[tau][None]
        hsp = ser.indoor_dry_bulb_temperature_heating_set_point[tau][None]
        if cfg.has_occupant:
            csp, hsp, occ = occupant_update(cfg, params, OccState(data_offset=off, **occ), csp,
                                            hsp, ser.hvac_mode[tau][None], temp_t, step)
        temps.append(temp_t[0])
        csps.append(csp[0])
        hsps.append(hsp[0])
    final = OccState(data_offset=off, **occ) if cfg.has_occupant else None
    return torch.stack(temps), torch.stack(csps), torch.stack(hsps), final


def postpass_inputs(cfg: StaticConfig, params: DistrictParams, cool_obs: torch.Tensor,
                    heat_obs: torch.Tensor, n_steps: int, data_offset: int = 0) -> dict:
    """Keyword arguments of :func:`postpass_kernel` for one district's
    window ``[data_offset, data_offset + n_steps)``, on the device of
    ``params``."""
    S, off = int(n_steps), int(data_offset)
    dev = params.device
    units, buildings, schan, rows = lstm_tables(cfg, params, S, off)
    prows = np.stack([rows[k] for k in ("nmin_tc", "nspan_tc", "nmin_cc", "nspan_cc",
                                         "nmin_hc", "nspan_hc", "lin_b")])
    ser = params.series
    win = lambda x: x[off:off + S].to(torch.float32).contiguous()
    inputs = dict(
        weights=pack_weights(buildings, dev),
        prows=torch.tensor(prows, device=dev),
        schan=torch.tensor(schan, device=dev),
        series=(cool_obs.to(dev, torch.float32).contiguous(),
                heat_obs.to(dev, torch.float32).contiguous(),
                win(ser.indoor_dry_bulb_temperature),
                win(ser.indoor_dry_bulb_temperature_cooling_set_point),
                win(ser.indoor_dry_bulb_temperature_heating_set_point),
                win(ser.hvac_mode)),
        lookback=units[0]["lookback"], occupant=None)
    if cfg.has_occupant:
        occ = params.occupant
        end = off + cfg.time_steps - 1
        if S > occ.a_increase.shape[0] or S > occ.random_probability.shape[0]:
            raise IndexError(f"the occupant series hold {occ.a_increase.shape[0]} steps, "
                             f"fewer than {S}")
        ep = lambda x: x[:S].contiguous()
        inputs["occupant"] = dict(
            logistic=tuple(ep(x) for x in (occ.a_increase, occ.b_increase, occ.a_decrease,
                                            occ.b_decrease)),
            rand=ep(occ.random_probability),
            end=torch.stack([ser.indoor_dry_bulb_temperature[end],
                             ser.indoor_dry_bulb_temperature_cooling_set_point[end],
                             ser.indoor_dry_bulb_temperature_heating_set_point[end]]),
            trees=tuple(x.contiguous() for x in (
                occ.tree_children_left, occ.tree_children_right, occ.tree_feature,
                occ.tree_threshold, occ.tree_delta)),
            hold=occ.hold_time_steps.contiguous(), gate=occ.lookback.contiguous(),
            depth=int(cfg.occupant_tree_depth), data_offset=off)
    return inputs


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("neighborhood_postpass").neighborhood_postpass_launch
    fn.argtypes = [_PTR] * 32 + [ctypes.c_int] * 7 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


@tracing.traced("postpass_kernel")
def postpass_kernel(weights: LstmWeights, prows: torch.Tensor, schan: torch.Tensor,
                    series, lookback: int, occupant: Optional[dict] = None):
    """Launch P6 on the tensors of :func:`postpass_inputs` (all on one CUDA
    device). ``series``: (cooling observation, heating observation, indoor
    temperature, cooling and heating set point, hvac_mode), each (S, B);
    ``occupant`` (None on a district without occupants): the logistic
    parameters (4 x (S, B)), the uniforms (S,), the data at the episode's
    final row (N_EROWS, B), the trees' node arrays (B, 2, N) (children,
    feature as int32, threshold and delta as float32), the hold times and
    warm-up gates (B,) int32 and the trees' depth. Returns (temperature,
    cooling set point, heating set point) each (S, B) and the final
    :class:`OccState` (None without occupants)."""
    dev = schan.device
    if dev.type != "cuda":
        raise ValueError(f"the post-pass kernel runs on CUDA tensors, not {dev}")
    S, B = series[0].shape
    X = static_width(weights)
    if len(weights.units) != B:
        raise ValueError(f"the post-pass got weights of {len(weights.units)} buildings for {B}")
    for L, H, F, tc, *_ in weights.units:
        if L not in (1, 2) or not 1 <= H <= MAX_HIDDEN or not 2 <= F <= MAX_CHANNELS \
                or not 0 <= tc < F:
            raise ValueError(
                f"the post-pass takes 1 or 2 layers of up to {MAX_HIDDEN} units over up to "
                f"{MAX_CHANNELS} channels with a temperature channel, got {L} layers, {H} "
                f"units, {F} channels, temperature channel {tc}")
    if not 1 <= lookback <= MAX_LOOKBACK:
        raise ValueError(f"the post-pass takes a lookback of 1 to {MAX_LOOKBACK}, got {lookback}")
    f32 = [(weights.flat, tuple(weights.flat.shape)), (prows, (N_PROWS, B)), (schan, (S, X))]
    f32 += [(x, (S, B)) for x in series]
    i32 = [(weights.meta, tuple(weights.meta.shape))]
    occ_ptrs = [None] * 13
    depth = n_nodes = 0
    if occupant is not None:
        n_nodes = occupant["trees"][0].shape[-1]
        depth = occupant["depth"]
        f32 += [(x, (S, B)) for x in occupant["logistic"]]
        f32 += [(occupant["rand"], (S,)), (occupant["end"], (N_EROWS, B))]
        f32 += [(x, (B, 2, n_nodes)) for x in occupant["trees"][3:]]
        i32 += [(x, (B, 2, n_nodes)) for x in occupant["trees"][:3]]
        i32 += [(occupant["hold"], (B,)), (occupant["gate"], (B,))]
        occ_ptrs = [x.data_ptr() for x in (
            *occupant["logistic"], occupant["rand"], occupant["end"], *occupant["trees"],
            occupant["hold"], occupant["gate"])]
    for checks, dtype in ((f32, torch.float32), (i32, torch.int32)):
        for x, shape in checks:
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                    or not x.is_contiguous():
                raise ValueError(f"the post-pass wants contiguous {dtype} {shape} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = [torch.empty((S, B), dtype=torch.float32, device=dev) for _ in range(3)]
    final = [torch.empty((1, B), dtype=torch.float32, device=dev) for _ in range(5)]
    counter = torch.empty((1, B), dtype=torch.int32, device=dev)
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(weights.flat.data_ptr(), weights.meta.data_ptr(), prows.data_ptr(),
                          schan.data_ptr(), *[x.data_ptr() for x in series], *occ_ptrs,
                          *[x.data_ptr() for x in out], final[0].data_ptr(), final[1].data_ptr(),
                          counter.data_ptr(), *[x.data_ptr() for x in final[2:]],
                          B, S, X, lookback, n_nodes, depth, block_threads(weights),
                          stream)
    if err != 0:
        raise RuntimeError(f"the post-pass kernel launch failed: CUDA error {err}")
    postpass_kernel.launches += 1
    state = None
    if occupant is not None:
        off = torch.tensor([occupant["data_offset"]], dtype=torch.int32, device=dev)
        state = OccState(off, final[0], final[1], counter, *final[2:])
    return (*out, state)


postpass_kernel.launches = 0


def neighborhood_postpass(cfg: StaticConfig, params: DistrictParams, cool_obs: torch.Tensor,
                          heat_obs: torch.Tensor, n_steps: int, data_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     Optional[OccState]]:
    """Temperature and effective set-point series of ONE district over the
    window ``[data_offset, data_offset + n_steps)``.

    ``cool_obs``, ``heat_obs``: (S, B) demand observations (device output
    plus storage discharge, ``building.py:1435-1437``; K6's ``R_COUT`` and
    ``R_HOUT`` rows, the tanks being inert on this family). Returns
    ``(temperature, cooling set point, heating set point)``, each (S, B),
    and the occupant carry after the last step for
    :func:`core.evaluate.kpi_table`'s final-row patch (None without
    occupants).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises."""
    if cool_obs.device.type == "cpu":
        return neighborhood_postpass_reference(cfg, params, cool_obs, heat_obs, n_steps,
                                               data_offset)
    if cool_obs.device.type != "cuda":
        raise ValueError(f"the post-pass runs on CPU or CUDA tensors, not {cool_obs.device}")
    return postpass_kernel(**postpass_inputs(cfg, params, cool_obs, heat_obs, n_steps,
                                             data_offset))
