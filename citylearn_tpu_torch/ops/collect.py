"""K2: K closed-loop battery+PV steps of a district batch, the env
recurrence of the batched SAC trainer's chunked collect.

:func:`battery_collect_chunk` replaces ``citylearn_tpu/ops/pallas_collect.py::
battery_collect_chunk``. The trainer's policy reads only the data-driven
observation rows, so a chunk of K steps factors into one batched policy
sweep over the whole chunk (matrix products, outside any kernel) and
this sequential recurrence. On CUDA tensors the wrapper launches the
hand-written kernel ``csrc/battery_collect.cu``: one thread per
(district, building) runs the K steps with its battery state in
registers. On CPU tensors it runs :func:`battery_collect_chunk_reference`,
the plain PyTorch version, which the tests and ``chip_smoke.py`` hold
the kernel against.

Layout: the streams are (K, D, B) contiguous and the state (D, B). The
JAX package's ``d_last`` option and its padding of B to a multiple of 8
keep districts on TPU lanes; on the GPU the (K, D, B) layout already
makes a warp's accesses of one step contiguous, so the port takes this
one layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from citylearn_tpu_torch.core.rollout_fast import battery_tables
from citylearn_tpu_torch.core.types import DistrictParams, StaticConfig
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops.battery import MAX_KNOTS, battery_event, operation_count


class CollectPrep(NamedTuple):
    """Battery parameters in the kernel's layout, built once per trainer
    by :func:`prepare_battery_collect`."""
    bparams: torch.Tensor     # (8, B) rows as ops/battery.battery_episode's
    curves: tuple             # (pec_x, pec_y, cpc_x, cpc_y), each (n_knots, B)
    hours_ratio: float
    ratio: float


def prepare_battery_collect(cfg: StaticConfig, params: DistrictParams) -> CollectPrep:
    """Pack the battery parameters and knot-major curves, with repeated
    tail knots trimmed, on the device of ``params``."""
    bparams, curves = battery_tables(params.battery)
    return CollectPrep(bparams=bparams, curves=curves,
                       hours_ratio=float(cfg.seconds_per_time_step / 3600.0),
                       ratio=float(cfg.time_step_ratio))


def collect_operation_count(prep: CollectPrep, actions: torch.Tensor) -> int:
    """fp32 operations of one launch on these actions: K1's count per
    building-step (:func:`ops.battery.operation_count`) less its cost and
    emission sums (5 operations); K1's reward sum (max, subtract) and
    K2's reward (max, negate) count the same."""
    n_knots = prep.curves[0].shape[0]
    K, D, B = actions.shape
    return operation_count(actions.reshape(K * D, B), n_knots, 1) - 5 * actions.numel()


def battery_collect_chunk_reference(prep: CollectPrep, actions: torch.Tensor,
                                    nsl: torch.Tensor, solar: torch.Tensor,
                                    soc: torch.Tensor, eff: torch.Tensor,
                                    deg: torch.Tensor, *, first_chunk: bool
                                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`battery_collect_chunk`: a loop over
    the K steps on (D, B) tensors, rounding every operation as the kernel
    does."""
    rewards = []
    for k in range(actions.shape[0]):
        soc, eff, deg, balance = battery_event(prep.bparams, prep.curves, soc, eff, deg,
                                               actions[k], prep.hours_ratio, prep.ratio)
        t0 = first_chunk and k == 0
        nsl_term = 3.0 * nsl[k] if t0 else nsl[k]
        bat_term = 2.0 * balance if t0 else balance
        net = nsl_term + bat_term - solar[k]
        rewards.append(-torch.clamp(net, min=0.0))
    return torch.stack(rewards), soc, eff, deg


_PTR = ctypes.c_void_p


@functools.cache
def _launcher():
    fn = _build.load("battery_collect").battery_collect_launch
    fn.argtypes = ([_PTR] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_int, _PTR])
    fn.restype = ctypes.c_int
    return fn


def battery_collect_chunk(prep: CollectPrep, actions: torch.Tensor, nsl: torch.Tensor,
                          solar: torch.Tensor, soc: torch.Tensor, eff: torch.Tensor,
                          deg: torch.Tensor, *, first_chunk: bool
                          ) -> Tuple[torch.Tensor, ...]:
    """Run ``K`` closed-loop env steps for a (D, B) district batch.

    ``actions`` (electrical_storage fractions), ``nsl`` and ``solar`` are
    (K, D, B) float32 per-district streams, the series gathered at each
    district's episode rows; ``soc``/``eff``/``deg`` the (D, B) battery
    state entering the chunk. ``first_chunk`` applies the t == 0
    triple/double count at k == 0. Returns the per-step reward
    ``-max(net, 0)`` (K, D, B) and the final (soc, eff, deg), each (D, B).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    and anything else raises.
    """
    if soc.device.type == "cpu":
        return battery_collect_chunk_reference(prep, actions, nsl, solar, soc, eff, deg,
                                               first_chunk=first_chunk)
    if soc.device.type != "cuda":
        raise ValueError(f"battery_collect_chunk runs on CPU or CUDA tensors, "
                         f"not {soc.device}")
    K, D, B = actions.shape
    n_knots = prep.curves[0].shape[0]
    inputs = [actions, nsl, solar, prep.bparams, *prep.curves, soc, eff, deg]
    shapes = [(K, D, B)] * 3 + [(8, B)] + [(n_knots, B)] * 4 + [(D, B)] * 3
    for x, shape in zip(inputs, shapes):
        if x.device != soc.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"battery_collect_chunk wants contiguous float32 {shape} on "
                             f"{soc.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 2 <= n_knots <= MAX_KNOTS:
        raise ValueError(f"battery_collect_chunk takes 2 to {MAX_KNOTS} curve knots, "
                         f"got {n_knots}")
    reward = torch.empty((K, D, B), dtype=torch.float32, device=soc.device)
    state = [torch.empty((D, B), dtype=torch.float32, device=soc.device) for _ in range(3)]
    # the launch function runs on the CUDA runtime's current device:
    # make it the tensors' card
    with torch.cuda.device(soc.device):
        stream = torch.cuda.current_stream(soc.device).cuda_stream
        err = _launcher()(*[x.data_ptr() for x in inputs + [reward] + state],
                          D, B, K, n_knots, prep.hours_ratio, prep.ratio, int(first_chunk),
                          stream)
    if err != 0:
        raise RuntimeError(f"battery_collect_chunk kernel launch failed: CUDA error {err}")
    battery_collect_chunk.launches += 1
    return (reward, *state)


battery_collect_chunk.launches = 0
