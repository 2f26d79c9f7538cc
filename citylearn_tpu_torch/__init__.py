"""citylearn_tpu_torch: the PyTorch/CUDA port of ``citylearn_tpu``.

Six district families run end to end: battery+PV (the shape of
``citylearn_challenge_2022_phase_1``), thermal storage (cooling, heating
and DHW devices and tanks plus battery and PV, ``citylearn_challenge_2021``),
EV chargers with electric vehicles and washing machines
(``citylearn_challenge_2022_phase_all_plus_evs``), LSTM temperature dynamics
with partial-load control and power outages
(``citylearn_challenge_2023_phase_1``), and the EULP county neighborhoods and
the quebec occupant sets (heterogeneous LSTM buildings, occupant thermostat
interaction). Each compiles from a schema (``compiler``), packs into tensors
(``core.params``), steps and rolls out in batches of districts
(``core.step``, ``core.rollout``), scores with the normalized KPI table
(``core.evaluate``), and runs whole open-loop episodes as one hand-written
CUDA kernel launch (``core.rollout_fast``, ``core.evaluate_fast``): K1
``ops.battery``, K3 ``ops.thermal``, K4 ``ops.ev``, K5 ``ops.lstm`` and K6
``ops.neighborhood``, whose temperature and occupant sequence runs once per
district in the post-pass kernel P6 ``ops.postpass``.

The training path runs too: ``train.BatchedSAC`` trains per-building SAC
agents (``agents.sac``, networks stacked over the agent axis) on
thousands of district copies, encoding observations with
``core.obs_encoder`` and collecting experience either step by step or in
chunks whose battery recurrence is one launch of the hand-written
collect kernel K2 (``ops.collect``).

The package imports ``torch`` and never ``jax`` nor the JAX package.
Entry points take a ``device`` argument: ``None`` means the CUDA card,
and raises when there is none; pass ``device="cpu"`` to run the plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import importlib

import torch

__version__ = "0.1.0"

_EXPORTS = {
    "compile_schema": "citylearn_tpu_torch.compiler.schema",
    "pack": "citylearn_tpu_torch.core.params",
    "initial_state": "citylearn_tpu_torch.core.params",
    "batched_initial_states": "citylearn_tpu_torch.core.rollout",
    "rollout_districts": "citylearn_tpu_torch.core.rollout",
    "hour_rbc_policy": "citylearn_tpu_torch.core.rollout",
    "evaluate_districts": "citylearn_tpu_torch.core.evaluate",
    "run_battery_episode": "citylearn_tpu_torch.core.rollout_fast",
    "run_thermal_episode": "citylearn_tpu_torch.core.rollout_fast",
    "run_ev_episode": "citylearn_tpu_torch.core.rollout_fast",
    "run_lstm_episode": "citylearn_tpu_torch.core.rollout_fast",
    "run_neighborhood_episode": "citylearn_tpu_torch.core.rollout_fast",
    "ScriptedPolicy": "citylearn_tpu_torch.core.evaluate_fast",
    "evaluate_scripted": "citylearn_tpu_torch.core.evaluate_fast",
    "BatchedSAC": "citylearn_tpu_torch.train",
    "TrainConfig": "citylearn_tpu_torch.train",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default.

    Raises when no card is present and no device was named, so that a
    run meant for the card never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
