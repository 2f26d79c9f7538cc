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

The training path runs too, on every family: ``train.BatchedSAC`` trains
per-building SAC agents (``agents.sac``, networks stacked over the agent
axis) on thousands of district copies, encoding observations with
``core.obs_encoder`` and collecting experience either step by step or, on
battery+PV districts, in chunks whose battery recurrence is one launch of
the hand-written collect kernel K2 (``ops.collect``);
``train_marlisa.BatchedMARLISA`` adds MARLISA's coordination ring and
streaming ridge regression on top of it.

The Gymnasium surface runs on every family too: ``CityLearnEnv``
(``envs.environment``) steps one district through ``core.step`` with one
host copy per step, with the reference's observations, rewards, building
views (``envs.views``), CSV renderer (``envs.render``), episode splits
(``envs.episode``) and ``evaluate()`` table, and with the float64 parity
mode (``parity_f64=True``) that tracks the reference's float64 arithmetic
and float32 stores.

The user's entry point runs on it: ``cli`` (``simulate <schema or
dataset name> train|evaluate [--fast]``, ``list_datasets``; ``--fast``
evaluates an open-loop agent's episode as one launch of the family's
kernel), the dataset catalog ``data.DataSet`` (local roots only), the
host-loop agents of ``agents`` (rule-based, SAC, tabular Q-learning,
MARLISA), the observation encoders of ``preprocessing`` and the Gym
wrappers of ``wrappers``. Without gymnasium the env's spaces are
``spaces.Box``.

Districts shard over GPUs, one process per GPU under ``torch.distributed``
(``parallel``: ``initialize_distributed``, ``district_mesh``,
``shard_district_batch``): the ``run_*_episode`` functions,
``evaluate_scripted``, ``BatchedSAC`` and ``BatchedMARLISA`` take
``mesh=``, and each rank runs its share of the districts on its card.

``tracing`` records spans at the trainer's, the update's,
the Gym step's and the kernel wrappers' boundaries inside a
``tracing.recording()`` block or a ``utilities.Profiler``; off, the
default, a span is one flag test.

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
    "BatchedMARLISA": "citylearn_tpu_torch.train_marlisa",
    "CityLearnEnv": "citylearn_tpu_torch.envs.environment",
    "EvaluationCondition": "citylearn_tpu_torch.envs.views",
    "initialize_distributed": "citylearn_tpu_torch.parallel.mesh",
    "district_mesh": "citylearn_tpu_torch.parallel.mesh",
    "shard_district_batch": "citylearn_tpu_torch.parallel.mesh",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default (the
    current one); a device named with an index, such as a rank's
    ``cuda:1``, keeps it.

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
