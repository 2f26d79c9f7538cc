#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them: the
battery+PV district's evaluation (kernel K1) and training (K2), the
thermal-storage district's evaluation (K3), the EV district's (K4), the
LSTM-dynamics district's (K5) and the neighborhood districts' (K6 and the
post-pass P6), then training on every family and batched MARLISA, the Gym
env, the user's entry point, ``citylearn_tpu_torch.cli``, with the
host-loop agents, the district mesh over ranks of ``torch.distributed``,
and last the autosized districts, the debug physics checks, the profiler
and dataset generation with LSTM training on the card.

    python3 chip_smoke.py [--json PATH]
    python3 chip_smoke.py --cards N [--json PATH]   # phase 30(c) alone, on N cards

Phases, each of which raises on failure:
  1. the device: name, count, torch and CUDA versions, nvidia-smi;
  2. build every CUDA kernel from ``citylearn_tpu_torch/csrc``;
  3. write a seeded 5-building, 8760-row battery+PV dataset (the shape of
     ``citylearn_challenge_2022_phase_1``), compile it and pack it on the card;
  4. kernel vs plain: K1 (``battery_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over the full year,
     from per-district seeded states, all 6 outputs and 3 recorded rows
     bit-equal; the plain version's one run is timed;
  5. the main path, with the launch counts reset just before and read just
     after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both kernel-backed),
     then at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
  6. times with CUDA events: K1 per launch, its bound (also by the count
     that takes the energy request in every district), its chain floor, its
     registers and spills;
  7. kernel vs plain: K2 (``battery_collect_chunk``) against its plain
     PyTorch version at D=4096 districts x K=64 steps from per-district
     seeded streams and states, with and without the first-step accounting,
     all 4 outputs bit-equal, again from SOCs of 1e-35 (the per-lane IEEE
     redo), with 8 knots (the run-time build) and at four steps an hour;
     its device time from a CUDA graph of launches, its time through the
     wrapper, its bound, its chain floor, its registers and spills;
  8. the training path, ``BatchedSAC`` at the JAX package's ``sac_train_step``
     settings (D=4096, hidden 256x256, batch 256, 64-step chunks):
     (a) the per-step and the kernel collect agree over 64 warmup steps;
     (b) the main path, with the launch counts reset just before and read
     just after: 80 training steps on the kernel path, whose updates must
     move the policy; (c) the train step's rate over 3 more 64-step chunks,
     split into collect and updates, and K2 bit-equal and timed on the
     inputs that the trainer hands it in one more chunk; (d) ``evaluate``
     of the trained policy over 168 steps, and of a scripted baseline
     through K1; (e) the twin soft-Q kernels (``twin_q``) on the main
     path: the update's graph captured anew by one chunk, with
     ``twin_q.launches`` reset just before and read just after (6 launches
     a hidden layer for each ``_sac_step`` run), and every replay of one
     more chunk running the twin kernels, 6 a hidden layer, under the
     profiler; then the kernels on the trainer's own critics and one batch
     its update drew, and on seeded critics and rows at cell
     ``challenge2022_phase1.sac_train``'s shapes (A=5, N=256,
     37 -> 256 -> 256 -> 1): values against two ``SoftQ.forward`` calls,
     and every parameter's gradient (the critics' loss) and the action's
     alone (the policy loss) against the plain version in float64 on the
     kernels' relu branches, each branch that float64 takes otherwise
     within rounding of 0; at the cell's shapes the update's three passes
     timed as CUDA graphs, kernels against two ``SoftQ.forward`` calls and
     autograd, beside their fp32 bound;
  9. write a seeded 9-building, 8760-row thermal-storage dataset (cooling
     and DHW devices and tanks, battery, PV: the shape of
     ``citylearn_challenge_2021``), compile it and pack it on the card;
 10. kernel vs plain: K3 (``thermal_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over a summer quarter
     of the year (2190 steps: the plain version's run is the long part of
     this script, and the kernel is timed over the full year in phase 12),
     from per-district seeded states, all 8 outputs and the 9 recorded rows
     bit-equal, under plans that take both priority orders of both end
     uses; the plain version's one run is timed;
 11. the thermal main path, with the launch counts reset just before and
     read just after: ``evaluate_scripted`` at D=4096 over the full year
     and ``evaluate_districts`` with a scripted policy (both K3-backed),
     then at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
 12. times with CUDA events: K3 per launch, its bound (also by the count
     that takes the prelude's work in every district), its chain floor, its
     registers and spills, the full-year ``evaluate_scripted`` and the
     stepped thermal path per step;
 13. write a seeded EV district (17 buildings, 8 chargers, 15 EVs, a
     washing machine, 8760 rows, the EV reward: the shape of
     ``citylearn_challenge_2022_phase_all_plus_evs``), compile it and pack
     it on the card;
 14. kernel vs plain: K4 (``ev_episode``) against its plain PyTorch version
     on the same tensors at D=4096 districts over the first quarter of the
     year (2190 steps, as in phase 10; timed over the full year in phase
     16), all 10 outputs and the 6 recorded rows, from per-district seeded
     states and
     under plans that charge and discharge the batteries and the EVs and
     trigger the machine; once more with the default reward, and once on a
     district with charging constraints whose limits bind, at 168 steps;
     all bit-equal;
 15. the EV main path, with the launch counts reset just before and read
     just after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both K4-backed), then
     at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
 16. times with CUDA events: K4 per launch and its bound (also by PR
     4-7's count, the charger requests in every district), its registers
     and spills, the full-year ``evaluate_scripted`` and the stepped EV path
     per step; K4 once more with the default reward, which leaves the
     reward's phase out;
 17. write three seeded LSTM-dynamics districts (3 buildings whose indoor
     temperature follows a 2-layer LSTM of 8 units over a 12-step window
     of 12 channels, a cooling heat pump under the ``cooling_device``
     action, DHW heater and tank, battery, PV, the ComfortReward: the
     shape of ``citylearn_challenge_2023_phase_1``; the same with power
     outages; and a heterogeneous one with a fourth building of 50 units
     in one layer and a cooling tank), compile and pack them on the card;
 18. kernel vs plain: K5 (``lstm_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over a summer quarter
     of the year (2190 steps, as in phase 10; timed over the full year in
     phase 20), from per-district seeded states: the 8 physics outputs and 11 physics
     rows bit-equal, the temperature, the reward and its sum within their
     tolerances; again on the district with outages (720 steps: net is 0
     under an outage and part of the load goes unserved) and on the
     heterogeneous one (168 steps);
 19. the LSTM main path, with the launch counts reset just before and read
     just after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both K5-backed), then
     at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
 20. times with CUDA events: K5 per launch and its bound, the same on the
     district with outages, the full-year ``evaluate_scripted`` and the
     stepped LSTM path per step;
 21. write two seeded neighborhood districts (100 EULP-shaped buildings
     whose LSTMs of 8 to 32 units in one or two layers read the cooling
     demand, the heating demand or both, signed ``cooling_or_heating_device``
     partial load, DHW heater and tank, battery, PV, the default reward: the
     shape of ``ca_alameda_county_neighborhood``; and 20 quebec-shaped
     occupant buildings with heating-side partial load, no battery and the
     ComfortReward), compile and pack them on the card;
 22. kernel vs plain: K6 (``neighborhood_episode``) against its plain
     PyTorch version at D=4096 over a spring quarter (2190 steps; timed over
     the full year in phase 25) from per-district seeded states, all 7
     outputs and 9 rows bit-equal; again on the quebec district (a null
     battery) over 720 steps;
 23. kernel vs plain: P6 (``neighborhood_postpass``, the temperature and
     occupant post-pass) against its plain version on K6's recorded demand
     observations: the EULP district over 168 steps, the quebec district
     over 720 steps with its inert decision trees replaced by a
     hand-written tree so that triggers, holds and reversions run, and
     LSTM districts of 20 units and of 50 beside 8 (hidden sizes outside
     the kernel's compiled paths) over 168 steps of K5's plain cooling
     observations; temperature within 2e-4 |T| + 5e-3 C, occupant decisions
     identical except where the temperature's tolerance straddles one
     (counted);
 24. the neighborhood main path, with the launch counts reset just before
     and read just after: ``evaluate_scripted`` at D=4096 over the full year
     on the EULP district, one K6 and one P6 launch; then the kernel-backed
     table against the stepped ``evaluate_districts`` on the quebec district
     over 168 steps and on the EULP district over 48 steps;
 25. times with CUDA events: K6 per launch and its bound (also by PR
     6-7's count, the prelude's work in every district), its registers and
     spills, P6 for the year
     over 10 launches, its bound and its chain floor, the full-year
     ``evaluate_scripted`` over 5.

 26. training on the families: ``BatchedSAC`` at phase 8's settings
     (hidden 256x256, batch 256, 720-step episodes) on the thermal, EV
     and LSTM districts at D=4096 and the EULP and quebec districts at
     D=128, each on the per-step collect (K2 serves battery+PV only): 8
     warmup and 24 policy steps whose updates must move the policy with
     finite and non-zero rewards (on the EV district past step 16, before
     which no EV docks), the train step's ms and district-steps/s split
     into collect and updates, ``evaluate`` of the learned policy over 168
     steps, and of the family's scripted plan, which must launch the
     family's kernel (K3, K4, K5, K6 and P6);
 27. ``BatchedMARLISA`` on the battery+PV district at D=4096 with phase 8's
     settings and a ridge refit every 8 steps: 32 steps after which the
     ridge weights and the coordination variables are non-zero and each
     agent's capacity variable is the dispatched share before it, its ms
     per step, and ``evaluate`` with the live ring over 168 steps.
 28. the Gym env on the card, ``CityLearnEnv`` stepped through ``env.step``
     under each family's scripted plan: battery+PV over the full year
     (8759 steps), the thermal, EV, LSTM and quebec districts over 168
     steps, the EULP district over 48; each env's KPI rows (numpy, no
     pandas) against ``evaluate_scripted`` on the same schema and window
     through the family's kernel (K1, K3, K4, K5, K6 and P6, each of which
     must launch), within 2e-5 relative (the discomfort and resilience
     KPIs of the LSTM and neighborhood districts within 2 steps in 168);
     env steps/s and the share of a step spent outside ``step_packed`` (the
     district step and its packing) per family; then 168 battery+PV steps in the float64 parity mode on
     the card against the same steps on the CPU, within 1e-6 of scale.
 29. the CLI and the host-loop agents on the card, through ``cli.main`` in
     the process on named datasets that the dataset catalog resolves from
     the run's data root (``CITYLEARN_DATA_ROOT``; phases 26-29 share one
     write of each family): (a) ``simulate <name> evaluate`` on each
     family with and without ``--fast`` (battery+PV over the whole year
     with BasicRBC, thermal with OptimizedRBC, EV with the EV reference
     controller and LSTM with BasicRBC over 168 steps, EULP over 48 and
     quebec over 168 with BasicRBC): each ``--fast`` run launches its
     family's kernel exactly once (K6 and P6 once each on EULP and
     quebec) and the stepped run none; the fast pivot against the stepped
     one within 2e-5 of scale (the discomfort and resilience KPIs of the
     dynamics districts within 2 steps in 168), the fast run's
     kernel-recorded time series against the same columns of the stepped
     run, the seconds of each and the speed-up; (b) ``simulate train``
     with ``citylearn.agents.sac.SAC`` on battery+PV at the JAX package's
     defaults (hidden 256x256, batch 256, 2 updates a step) over 336 steps,
     standardized and exploring until step 168, ``--save_agent``, then
     ``simulate evaluate -fa <pickle>``: finite weights that moved, a
     finite table, ms a step before and after the updates start; (c)
     ``MARLISA`` on battery+PV over 48 steps with the numpy PCA and
     regression, its coordinated policy from step 41.
 30. the district mesh (``citylearn_tpu_torch.parallel``) on the one card:
     every rank is started with ``torch.multiprocessing`` ``spawn`` and
     the variables that ``torchrun`` sets, and joins through
     ``initialize_distributed``; (a) two ranks, both on ``cuda:0`` under
     gloo (NCCL refuses two ranks on one card; gloo exchanges CUDA tensors
     through the host), each with 2048 of D=4096
     districts: ``evaluate_scripted(mesh=)`` over the full year on the
     battery+PV, thermal, EV, LSTM and EULP districts of phases 26-29's
     data root, each rank launching each of the family's kernels exactly
     once (K1, K3, K4, K5; K6 and P6) and issuing no collective, its table
     and record bit-equal to a single process's over all D districts and
     its state outputs bit-equal to its rows of the single launch; then
     ``BatchedSAC(mesh=)`` at phase 8's settings, 64 warmup steps bit-equal
     to the unsharded trainer's rows, two 64-step chunks with updates (one
     K2 launch per chunk per rank) whose networks and Adam states are
     bit-identical across the ranks, finite and moved, the ms per chunk
     split into collect, updates and the batch ``all_reduce``, and its
     sharded ``evaluate``; ``BatchedMARLISA(mesh=)`` over 16 steps with a
     ridge refit every 8, the same ridge weights on both ranks; (b) one
     rank under NCCL, where ``initialize_distributed()`` must join no group
     (a world of one, as in the JAX package) and the rank joins one itself:
     battery+PV ``evaluate_scripted`` and one 64-step ``BatchedSAC`` chunk
     with updates bit-equal to the run without a mesh. Two ranks share one
     card: its times are no multi-GPU speed.
     (c) with ``--cards N`` (N > 1), instead of phases 3-31: N ranks, one
     on each card, joined through ``initialize_distributed()``'s defaults
     (nccl, ``env://``) and placed by ``district_mesh()``'s
     (``cuda:$LOCAL_RANK``), run (a)'s evaluation and training at D=4096,
     each rank's single process on its own card; and every kernel of the
     path (K1, K2, K3, K4, K5, K6, P6) launched on the rank's card while
     another card is current, bit-equal to the launch with its own current.
 31. the rest of the package: (a) the thermal district with every device
     autosized (HVAC devices, tanks, battery from a seeded
     ``battery_choices.yaml``, PV from a seeded EPW file) and the
     battery+PV district with battery and PV autosized, each size
     printed, their full-year ``evaluate_scripted`` at D=4096 through one
     K3 and one K1 launch and their kernel-backed tables at 168 steps
     against the stepped ones; (b) 168 stepped battery+PV steps at D=4096
     with the debug physics checks on, a corrupted SOC that must raise
     ``PhysicsCheckError``, the ms per step with the checks off and on;
     (c) ``utilities.Profiler`` around a full-year K1 evaluation in a
     spawned process, whose trace must name K1's kernels inside the
     ``battery_episode`` range;
     (d) ``Neighborhood().build`` of 3 buildings x 8760 steps with 2
     partial-load simulations, the LSTMs trained on the card at
     ``LSTM_CONFIG``'s width (H=4, 2 layers, lookback 13, batch 168, 13
     channels) for 4 of its 144 epochs, ms per Adam step and seconds of
     the build; the generated dataset's full-year ``evaluate_scripted`` at
     D=4096 as built (the default reward: K6 and P6) and with the
     ComfortReward (K5), each table against the stepped one at 168 steps
     and K5's temperature against the stepped path's.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi name and power
limit, and last ``{"ok": true, "device": {...}}``; ``--json PATH`` also
writes every number measured to PATH. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import warnings

import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted, kernel_family
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.rollout_fast import (
    battery_episode_inputs,
    eligible,
    eligible_ev,
    eligible_thermal,
    ev_episode_inputs,
    lstm_episode_inputs,
    lstm_packable,
    neighborhood_episode_inputs,
    neighborhood_packable,
    thermal_episode_inputs,
)
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.ops import collect as k2
from citylearn_tpu_torch.ops import ev as k4
from citylearn_tpu_torch.ops import lstm as k5
from citylearn_tpu_torch.ops import neighborhood as k6
from citylearn_tpu_torch.ops import postpass as p6
from citylearn_tpu_torch.ops import thermal as k3
from citylearn_tpu_torch.ops import twin_q as twin_q_mod
from citylearn_tpu_torch.synthetic import (
    write_battery_choices,
    write_battery_pv_dataset,
    write_epw,
    write_ev_dataset,
    write_lstm_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)
from citylearn_tpu_torch import cli, tracing
from citylearn_tpu_torch import train as train_module
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.parallel import (
    all_gather,
    all_reduce,
    district_mesh,
    district_slice,
    free_port,
    initialize_distributed,
)
from citylearn_tpu_torch.agents import sac
from citylearn_tpu_torch.envs import environment
from citylearn_tpu_torch.envs.environment import CityLearnEnv
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig
from citylearn_tpu_torch.train_marlisa import BatchedMARLISA
from citylearn_tpu_torch.core import debug
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.end_use_load_profiles import Neighborhood
from citylearn_tpu_torch.graphs import Graph
from citylearn_tpu_torch.end_use_load_profiles import build as gen_build
from citylearn_tpu_torch.end_use_load_profiles import lstm as gen_lstm
from citylearn_tpu_torch.utilities import Profiler

DEVICE = "cuda"
D = 4096                      # districts per batch
N_BUILDINGS, N_ROWS, SEED = 5, 8760, 0
THERMAL_BUILDINGS = 9         # the thermal district (citylearn_challenge_2021 has 9)
EV_SHAPE = (17, 8, 15, 1)     # buildings, chargers, EVs, machines of the plus_evs district
SHORT_STEPS = 168             # the kernel-vs-stepped table comparison
# K3's and K4's plain versions take 35-85 s for the year, host-bound and
# linear in the steps: they are compared over a quarter of it
QUARTER_STEPS = 2190
OUTAGE_STEPS = 720            # K5 against its plain version on the district with outages
EULP_BUILDINGS = 100          # ca_alameda_county_neighborhood's buildings
QUEBEC_BUILDINGS = 20         # the quebec neighborhoods' buildings
SPRING = 2400                 # K6's quarter: from mid-April, hvac_mode 3 then 1
QUEBEC_STEPS = 720            # K6 and P6 on the quebec district against their plain versions
EULP_TABLE_STEPS = 48         # the EULP district's kernel-vs-stepped table (12 LSTM groups)
PEAK_FP32 = 67e12             # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
# the least cycles one LSTM cell of P6's dependent chain takes: a tree of
# multiply-adds, two activations, the exchange of the hidden vector
CELL_CYCLES = 100
# Hopper latencies, in cycles, of K1's, K2's and K3's chain floor (chain_cycles):
# a shared-memory load, a MUFU estimate, a move to or from a uniform
# register; 4 for every other FP32 or integer operation
SASS_LATENCY = {"LDS": 30, "MUFU": 18, "S2UR": 10, "R2UR": 10}
SASS_NO_DESTINATION = {"ST", "STS", "STG", "STL", "RED", "ATOM", "BRA", "BSSY", "BSYNC", "CALL",
                       "RET", "EXIT", "BAR", "NOP", "DEPBAR", "LDGDEPBAR", "WARPSYNC", "LDGSTS"}
SASS_REGISTER = re.compile(r"\b(U?R\d+|U?P\d+)\b")
START = time.perf_counter()   # the phases print the seconds since
# expected bit-equal (-fmad=false, IEEE div/sqrt); held to these errors
# relative to each output's largest magnitude
TOL_STEP = 1e-6               # per-step record and final state
TOL_SUM = 1e-5                # year-long reward/cost/emission sums
TOL_TABLE = 1e-5              # KPI tables: ratios of sums taken in another order
OUTPUTS = ("reward", "cost", "emission", "soc", "eff", "deg", "record")
K_CHUNK = 64                  # K2's chunk: TrainConfig.collect_chunk
COLLECT_OUTPUTS = ("reward", "soc", "eff", "deg")
THERMAL_OUTPUTS = ("reward", "cost", "emission", "cooling_soc", "dhw_soc", "soc", "eff",
                   "deg", "record")
EV_OUTPUTS = ("reward", "cost", "emission", "soc", "eff", "deg", "ev_soc", "ev_eff", "ev_deg",
              "wm_initiated", "record")
LSTM_OUTPUTS = ("reward", "cost", "emission", "cooling_soc", "dhw_soc", "soc", "eff", "deg",
                "last_temp", "record")
# K5's temperature and reward follow the LSTM, whose sums the kernel takes
# in another order than the plain version and whose activations use the
# hardware's exp2: temperature within TEMP_RTOL * |T| + TEMP_ATOL (the JAX
# package's tolerance between its kernel and its scan); the reward row the
# same on all but REWARD_FLIPS of its steps (a temperature within that
# error of a threshold of the ComfortReward lands on its other side, which
# moves that step's reward by up to band ** exponent); the reward sum
# within TOL_REWARD_SUM of its scale
TEMP_RTOL, TEMP_ATOL = 2e-4, 5e-3
REWARD_FLIPS = 1e-3
TOL_REWARD_SUM = 1e-3
# KPIs that count steps on one side of a comfort threshold, or average
# over them: kernel-backed against stepped within this many steps in S
COMFORT_STEPS = 2
# the JAX package's sac_train_step bench row (bench.py:286-290)
TRAIN = dict(n_districts=D, hidden=(256, 256), batch_size=256,
             replay_capacity=D * 64, collect_chunk=K_CHUNK)
TRAIN_EPISODE = 720
# phase 26: BatchedSAC on the other families, each on its per-step path;
# the neighborhood districts at D=128, where a stepped step costs 46-63 ms
# at D=8 already (host-bound: the step's launches, not D, set its time)
FAMILY_D = {"thermal": D, "ev": D, "lstm": D, "eulp": 128, "quebec": 128}
FAMILY_WARMUP, FAMILY_STEPS = 8, 24   # warmup steps, then policy steps with updates
FAMILY_CHUNK = 8                      # steps of each timed chunk
EV_REWARD_FROM = 16                   # the synthetic EV district docks no EV before this step
MARLISA_EVERY = 8                     # phase 27's regression_update_every
TOL_PATHS = 2e-5              # per-step vs kernel collect: replay rows and state
# the twin soft-Q kernels against the plain version in float64, each relu
# on the kernels' branch (tests/test_torch_twin_q.py): values relative to
# their mean magnitude, each gradient leaf by the norm of its difference
# over the reference's; a branch float64 takes otherwise has its
# pre-activation within TWIN_FLIP_EPS float32 epsilons of |x| @ |W| + |b|,
# on one and TWIN_FLIP_SHARE of the elements at most
TOL_TWIN = 1e-5
TWIN_FLIP_EPS, TWIN_FLIP_SHARE = 32, 1e-5
TWIN_KERNELS = ("forward_layer", "rows_layer", "columns_layer")
# cell challenge2022_phase1.sac_train's critics: A, K, M, hidden (N: TRAIN's batch)
TWIN_CELL = (5, 36, 1, (256, 256))
# phase 28: the Gym env's steps per family (None: the whole year), its KPI
# rows against evaluate_scripted's table (the JAX package's
# tests/test_evaluate_batched.py:60), and the parity mode on the card
# against the CPU (tests/test_torch_parity_f64.py)
ENV_STEPS = {"battery": None, "thermal": SHORT_STEPS, "ev": SHORT_STEPS, "lstm": SHORT_STEPS,
             "eulp": EULP_TABLE_STEPS, "quebec": SHORT_STEPS}
TOL_ENV = 2e-5
PARITY_STEPS = 168
TOL_PARITY = 1e-6
# phase 29: ``simulate`` through cli.main; family -> (agent, steps, None:
# the whole year), as phase 28 steps them
CLI_FAMILIES = {
    "battery": ("citylearn.agents.rbc.BasicRBC", None),
    "thermal": ("citylearn.agents.rbc.OptimizedRBC", SHORT_STEPS),
    "ev": ("citylearn.agents.rbc.BasicElectricVehicleRBC_ReferenceController", SHORT_STEPS),
    "lstm": ("citylearn.agents.rbc.BasicRBC", SHORT_STEPS),
    "eulp": ("citylearn.agents.rbc.BasicRBC", EULP_TABLE_STEPS),
    "quebec": ("citylearn.agents.rbc.BasicRBC", SHORT_STEPS),
}
# the host-loop SAC at the JAX package's defaults (agents/rlc.py), its
# replay standardized and its exploration ended half way
CLI_SAC_STEPS = 336
CLI_SAC = dict(hidden_dimension=[256, 256], batch_size=256, update_per_time_step=2,
               standardize_start_time_step=168, end_exploration_time_step=168)
# MARLISA over 48 steps: the regression from step 4, so that its PCA of
# 29 features finds 32 replay rows (the first at step 6) by step 37, and
# the coordinated policy from step 41
CLI_MARLISA_STEPS = 48
CLI_MARLISA = dict(batch_size=32, start_regression_time_step=4, standardize_start_time_step=32,
                   end_exploration_time_step=40)
# KPIs that are NaN by the reference's semantics on data with no occupants
# and no outage (a proportion of zero occupied or zero outage steps)
NAN_KPIS = {"discomfort_proportion", "discomfort_cold_proportion",
            "discomfort_hot_proportion", "one_minus_thermal_resilience_proportion",
            "power_outage_normalized_unserved_energy_total"}


#: family -> writer of its seeded dataset into a directory; phases 26-29
#: share one write of each (:func:`named_dataset`)
FAMILY_WRITERS = {
    "battery": lambda d: write_battery_pv_dataset(d, N_BUILDINGS, N_ROWS, SEED),
    "thermal": lambda d: write_thermal_dataset(d, THERMAL_BUILDINGS, N_ROWS, SEED),
    "ev": lambda d: write_ev_dataset(d, *EV_SHAPE, N_ROWS, SEED),
    "lstm": lambda d: write_lstm_dataset(d, n_rows=N_ROWS, seed=SEED),
    "eulp": lambda d: write_neighborhood_dataset(d, EULP_BUILDINGS, N_ROWS, SEED),
    "quebec": lambda d: write_neighborhood_dataset(d, QUEBEC_BUILDINGS, N_ROWS, SEED,
                                                   quebec=True),
}
# phase 30: the district mesh on the one card
MESH_FAMILIES = ("battery", "thermal", "ev", "lstm", "eulp")
MESH_EVALUATE_STEPS = 24      # the sharded trainer's evaluate, which gathers its table
MESH_MARLISA_STEPS = 16
DATASET_PREFIX = "smoke_"     # the named datasets' directories: smoke_<family>
_DATA_ROOT = []               # the run's data root, a TemporaryDirectory made on first use


def data_root() -> str:
    if not _DATA_ROOT:
        _DATA_ROOT.append(tempfile.TemporaryDirectory())
    return _DATA_ROOT[0].name


def named_dataset(family: str) -> str:
    """The schema path of ``family``'s seeded dataset, the directory
    ``smoke_<family>`` of the run's data root, written on first use."""
    d = os.path.join(data_root(), DATASET_PREFIX + family)
    path = os.path.join(d, "schema.json")
    if not os.path.isfile(path):
        os.makedirs(d, exist_ok=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")           # the quebec trees are absent
            path = FAMILY_WRITERS[family](d)
    return path


def basic_rbc_table():
    """BasicRBC hour table: charge 0.091 from 22:00 to 08:00, else discharge 0.08."""
    table = [-0.08] * 24
    for h in list(range(22, 25)) + list(range(1, 9)):
        table[h - 1] = 0.091
    return table


def thermal_rbc_tables():
    """Hour tables in the manner of BasicRBC: the tanks and the battery
    charge from 22:00 to 08:00 and discharge through the day."""
    night = [h >= 22 or h <= 8 for h in range(1, 25)]
    table = lambda charge, discharge: [charge if n else discharge for n in night]
    return {"cooling_storage": table(0.091, -0.08), "dhw_storage": table(0.091, -0.08),
            "electrical_storage": basic_rbc_table()}


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def phase(title):
    print(f"\n== {title} ({time.perf_counter() - START:.1f} s from the start)", flush=True)


def scaled_error(a, b):
    """(max |a - b|, max |a - b| / max |b|)."""
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-30)


def with_seeded_states(inputs, gen):
    """K1's or K3's ``inputs`` with states that differ from district to
    district: the battery's SOC, efficiency and degraded capacity and,
    where the kernel takes them, the tanks' SOCs."""
    shape, dev = inputs["soc0"].shape, inputs["soc0"].device
    rand = lambda lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    out = dict(inputs, soc0=rand(0.0, 1.0), eff0=rand(0.85, 0.95),
               deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous())
    out.update({k: rand(0.0, 1.0) for k in ("csoc0", "dsoc0") if k in inputs})
    return out


def check_bit_equal(label, names, ours, ref):
    """Raises unless every output equals its plain version bit for bit;
    returns the largest |difference|."""
    worst = 0.0
    for name, a, b in zip(names, ours, ref):
        diff = float((a - b).abs().max())
        worst = max(worst, diff)
        print(f"{name:11s} max|diff| {diff:.3e}")
        if not torch.equal(a, b):
            raise AssertionError(f"{label} {name} is not bit-equal to its plain version: "
                                 f"max|diff| {diff:.3e}")
    return worst


def sass_function(text, part):
    """[(address, instruction)] of the SASS function whose name holds ``part``."""
    out, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = part in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;?\s*/\*", line)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2).rstrip(" ;")))
    return out


def chain_cycles(name, kernel="district_kernel"):
    """The least cycles one step of the step loop of ``csrc/<name>.cu`` (the
    district pass ``district_kernel`` of K1 or K3, or K2's
    ``collect_kernel``) takes: the longest dependent chain through the step
    loop in the SASS of this checkout's 5-knot build (``cuobjdump -sass``),
    at ``SASS_LATENCY``. The loop is the longest innermost one, read without
    the regions its fast path skips (each step's IEEE redo, which holds the
    calls), each side of every if/else in turn, and divided by the steps a
    trip runs (the source's ``#pragma unroll`` of the step loop). Returns
    (cycles a step, {opcode: count} along the longest chain)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    unroll = re.search(r"#pragma unroll (\d+)\n\s*for \(int k = 0; k < [\w.]+; \+\+k\)",
                       (_build.CSRC / f"{name}.cu").read_text())
    steps_per_trip = int(unroll.group(1)) if unroll else 1
    code = sass_function(text, f"{kernel}ILi5E")
    branch = lambda ins: re.match(r"(@!?U?P\d+ )?BRA (0x[0-9a-f]+)", ins)
    loops = [(int(branch(i).group(2), 16), a) for a, i in code
             if branch(i) and int(branch(i).group(2), 16) < a]
    inner = [l for l in loops if not any(o != l and l[0] <= o[0] and o[1] <= l[1] for o in loops)]
    start, end = max(inner, key=lambda l: l[1] - l[0])
    body = [(a, i) for a, i in code if start <= a <= end]
    forward = [(a, int(branch(i).group(2), 16), i.startswith("@")) for a, i in body
               if branch(i) and int(branch(i).group(2), 16) > a]
    skipped = [(a, t) for a, t, cond in forward if cond
               and any("CALL" in i for b, i in body if a < b < t)]
    redo = [r for r in skipped if not any(o != r and o[0] <= r[0] and r[1] <= o[1]
                                          for o in skipped)]
    body = [(a, i) for a, i in body if not any(lo < a < hi for lo, hi in redo)]
    addresses = [a for a, _ in body]
    diamonds = []          # (then, else) address ranges of an if/else
    for a, t, cond in forward:
        if cond and t in addresses and t > a:
            before = body[addresses.index(t) - 1][1]
            join = branch(before)
            if join and not before.startswith("@") and int(join.group(2), 16) > t:
                diamonds.append(((a, t), (t - 1, int(join.group(2), 16))))
    best = (0, {})
    for choice in range(1 << len(diamonds)):
        drop = [d[(choice >> n) & 1] for n, d in enumerate(diamonds)]
        ready, via, longest = {}, {}, (0, None)
        for a, ins in body:
            if any(lo < a < hi for lo, hi in drop):
                continue
            guard, _, rest = ins.partition(" ") if ins.startswith("@") else ("", "", ins)
            op, _, operands = rest.partition(" ")
            base = op.split(".")[0]
            ops = [o.strip() for o in operands.split(",")] if operands else []
            if base in SASS_NO_DESTINATION:
                dst = []
            elif base in ("FSETP", "ISETP", "PLOP3", "FCHK"):
                dst = [o for o in ops[:2] if re.fullmatch(r"U?P\d+", o)]
            elif base == "LOP3" and ops and re.fullmatch(r"P\d+", ops[0]):
                dst = ops[:2]
            elif len(ops) > 1 and re.fullmatch(r"P\d+", ops[1]) and base in ("IADD3", "LEA", "IMAD"):
                dst = ops[:2]
            else:
                dst = ops[:1]
            dst = [d for d in dst if SASS_REGISTER.fullmatch(d)]
            srcs = SASS_REGISTER.findall(guard + " " + ", ".join(ops[len(dst):]))
            begin = max([ready.get(r, 0) for r in srcs] + [0])
            finish = begin + SASS_LATENCY.get(base, 4)
            parent = max(srcs, key=lambda r: ready.get(r, 0), default=None)
            for d in dst:
                ready[d] = finish
                via[d] = (base, via.get(parent) if parent else None)
            if finish > longest[0] and dst:
                longest = (finish, dst[0])
        if longest[0] > best[0]:
            counts, node = {}, via.get(longest[1])
            while node:
                counts[node[0]] = counts.get(node[0], 0) + 1
                node = node[1]
            best = (longest[0], counts)
    return best[0] / steps_per_trip, best[1]


def chain_floor_ms(cycles, n_steps):
    """S steps of a chain of ``cycles`` at the card's highest SM clock:
    (ms, MHz)."""
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return n_steps * cycles / (clock_mhz * 1e3), clock_mhz


def ptxas_report(results, name):
    """The registers and spills of the district pass's builds of ``name``."""
    lines = results.get("ptxas", {}).get(name, [])
    return [line for line in lines if "entry function" not in line]


def time_cuda(fn, n):
    """Milliseconds per call of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_graph(fn, n, replays=3):
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph, replayed ``replays`` times after one warm-up, so that the
    host's time to launch does not count."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def timed_once(fn):
    """(result, milliseconds) of one call of ``fn``, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tensor_bytes(tree):
    """Bytes of every tensor in a dict, tuple or list of tensors, nested."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    return sum(tensor_bytes(x) for x in tree) if isinstance(tree, (tuple, list)) else 0


def check_table(table, lead, where, n_buildings=N_BUILDINGS):
    """Every KPI has shape ``lead`` (+ (B,) for building rows) and is
    finite, except those NaN by the reference's semantics on this data."""
    if len(table) != 37:
        raise AssertionError(f"{where}: {len(table)} KPIs, want 37")
    for k, v in table.items():
        shape = lead + ((n_buildings,) if k.startswith("building|") else ())
        if tuple(v.shape) != shape:
            raise AssertionError(f"{where}: {k} has shape {tuple(v.shape)}, want {shape}")
        if k.split("|")[1] not in NAN_KPIS and not torch.isfinite(v).all():
            raise AssertionError(f"{where}: {k} is not finite: {v}")


def table_error(fast, stepped, comfort_steps=0, steps=SHORT_STEPS):
    """Largest error of the kernel-backed KPI table against the stepped
    one, relative to max(|value|, 1); raises beyond ``TOL_TABLE``. The
    discomfort and resilience KPIs, which count or average the steps
    beyond a comfort threshold, may also move by ``comfort_steps`` steps
    in ``steps`` (their own largest error is returned second)."""
    worst = worst_comfort = 0.0
    for k in fast:
        a, b = fast[k], stepped[k]
        if tuple(a.shape) != tuple(b.shape) or not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError(f"kernel and stepped tables differ in shape or NaN on {k}")
        finite = ~b.isnan()
        err = float(((a - b).abs()[finite] / b.abs()[finite].clamp(min=1.0)).max()) \
            if finite.any() else 0.0
        name = k.split("|")[1]
        if comfort_steps and name.startswith(("discomfort", "one_minus_thermal_resilience")):
            worst_comfort = max(worst_comfort, err)
            tol = TOL_TABLE + comfort_steps / steps
        else:
            worst = max(worst, err)
            tol = TOL_TABLE
        if not err <= tol:
            raise AssertionError(f"kernel vs stepped table at S={steps}: {k} {err}")
    return (worst, worst_comfort) if comfort_steps else worst


def thermal_path(dev, results):
    """Phases 9-12: the thermal-storage district through K3. Returns K3's
    entry of the ``kernels`` line."""
    phase("9. thermal dataset, compile, pack")
    B = THERMAL_BUILDINGS
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_thermal_dataset(tmp, B, N_ROWS, SEED)
        cfg, params, _ = pack(compile_schema(schema), device=dev)
    if not eligible_thermal(cfg):
        raise AssertionError("the synthetic thermal district is not kernel-eligible")
    S = cfg.time_steps - 1
    print(f"{cfg.n_buildings} buildings, {cfg.time_steps} rows, S={S} steps, "
          f"cooling {cfg.any_cooling}, heating {cfg.any_heating}, dhw {cfg.any_dhw}; DHW "
          f"heat pumps {int(params.dhw_device.is_heat_pump.sum())} of {B}, DHW tanks "
          f"{int((params.dhw_storage.capacity > 0).sum())} of {B}")
    tables = thermal_rbc_tables()

    phase(f"10. K3 vs plain at D={D}, B={B}, S={QUARTER_STEPS} (a summer quarter)")
    inputs = thermal_episode_inputs(cfg, params, D, tables)

    def with_both_orders(inputs):
        """The reference converts the DHW storage action by the heating
        tank's capacity, 0 on a district without heating, so the main
        path's DHW tanks never charge. The comparison converts by the DHW
        tank's own capacity instead, which takes both priority orders of
        the DHW block."""
        out = dict(inputs, tparams=inputs["tparams"].clone())
        out["tparams"][k3.DT_CONV] = out["tparams"][k3.DT_CAP]
        return out

    gen = torch.Generator(device=dev).manual_seed(SEED)
    both_orders = with_seeded_states(with_both_orders(inputs), gen)
    quarter = with_seeded_states(with_both_orders(thermal_episode_inputs(
        cfg, params, D, tables, n_steps=QUARTER_STEPS, data_offset=S // 2)), gen)
    ours = k3.thermal_episode(**quarter, record=True)
    ref, plain_ms = timed_once(lambda: k3.thermal_episode_reference(**quarter, record=True))
    max_abs = check_bit_equal("K3", THERMAL_OUTPUTS, ours, ref)
    print(f"8 outputs and {k3.N_TREC} rows bit-equal from per-district seeded states")
    rec = ours[8]
    for row, name in ((k3.R_CBAL, "cooling"), (k3.R_DBAL, "dhw"), (k3.R_BBAL, "battery")):
        if not ((rec[row] > 0).any() and (rec[row] < 0).any()):
            raise AssertionError(f"the {name} balance never took both signs")
    if not torch.isfinite(rec).all():
        raise AssertionError("K3 recorded a non-finite value")
    unmet = float((quarter["series"][4] - rec[k3.R_COUT] - (-rec[k3.R_CBAL]).clamp(min=0))
                  .clamp(min=0).sum())
    print(f"both priority orders of both end uses and both battery branches taken; "
          f"unmet cooling of district 0 over the quarter {unmet:.3f} kWh (the undersized "
          f"heat pump saturates)")

    phase("11. thermal main path")
    policy = ScriptedPolicy(tables)
    k3.thermal_episode.launches = 0
    table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
    torch.cuda.synchronize()
    check_table(table, (), "thermal evaluate_scripted", B)
    states = batched_initial_states(cfg, params, D, device=dev)
    served = evaluate_districts(cfg, params, states, policy, device=dev)
    check_table(served, (D,), "thermal evaluate_districts", B)
    for k, v in served.items():
        if not torch.equal(v[0].nan_to_num(), table[k].nan_to_num()):
            raise AssertionError(f"thermal evaluate_districts dispatch differs on {k}")
    fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
    stepped_fn = lambda: evaluate_districts(
        cfg, params, states, policy.as_policy_fn(cfg, params, SHORT_STEPS),
        n_steps=SHORT_STEPS, device=dev)
    stepped = stepped_fn()
    torch.cuda.synchronize()
    launches = k3.thermal_episode.launches
    print(f"K3 launches on the main path: {launches}")
    if launches == 0:
        raise AssertionError("the thermal main path never launched K3")
    worst = table_error(fast, stepped)
    print(f"kernel vs stepped KPI table at S={SHORT_STEPS}, D={D}: max error {worst:.3e} "
          f"(tolerance {TOL_TABLE:g})")
    print("full-year district KPIs:")
    for k, v in table.items():
        if k.startswith("district|"):
            print(f"  {k[9:]:48s} {float(v):.6f}")

    phase("12. thermal times")
    kernel_ms = time_cuda(lambda: k3.thermal_episode(**both_orders, record=True), 20)
    main_ms = time_cuda(lambda: k3.thermal_episode(**inputs, record=True), 20)
    eval_ms = time_cuda(lambda: evaluate_scripted(cfg, params, policy, n_districts=D,
                                                  device=dev), 5)
    stepped_ms = time_cuda(stepped_fn, 1)
    n_knots = inputs["curves"][0].shape[0]
    n_bytes = 4 * (10 * S * B + 8 * B + 4 * n_knots * B + k3.N_TROWS * B + 5 * D * B
                   + 8 * D * B + k3.N_TREC * S * B)
    n_ops = k3.operation_count(inputs["actions"], n_knots, D)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the count with the prelude's work in every district
    per_district_bound_ms = max(bytes_ms, D * k3.operation_count(inputs["actions"], n_knots, 1)
                                / PEAK_FP32 * 1e3)
    cycles, chain = chain_cycles("thermal_episode")
    chain_ms, clock_mhz = chain_floor_ms(cycles, S)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K3 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{main_ms:.4f} ms on the main path's inputs, whose DHW tanks never charge); "
          f"plain {plain_ms:.2f} ms for {QUARTER_STEPS} steps; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms), "
          f"share of bound {bound_ms / kernel_ms:.2%}; by the count with the prelude's work "
          f"in every district {per_district_bound_ms:.4f} ms, "
          f"{per_district_bound_ms / kernel_ms:.2%}; chain floor {chain_ms:.4f} ms ({S} steps "
          f"x {cycles:g} cycles at {clock_mhz:.0f} MHz, read from this build's SASS along "
          f"{chain}), {kernel_ms / chain_ms:.2f}x of it; build: {ptxas_report(results, 'thermal_episode')}; "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; stepped "
          f"evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms "
          f"({stepped_ms / SHORT_STEPS:.3f} ms per step)")
    results.update(
        k3_ms=kernel_ms, k3_main_inputs_ms=main_ms, k3_plain_ms=plain_ms,
        k3_plain_steps=QUARTER_STEPS,
        k3_bound_ms=bound_ms, k3_bound_ops=n_ops, k3_bound_bytes=n_bytes,
        k3_bound_ms_per_district=per_district_bound_ms, k3_chain_floor_ms=chain_ms,
        k3_chain_cycles=cycles,
        k3_max_abs_err=max_abs, k3_launches=launches, k3_table_error=worst,
        k3_district_steps_per_s=D * S / kernel_ms * 1e3,
        thermal_evaluate_scripted_ms=eval_ms, thermal_stepped_168_ms=stepped_ms,
        thermal_district_kpis={k: float(v) for k, v in table.items()
                               if k.startswith("district|")}, thermal_smi_after=power)
    return {
        "name": "thermal_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/thermal_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_thermal.py:335",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "plain_steps": QUARTER_STEPS, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}


def ev_plans(n_chargers):
    """Hour tables in the manner of BasicElectricVehicleRBC: the batteries
    follow BasicRBC; the chargers charge through the night, hard before the
    morning departure, and discharge in the evening, every second charger
    at half the rate; the machine starts whenever its window is open."""
    hours = range(1, 25)
    charger = [0.4 if h < 5 else 1.0 if h < 9 else -0.6 if 17 <= h < 21 else 0.8 if h >= 21
               else 0.0 for h in hours]
    return {"electrical_storage": basic_rbc_table(),
            "electric_vehicle_storage": [[a * (1.0 if c % 2 == 0 else 0.5)
                                          for c in range(n_chargers)] for a in charger],
            "washing_machine": [1.0] * 24}


def compare_ev(label, inputs):
    """K4 against its plain version on ``inputs``. Returns (kernel
    outputs, max |diff|, all outputs bit-equal, the plain version's ms)."""
    ours = k4.ev_episode(**inputs, record=True)
    ref, plain_ms = timed_once(lambda: k4.ev_episode_reference(**inputs, record=True))
    max_abs, bit_equal = 0.0, True
    for name, a, b in zip(EV_OUTPUTS, ours, ref):
        diff, rel = scaled_error(a, b)
        max_abs = max(max_abs, diff)
        bit_equal = bit_equal and torch.equal(a, b)
        tol = TOL_SUM if name in ("reward", "cost", "emission") else TOL_STEP
        print(f"{label} {name:12s} max|diff| {diff:.3e}  scaled {rel:.3e}  (tolerance {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"K4 {name} disagrees with its plain version ({label}): {rel}")
    if not torch.isfinite(ours[10]).all():
        raise AssertionError(f"K4 recorded a non-finite value ({label})")
    print(f"{label}: all 11 outputs bit-equal: {bit_equal}")
    if not bit_equal:
        raise AssertionError(f"K4 is not bit-equal to its plain version ({label})")
    return ours, max_abs, bit_equal, plain_ms


def ev_path(dev, results):
    """Phases 13-16: the EV district through K4. Returns K4's entry of the
    ``kernels`` line."""
    phase("13. EV dataset, compile, pack")
    B, C, V, W = EV_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_ev_dataset(tmp, B, C, V, W, N_ROWS, SEED)
        cfg, params, _ = pack(compile_schema(schema), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_ev_dataset(tmp, B, C, V, W, N_ROWS, SEED, constraints=True)
        limited = pack(compile_schema(schema, episode_time_steps=SHORT_STEPS + 1), device=dev)[:2]
    if not (eligible_ev(cfg) and eligible_ev(limited[0])):
        raise AssertionError("the synthetic EV district is not kernel-eligible")
    S = cfg.time_steps - 1
    print(f"{cfg.n_buildings} buildings, {cfg.n_chargers} chargers, {cfg.n_evs} EVs, "
          f"{cfg.n_washing_machines} machine, {cfg.time_steps} rows, S={S} steps, reward "
          f"{cfg.reward_type}; the district with constraints: "
          f"{limited[0].n_charging_phases} phases")
    plans = ev_plans(C)

    phase(f"14. K4 vs plain at D={D}, B={B}, C={C}, V={V}, W={W}, S={QUARTER_STEPS}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda lo, hi, n: lo + (hi - lo) * torch.rand((D, n), generator=gen, device=dev)

    def seeded_states(inputs):
        """``inputs`` with states that differ from district to district."""
        cap, ev_cap = inputs["bparams"][0], inputs["evparams"][0]
        state0 = (rand(0.0, 1.0, B), rand(0.85, 0.95, B), (cap * rand(0.9, 1.0, B)).contiguous(),
                  rand(0.0, 1.0, V), rand(0.85, 0.95, V),
                  (ev_cap * rand(0.9, 1.0, V)).contiguous(), inputs["state0"][6])
        return dict(inputs, state0=state0)

    expand = lambda cfg_, params_, tables, n: ScriptedPolicy(tables).expanded(cfg_, params_, n)
    inputs = seeded_states(ev_episode_inputs(cfg, params, D, expand(cfg, params, plans, S)))
    if not inputs["use_ev_reward"]:
        raise AssertionError("the EV district does not use the EV reward")
    quarter = seeded_states(ev_episode_inputs(
        cfg, params, D, expand(cfg, params, plans, QUARTER_STEPS), n_steps=QUARTER_STEPS))
    ours, max_abs, bit_equal, plain_ms = compare_ev("quarter", quarter)
    rec = ours[10]
    conn, force, drift = (quarter["series"][i] for i in (4, 7, 8))
    applied = (quarter["actions"][1] != 0) & (conn >= 0)
    happened = {
        "a forced SOC": torch.isfinite(force).any(),
        "a drift": torch.isfinite(drift).any(),
        "a write-back to an EV": applied.any() and (rec[k4.R_CHC] != 0).any(),
        "an EV discharge": (rec[k4.R_CHC] < 0).any(),
        "a battery charge and discharge": (rec[k4.R_BBAL] > 0).any()
        and (rec[k4.R_BBAL] < 0).any(),
        "a machine trigger": (rec[k4.R_WMC] > 0).any(),
        "a reward term": (rec[k4.R_REW] > 0).any(),
        "districts that differ": not torch.equal(ours[1][0], ours[1][1]),
    }
    missing = [k for k, v in happened.items() if not bool(v)]
    if missing:
        raise AssertionError(f"the EV episode never saw: {missing}")
    print(f"seen over the quarter: {', '.join(happened)}; {int(applied.sum())} applied "
          f"charger-steps, {int(torch.isfinite(force).sum())} forced SOCs, "
          f"{int(torch.isfinite(drift).sum())} drifts")
    short = seeded_states(ev_episode_inputs(
        cfg, params, D, expand(cfg, params, plans, SHORT_STEPS), n_steps=SHORT_STEPS))
    _, err, eq, _ = compare_ev("default reward", dict(short, use_ev_reward=False))
    max_abs, bit_equal = max(max_abs, err), bit_equal and eq
    hard = dict(plans, electric_vehicle_storage=[1.0] * 24)
    bound = seeded_states(ev_episode_inputs(*limited, D, expand(*limited, hard, SHORT_STEPS)))
    if not (bound["viol"] > 0).any():
        raise AssertionError("the charging limits never bound")
    _, err, eq, _ = compare_ev("constraints", bound)
    max_abs, bit_equal = max(max_abs, err), bit_equal and eq
    print(f"limits bound on {int((bound['viol'] > 0).sum())} building-steps of "
          f"{SHORT_STEPS * B}")

    phase("15. EV main path")
    policy = ScriptedPolicy(plans)
    k4.ev_episode.launches = 0
    table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
    torch.cuda.synchronize()
    check_table(table, (), "EV evaluate_scripted", B)
    if k4.ev_episode.launches != 1:
        raise AssertionError("EV evaluate_scripted did not launch K4 once")
    states = batched_initial_states(cfg, params, D, device=dev)
    served = evaluate_districts(cfg, params, states, policy, device=dev)
    check_table(served, (D,), "EV evaluate_districts", B)
    if k4.ev_episode.launches != 2:
        raise AssertionError("EV evaluate_districts did not launch K4")
    for k, v in served.items():
        if not torch.equal(v[0].nan_to_num(), table[k].nan_to_num()):
            raise AssertionError(f"EV evaluate_districts dispatch differs on {k}")
    fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
    stepped_fn = lambda: evaluate_districts(
        cfg, params, states, policy.as_policy_fn(cfg, params, SHORT_STEPS),
        n_steps=SHORT_STEPS, device=dev)
    stepped = stepped_fn()
    torch.cuda.synchronize()
    launches = k4.ev_episode.launches
    print(f"K4 launches on the main path: {launches}")
    worst = table_error(fast, stepped)
    print(f"kernel vs stepped KPI table at S={SHORT_STEPS}, D={D}: max error {worst:.3e} "
          f"(tolerance {TOL_TABLE:g})")
    print("full-year district KPIs:")
    for k, v in table.items():
        if k.startswith("district|"):
            print(f"  {k[9:]:48s} {float(v):.6f}")

    phase("16. EV times")
    kernel_ms = time_cuda(lambda: k4.ev_episode(**inputs, record=True), 20)
    # the same year without the reward's phase (tree sum, multiplier, terms)
    default_ms = time_cuda(lambda: k4.ev_episode(**dict(inputs, use_ev_reward=False),
                                                 record=True), 10)
    eval_ms = time_cuda(lambda: evaluate_scripted(cfg, params, policy, n_districts=D,
                                                  device=dev), 5)
    stepped_ms = time_cuda(stepped_fn, 1)
    year = k4.ev_episode(**inputs, record=True)
    n_bytes = tensor_bytes(inputs) + tensor_bytes(year)
    knots = [inputs[k][0].shape[0] for k in ("curves", "ev_curves", "ch_curves")]
    n_ops = k4.operation_count(inputs["actions"], inputs["series"][4], *knots, V, D, True)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # PR 4-7's count: the charger requests and window tests in every district
    per_district_bound_ms = max(bytes_ms, D * k4.operation_count(
        inputs["actions"], inputs["series"][4], *knots, V, 1, True) / PEAK_FP32 * 1e3)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K4 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{default_ms:.4f} ms with the default reward); plain {plain_ms:.2f} ms for "
          f"{QUARTER_STEPS} steps; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms), "
          f"share of bound {bound_ms / kernel_ms:.2%}; by PR 4-7's count (the charger requests "
          f"in every district) {per_district_bound_ms:.4f} ms, "
          f"{per_district_bound_ms / kernel_ms:.2%}; nvidia-smi sm clock, draw, limit, temp: "
          f"{power}; build: {results.get('ptxas', {}).get('ev_episode')}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; stepped "
          f"evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms "
          f"({stepped_ms / SHORT_STEPS:.3f} ms per step)")
    results.update(
        k4_ms=kernel_ms, k4_default_reward_ms=default_ms, k4_plain_ms=plain_ms,
        k4_plain_steps=QUARTER_STEPS, k4_bound_ms=bound_ms, k4_bound_ops=n_ops,
        k4_bound_ms_pr7_count=per_district_bound_ms,
        k4_bound_bytes=n_bytes, k4_max_abs_err=max_abs, k4_bit_equal=bit_equal,
        k4_launches=launches, k4_table_error=worst,
        k4_district_steps_per_s=D * S / kernel_ms * 1e3,
        ev_evaluate_scripted_ms=eval_ms, ev_stepped_168_ms=stepped_ms,
        ev_district_kpis={k: float(v) for k, v in table.items() if k.startswith("district|")},
        ev_smi_after=power)
    return {
        "name": "ev_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/ev_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_ev.py:443",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "plain_steps": QUARTER_STEPS, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}


def lstm_plans():
    """Hour tables of the JAX package's LSTM bench row (``bench.py:145-151``):
    the cooling device at 0.8 of its power until 11:00 and 0.4 after, the
    DHW tank charging gently, the battery in the manner of BasicRBC."""
    hours = range(1, 25)
    return {"cooling_device": [0.8 if h < 12 else 0.4 for h in hours],
            "dhw_storage": [0.05] * 24,
            "electrical_storage": [0.091 if h < 9 else -0.08 for h in hours]}


def compare_lstm(label, inputs):
    """K5 against its plain version on ``inputs``: the physics outputs and
    rows must be bit-equal, the temperature, the reward and its sum within
    their tolerances. Returns (kernel outputs, a dict of the measured
    errors, the plain version's ms)."""
    ours = k5.lstm_episode(**inputs, record=True)
    ref, plain_ms = timed_once(lambda: k5.lstm_episode_reference(**inputs, record=True))
    rec, ref_rec = ours[9], ref[9]
    if not torch.isfinite(rec).all():
        raise AssertionError(f"K5 recorded a non-finite value ({label})")
    physics = 0.0
    rows = {row: (rec[row], ref_rec[row]) for row in range(k5.N_LREC)}
    pairs = list(zip(LSTM_OUTPUTS[1:8], ours[1:8], ref[1:8]))
    pairs += [(f"row {row}", *rows[row]) for row in rows if row not in (k5.R_TEMP, k5.R_REWARD)]
    for name, a, b in pairs:
        physics = max(physics, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"K5 {name} is not bit-equal to its plain version ({label}): "
                                 f"max|diff| {float((a - b).abs().max()):.3e}")
    temp = 0.0
    for name, a, b in (("last_temp", ours[8], ref[8]), ("temperature row", *rows[k5.R_TEMP])):
        temp = max(temp, float((a - b).abs().max()))
        if not ((a - b).abs() <= TEMP_RTOL * b.abs() + TEMP_ATOL).all():
            raise AssertionError(f"K5 {name} disagrees with its plain version ({label}): "
                                 f"{temp:.3e}")
    a, b = rows[k5.R_REWARD]
    flipped = float(((a - b).abs() > TEMP_RTOL * b.abs() + TEMP_ATOL).float().mean())
    reward_row = float((a - b).abs().max())
    if not flipped <= REWARD_FLIPS:
        raise AssertionError(f"K5 reward row: {flipped:.2%} of the steps differ ({label})")
    reward_sum, reward_rel = scaled_error(ours[0], ref[0])
    if not reward_rel <= TOL_REWARD_SUM:
        raise AssertionError(f"K5 reward sum disagrees with its plain version ({label}): "
                             f"{reward_rel}")
    print(f"{label}: 7 physics outputs and 11 physics rows bit-equal; temperature max|diff| "
          f"{temp:.3e} C (tolerance {TEMP_RTOL:g} |T| + {TEMP_ATOL:g}); reward row max|diff| "
          f"{reward_row:.3e} with {flipped:.3%} of the steps beyond the temperature's "
          f"tolerance (at most {REWARD_FLIPS:.1%}); reward sum max|diff| {reward_sum:.3e}, "
          f"scaled {reward_rel:.3e} (tolerance {TOL_REWARD_SUM:g}); plain {plain_ms:.0f} ms")
    errors = dict(physics=physics, temperature=temp, reward_row=reward_row,
                  reward_flipped=flipped, reward_sum=reward_sum, reward_sum_scaled=reward_rel)
    return ours, errors, plain_ms


def lstm_path(dev, results):
    """Phases 17-20: the LSTM-dynamics district through K5. Returns K5's
    entry of the ``kernels`` line."""
    phase("17. LSTM datasets, compile, pack")
    packed = {}
    for name, kw, steps in (("default", {}, None), ("outage", {"outage": True}, None),
                            ("heterogeneous", {"heterogeneous": True}, SHORT_STEPS + 1)):
        with tempfile.TemporaryDirectory() as tmp:
            schema = write_lstm_dataset(tmp, n_rows=N_ROWS, seed=SEED, **kw)
            packed[name] = pack(compile_schema(schema, episode_time_steps=steps), device=dev)[:2]
        if not lstm_packable(*packed[name]):
            raise AssertionError(f"the synthetic LSTM district ({name}) is not kernel-eligible")
    cfg, params = packed["default"]
    B, S = cfg.n_buildings, cfg.time_steps - 1
    lookback, layers, hidden, channels = cfg.dyn_groups[0][:4]
    print(f"{B} buildings, {cfg.time_steps} rows, S={S} steps, reward {cfg.reward_type}; "
          f"LSTM of {layers} layers x {hidden} units over {lookback} steps of {channels} "
          f"channels; the heterogeneous district: {packed['heterogeneous'][0].dyn_groups}; "
          f"outage steps of the district with outages over the year: "
          f"{int((packed['outage'][1].series.power_outage > 0).sum())}")
    tables = lstm_plans()

    phase(f"18. K5 vs plain at D={D}, B={B}, S={QUARTER_STEPS} (a summer quarter)")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def seeded_inputs(cfg_, params_, n_steps=None, data_offset=0):
        """K5's inputs with states that differ from district to district,
        a DHW plan that charges by night and discharges by day, and the
        DHW action converted by the DHW tank's own capacity (the reference
        converts by the heating tank's, 0 here), so that both orders of
        the DHW block run."""
        plans = dict(tables, dhw_storage=[0.05 if h < 7 else -0.04 for h in range(1, 25)])
        if bool((params_.cooling_storage.capacity > 0).any()):
            plans["cooling_storage"] = [0.05 if h < 7 else -0.03 for h in range(1, 25)]
        inputs = lstm_episode_inputs(cfg_, params_, D, plans, n_steps=n_steps,
                                     data_offset=data_offset)
        n = cfg_.n_buildings
        rand = lambda lo, hi: lo + (hi - lo) * torch.rand((D, n), generator=gen, device=dev)
        inputs.update(csoc0=rand(0.0, 1.0), dsoc0=rand(0.0, 1.0), soc0=rand(0.0, 1.0),
                      eff0=rand(0.85, 0.95),
                      deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous())
        inputs["tparams"] = inputs["tparams"].clone()
        inputs["tparams"][k5.DT_CONV] = inputs["tparams"][k5.DT_CAP]
        return inputs

    # the plain version re-runs 24 LSTM cells a step eagerly and takes two
    # to four minutes for the year: it is compared over a summer quarter
    inputs = seeded_inputs(cfg, params)
    quarter = seeded_inputs(cfg, params, QUARTER_STEPS, S // 2)
    ours, errors, plain_ms = compare_lstm("quarter", quarter)
    rec = ours[9]
    ideal = quarter["series"][8]
    happened = {
        "a prediction off the data temperature": (rec[k5.R_TEMP][lookback:]
                                                  - ideal[lookback:]).abs().max() > 0.5,
        "the data temperature before the window is full": torch.equal(rec[k5.R_TEMP][:lookback],
                                                                      ideal[:lookback]),
        "partial load": not torch.equal(rec[k5.R_CDEM], quarter["series"][4]),
        "both orders of the DHW block": (rec[k5.R_DBAL] > 0).any() and (rec[k5.R_DBAL] < 0).any(),
        "a battery charge and discharge": (rec[k5.R_BBAL] > 0).any()
        and (rec[k5.R_BBAL] < 0).any(),
        "a comfort penalty": (rec[k5.R_REWARD] < -1.0).any(),
        "districts that differ": not torch.equal(ours[1][0], ours[1][1]),
    }
    missing = [k for k, v in happened.items() if not bool(v)]
    if missing:
        raise AssertionError(f"the LSTM episode never saw: {missing}")
    print(f"seen over the quarter: {', '.join(happened)}; predicted temperature "
          f"{float(rec[k5.R_TEMP].min()):.2f} to {float(rec[k5.R_TEMP].max()):.2f} C")

    with_outage = seeded_inputs(*packed["outage"], n_steps=OUTAGE_STEPS)
    out_ours, err, _ = compare_lstm(f"outages, {OUTAGE_STEPS} steps", with_outage)
    errors = {k: max(v, err[k]) for k, v in errors.items()}
    out = with_outage["series"][13] > 0
    nsl = with_outage["series"][0]
    out_rec = out_ours[9]
    if not out.any():
        raise AssertionError("no outage step in the horizon")
    if float(out_rec[k5.R_NET][out].abs().max()) != 0.0:
        raise AssertionError("net consumption is not 0 under an outage")
    if not (out_rec[k5.R_NSLMET][out] < nsl[out] - 1e-6).any():
        raise AssertionError("no load went unserved under an outage")
    print(f"{int(out.sum())} outage building-steps: net 0 on all, load unserved on "
          f"{int((out_rec[k5.R_NSLMET][out] < nsl[out] - 1e-6).sum())}")
    mixed = seeded_inputs(*packed["heterogeneous"])
    mixed_ours, err, _ = compare_lstm(f"heterogeneous, {SHORT_STEPS} steps", mixed)
    errors = {k: max(v, err[k]) for k, v in errors.items()}
    cbal = mixed_ours[9][k5.R_CBAL][:, 1]
    if not ((cbal > 0).any() and (cbal < 0).any()):
        raise AssertionError("the cooling tank never took both orders")

    phase("19. LSTM main path")
    policy = ScriptedPolicy(tables)
    k5.lstm_episode.launches = 0
    table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
    torch.cuda.synchronize()
    check_table(table, (), "LSTM evaluate_scripted", B)
    if k5.lstm_episode.launches != 1:
        raise AssertionError("LSTM evaluate_scripted did not launch K5 once")
    states = batched_initial_states(cfg, params, D, device=dev)
    served = evaluate_districts(cfg, params, states, policy, device=dev)
    check_table(served, (D,), "LSTM evaluate_districts", B)
    if k5.lstm_episode.launches != 2:
        raise AssertionError("LSTM evaluate_districts did not launch K5")
    for k, v in served.items():
        if not torch.equal(v[0].nan_to_num(), table[k].nan_to_num()):
            raise AssertionError(f"LSTM evaluate_districts dispatch differs on {k}")
    fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
    stepped_fn = lambda: evaluate_districts(
        cfg, params, states, policy.as_policy_fn(cfg, params, SHORT_STEPS),
        n_steps=SHORT_STEPS, device=dev)
    stepped = stepped_fn()
    torch.cuda.synchronize()
    launches = k5.lstm_episode.launches
    print(f"K5 launches on the main path: {launches}")
    worst, worst_comfort = table_error(fast, stepped, COMFORT_STEPS)
    print(f"kernel vs stepped KPI table at S={SHORT_STEPS}, D={D}: max error {worst:.3e} "
          f"(tolerance {TOL_TABLE:g}); discomfort and resilience KPIs {worst_comfort:.3e} "
          f"(tolerance {COMFORT_STEPS} steps in {SHORT_STEPS})")
    print("full-year district KPIs:")
    for k, v in table.items():
        if k.startswith("district|"):
            print(f"  {k[9:]:48s} {float(v):.6f}")

    phase("20. LSTM times")
    kernel_ms = time_cuda(lambda: k5.lstm_episode(**inputs, record=True), 20)
    year_outage = seeded_inputs(*packed["outage"])
    outage_ms = time_cuda(lambda: k5.lstm_episode(**year_outage, record=True), 5)
    eval_ms = time_cuda(lambda: evaluate_scripted(cfg, params, policy, n_districts=D,
                                                  device=dev), 5)
    stepped_ms = time_cuda(stepped_fn, 1)
    year = k5.lstm_episode(**inputs, record=True)
    if not all(torch.isfinite(x).all() for x in year):
        raise AssertionError("K5 put out a non-finite value over the year")
    n_bytes = tensor_bytes(inputs) + tensor_bytes(year)
    n_knots = inputs["curves"][0].shape[0]
    n_ops = k5.operation_count(inputs["actions"], inputs["weights"], n_knots, lookback, D)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K5 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{outage_ms:.4f} ms on the district with outages); plain {plain_ms:.2f} ms for "
          f"{QUARTER_STEPS} steps; bound "
          f"{bound_ms:.4f} ms ({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> "
          f"{bytes_ms:.5f} ms), share of bound {bound_ms / kernel_ms:.2%}; build: "
          f"{results.get('ptxas', {}).get('lstm_episode')}; "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; stepped "
          f"evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms "
          f"({stepped_ms / SHORT_STEPS:.3f} ms per step)")
    max_abs = max(errors["physics"], errors["temperature"], errors["reward_row"],
                  errors["reward_sum"])
    results.update(
        k5_ms=kernel_ms, k5_outage_ms=outage_ms, k5_plain_ms=plain_ms,
        k5_plain_steps=QUARTER_STEPS, k5_bound_ms=bound_ms,
        k5_bound_ops=n_ops, k5_bound_bytes=n_bytes, k5_max_abs_err=max_abs, k5_errors=errors,
        k5_launches=launches, k5_table_error=worst, k5_table_error_comfort=worst_comfort,
        k5_district_steps_per_s=D * S / kernel_ms * 1e3,
        lstm_evaluate_scripted_ms=eval_ms, lstm_stepped_168_ms=stepped_ms,
        lstm_district_kpis={k: float(v) for k, v in table.items() if k.startswith("district|")},
        lstm_smi_after=power)
    return {
        "name": "lstm_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/lstm_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_lstm.py:456",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "plain_steps": QUARTER_STEPS, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}

def neighborhood_plans():
    """Hour tables of the JAX package's neighborhood bench row
    (``bench.py:229-234``) and of its quebec tests: the signed device
    action heats by morning and cools from noon, the heating device runs
    gently, the battery in the manner of BasicRBC."""
    hours = range(1, 25)
    return {"cooling_or_heating_device": [0.6 if h < 12 else -0.5 for h in hours],
            "heating_device": [0.3 if h < 8 else 0.1 for h in hours],
            "electrical_storage": [0.091 if h < 9 else -0.08 for h in hours]}


def hand_set_trees(cfg, params):
    """The quebec district with a hand-written tree in place of each
    building's inert ones, for both the increase and the decrease model:
    the root splits on (previous temperature - previous set point) at 0,
    its left child on the current set point at 21 C; every leaf asks for a
    change of 0.5 or 1.5 C. With the tree files absent from the card,
    this is what makes the occupants' triggers, holds and reversions run."""
    dev = params.device
    nodes = lambda rows, dtype: torch.tensor([rows, rows], dtype=dtype, device=dev).expand(
        cfg.n_buildings, 2, 5).contiguous()
    occ = dataclasses.replace(
        params.occupant,
        tree_feature=nodes([2, 0, -2, -2, -2], torch.int32),
        tree_children_left=nodes([1, 3, -1, -1, -1], torch.int32),
        tree_children_right=nodes([2, 4, -1, -1, -1], torch.int32),
        tree_threshold=nodes([0.0, 21.0, 0.0, 0.0, 0.0], torch.float32),
        tree_delta=nodes([0.0, 0.0, 0.5, 1.5, 0.5], torch.float32))
    return (dataclasses.replace(cfg, occupant_tree_depth=2),
            dataclasses.replace(params, occupant=occ))


def near_decisions(cfg, params, temp, csp, hsp, off):
    """(S, B) mask of the steps at which an occupant decision of the plain
    run lies within the temperature's tolerance: the interaction
    probability at T +- (TEMP_RTOL |T| + TEMP_ATOL) straddles the step's
    uniform draw, or the tree feature (previous temperature - previous set
    point) lies that close to a threshold it is compared with."""
    occ = params.occupant
    S = temp.shape[0]
    tol = TEMP_RTOL * temp.abs() + TEMP_ATOL
    rp = occ.random_probability[:S, None]
    straddles = torch.zeros_like(temp, dtype=torch.bool)
    for a, b in ((occ.a_increase, occ.b_increase), (occ.a_decrease, occ.b_decrease)):
        lo, hi = (torch.sigmoid(a[:S] + b[:S] * (temp + sign * tol)) for sign in (-1.0, 1.0))
        straddles |= (torch.minimum(lo, hi) <= rp) & (rp <= torch.maximum(lo, hi))
    ser = params.series
    end = off + cfg.time_steps - 1
    mode = ser.hvac_mode[off:off + S]
    prev_t = torch.cat([ser.indoor_dry_bulb_temperature[end][None], temp[:-1]])
    prev_c = torch.cat([ser.indoor_dry_bulb_temperature_cooling_set_point[end][None], csp[:-1]])
    prev_h = torch.cat([ser.indoor_dry_bulb_temperature_heating_set_point[end][None], hsp[:-1]])
    feature = prev_t - torch.where(mode == 2, prev_h, prev_c)
    prev_tol = torch.cat([tol[:1], tol[:-1]])
    split = occ.tree_feature == 2                              # (B, 2, N)
    thresholds = torch.where(split, occ.tree_threshold, torch.full_like(occ.tree_threshold,
                                                                         float("inf")))
    gap = (feature[:, :, None, None] - thresholds[None]).abs().amin(dim=(2, 3))
    return straddles | (gap <= prev_tol)


def compare_postpass(label, cfg, params, cool, heat, n_steps, off):
    """P6 against its plain version on one district's demand observations:
    temperature within TEMP_RTOL |T| + TEMP_ATOL; the set-point series
    and the occupants' final state equal, except that a building may part
    from the plain run at a step where the temperature's tolerance
    straddles a decision (``near_decisions``), after which its set points
    are not compared. Returns (kernel outputs, plain outputs, temperature
    max |diff|, buildings parted at such steps, the plain version's ms)."""
    ours = p6.neighborhood_postpass(cfg, params, cool, heat, n_steps, off)
    ref, plain_ms = timed_once(lambda: p6.neighborhood_postpass_reference(
        cfg, params, cool, heat, n_steps, off))
    temp, ref_temp = ours[0], ref[0]
    if not torch.isfinite(temp).all():
        raise AssertionError(f"P6 put out a non-finite temperature ({label})")
    temp_err = float((temp - ref_temp).abs().max())
    if not ((temp - ref_temp).abs() <= TEMP_RTOL * ref_temp.abs() + TEMP_ATOL).all():
        raise AssertionError(f"P6 temperature disagrees with its plain version ({label}): "
                             f"{temp_err:.3e}")
    differ = (ours[1] != ref[1]) | (ours[2] != ref[2])
    parted = 0
    if cfg.has_occupant:
        near = near_decisions(cfg, params, ref_temp, ref[1], ref[2], off)
        # the carried set points, overrides and counter must be equal; the
        # carried temperature is held to the temperature's tolerance
        exact = ("occ_csp_override", "occ_hsp_override", "occ_hold_counter", "occ_prev_csp",
                 "occ_prev_hsp")
        final = torch.stack([(a != b) & ~(a.isnan() & b.isnan()) for a, b in (
            (getattr(ours[3], k), getattr(ref[3], k)) for k in exact)]).any(0)[0]
        prev_t, ref_prev_t = ours[3].occ_prev_temp, ref[3].occ_prev_temp
        final |= ((prev_t - ref_prev_t).abs() > TEMP_RTOL * ref_prev_t.abs() + TEMP_ATOL)[0]
        for b in range(cfg.n_buildings):
            steps = differ[:, b].nonzero()
            if len(steps) == 0:
                if final[b]:
                    raise AssertionError(f"P6 occupant state of building {b} differs ({label})")
                continue
            first = int(steps[0])
            if not bool(near[first, b]):
                raise AssertionError(f"P6 occupant decision of building {b} at step {first} "
                                     f"differs away from any threshold ({label})")
            parted += 1
    elif differ.any():
        raise AssertionError(f"P6 set points differ without occupants ({label})")
    print(f"{label}: temperature max|diff| {temp_err:.3e} C (tolerance {TEMP_RTOL:g} |T| + "
          f"{TEMP_ATOL:g}); set points equal"
          + (f" except in {parted} buildings parted at a step within the temperature's "
             f"tolerance of a decision" if cfg.has_occupant else "")
          + f"; plain {plain_ms:.0f} ms for {n_steps} steps")
    return ours, ref, temp_err, parted, plain_ms


def neighborhood_path(dev, results):
    """Phases 21-25: the neighborhood districts through K6 and the
    post-pass P6. Returns the entries of both in the ``kernels`` line."""
    phase("21. neighborhood datasets, compile, pack")
    packed = {}
    for name, kw in (("eulp", dict(n_buildings=EULP_BUILDINGS)),
                     ("quebec", dict(n_buildings=QUEBEC_BUILDINGS, quebec=True))):
        with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
            warnings.simplefilter("ignore")           # the quebec trees are absent
            schema = write_neighborhood_dataset(tmp, n_rows=N_ROWS, seed=SEED, **kw)
            packed[name] = pack(compile_schema(schema), device=dev)[:2]
        if not neighborhood_packable(*packed[name]) \
                or kernel_family(packed[name][0]) != "neighborhood":
            raise AssertionError(f"the synthetic {name} district is not on the neighborhood "
                                 f"kernel")
    cfg, params = packed["eulp"]
    qcfg, qparams = packed["quebec"]
    B, S = cfg.n_buildings, cfg.time_steps - 1
    print(f"EULP shape: {B} buildings, {cfg.time_steps} rows, reward {cfg.reward_type}, "
          f"{len(cfg.dyn_groups)} LSTM groups {sorted({g[1:3] for g in cfg.dyn_groups})}, "
          f"channel widths summing to {sum(g[3] for g in cfg.dyn_groups)}; quebec shape: "
          f"{qcfg.n_buildings} buildings, reward {qcfg.reward_type}, occupants "
          f"{qcfg.has_occupant}, battery capacity {float(qparams.battery.capacity.max())}")
    tables = neighborhood_plans()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def seeded_inputs(cfg_, params_, n_steps=None, data_offset=0):
        """K6's inputs with states that differ from district to district."""
        inputs = neighborhood_episode_inputs(cfg_, params_, D, tables, n_steps=n_steps,
                                             data_offset=data_offset)
        rand = lambda lo, hi: lo + (hi - lo) * torch.rand((D, cfg_.n_buildings), generator=gen,
                                                          device=dev)
        inputs.update(dsoc0=rand(0.0, 1.0), soc0=rand(0.0, 1.0), eff0=rand(0.85, 0.95),
                      deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous())
        return inputs

    def compare_k6(label, inputs):
        ours = k6.neighborhood_episode(**inputs, record=True)
        ref, plain_ms = timed_once(lambda: k6.neighborhood_episode_reference(**inputs,
                                                                            record=True))
        worst = 0.0
        names = ("reward", "cost", "emission", "dhw_soc", "soc", "eff", "deg", "record")
        for name, a, b in zip(names, ours, ref):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"K6 {name} is not bit-equal to its plain version "
                                     f"({label}): max|diff| {float((a - b).abs().max()):.3e}")
            if not torch.isfinite(a).all():
                raise AssertionError(f"K6 {name} is not finite ({label})")
        print(f"{label}: 7 outputs and {k6.N_NREC} rows bit-equal; plain {plain_ms:.0f} ms")
        return ours, worst, plain_ms

    phase(f"22. K6 vs plain at D={D}, B={B}, S={QUARTER_STEPS} (a spring quarter)")
    quarter = seeded_inputs(cfg, params, QUARTER_STEPS, SPRING)
    ours, k6_err, k6_plain_ms = compare_k6("EULP quarter", quarter)
    rec = ours[7]
    series = quarter["series"]
    lookback = quarter["lookback"]
    happened = {
        "partial-load cooling": not torch.equal(rec[k6.R_CDEM][lookback + 1:],
                                                series[4][lookback + 1:]),
        "partial-load heating": not torch.equal(rec[k6.R_HDEM][lookback + 1:],
                                                series[5][lookback + 1:]),
        "the data's demand before the window is full": torch.equal(
            rec[k6.R_HDEM][:lookback + 1], series[5][:lookback + 1]),
        "hvac modes 1 and 3": {1.0, 3.0} <= set(series[8].unique().tolist()),
        "a battery charge and discharge": (rec[k6.R_BBAL] > 0).any()
        and (rec[k6.R_BBAL] < 0).any(),
        "the DHW tank decaying": (rec[k6.R_DSOC][1:] < rec[k6.R_DSOC][:-1]).any(),
        "a heating device that is not a heat pump": (quarter["nparams"][k6.HHP] < 0.5).any(),
        "districts that differ": not torch.equal(ours[1][0], ours[1][1]),
    }
    missing = [k for k, v in happened.items() if not bool(v)]
    if missing:
        raise AssertionError(f"the neighborhood episode never saw: {missing}")
    print(f"seen over the quarter: {', '.join(happened)}")
    quebec_in = seeded_inputs(qcfg, qparams, QUEBEC_STEPS)
    quebec_out, err, _ = compare_k6(f"quebec, null battery, {QUEBEC_STEPS} steps", quebec_in)
    k6_err = max(k6_err, err)
    if float(quebec_out[7][k6.R_BBAL].abs().max()) != 0.0:
        raise AssertionError("the null battery moved")

    phase("23. P6 vs plain on K6's recorded demand observations")
    first = lambda r, n: (r[k6.R_COUT][:n].contiguous(), r[k6.R_HOUT][:n].contiguous())
    _, _, p6_err, _, p6_plain_ms = compare_postpass(
        f"EULP, {SHORT_STEPS} steps", cfg, params, *first(rec, SHORT_STEPS), SHORT_STEPS,
        SPRING)
    tcfg, tparams = hand_set_trees(qcfg, qparams)
    q_ours, q_ref, err, parted, _ = compare_postpass(
        f"quebec with hand-set trees, {QUEBEC_STEPS} steps", tcfg, tparams,
        *first(quebec_out[7], QUEBEC_STEPS), QUEBEC_STEPS, 0)
    p6_err = max(p6_err, err)
    data = tparams.series.indoor_dry_bulb_temperature_heating_set_point[:QUEBEC_STEPS]
    moved = q_ref[2] != data
    counts = dict(overridden_steps=int(moved.sum()),
                  reversions=int((moved[:-1] & ~moved[1:]).sum()),
                  increases=int((q_ref[2] > data).sum()), decreases=int((q_ref[2] < data).sum()))
    if not all(counts.values()):
        raise AssertionError(f"the occupants never acted in full: {counts}")
    print(f"quebec occupants (plain run): {counts}; buildings parted at a near-threshold "
          f"step: {parted} of {qcfg.n_buildings}")
    # the path of hidden sizes outside the compiled ones (weights through
    # L1, wider blocks): LSTM districts of 20 units, and of 50 beside 8, on
    # the cooling observations of K5's plain version
    for name, kw in (("20 units", dict(hidden_size=20)),
                     ("50 units beside 8", dict(heterogeneous=True))):
        with tempfile.TemporaryDirectory() as tmp:
            schema = write_lstm_dataset(tmp, n_rows=N_ROWS, seed=SEED, **kw)
            wcfg, wparams = pack(compile_schema(schema, episode_time_steps=SHORT_STEPS + 1),
                                 device=dev)[:2]
        k5_rec = k5.lstm_episode_reference(
            **lstm_episode_inputs(wcfg, wparams, 1, lstm_plans()), record=True)[9]
        cool = (k5_rec[k5.R_COUT] + k5_rec[k5.R_CBAL].neg().clamp(min=0.0)).contiguous()
        _, _, err, _, _ = compare_postpass(f"LSTM district of {name}, {SHORT_STEPS} steps", wcfg,
                                           wparams, cool, torch.zeros_like(cool), SHORT_STEPS, 0)
        p6_err = max(p6_err, err)

    phase("24. neighborhood main path")
    policy = ScriptedPolicy(tables)
    k6.neighborhood_episode.launches = 0
    p6.postpass_kernel.launches = 0
    t0 = time.perf_counter()
    table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = k6.neighborhood_episode.launches
    p6_launches = p6.postpass_kernel.launches
    print(f"K6 launches on the main path: {launches}; P6 launches: {p6_launches} "
          f"({main_s:.2f} s)")
    if launches != 1 or p6_launches != 1:
        raise AssertionError("evaluate_scripted did not run one K6 and one P6 launch")
    check_table(table, (), "neighborhood evaluate_scripted", B)
    worst = {}
    for name, (c, p), n in (("quebec", (qcfg, qparams), SHORT_STEPS),
                            ("EULP", (cfg, params), EULP_TABLE_STEPS)):
        states = batched_initial_states(c, p, 8, device=dev)
        fast = evaluate_districts(c, p, states, policy, n_steps=n, device=dev)
        t0 = time.perf_counter()
        stepped = evaluate_districts(c, p, states, policy.as_policy_fn(c, p, n), n_steps=n,
                                     device=dev)
        torch.cuda.synchronize()
        results[f"{name.lower()}_stepped_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n
        worst[name] = table_error(fast, stepped, COMFORT_STEPS, n)
        print(f"{name}: kernel vs stepped KPI table at S={n}, D=8: max error "
              f"{worst[name][0]:.3e} (tolerance {TOL_TABLE:g}); discomfort and resilience KPIs "
              f"{worst[name][1]:.3e} (tolerance {COMFORT_STEPS} steps in {n}); stepped "
              f"{results[f'{name.lower()}_stepped_ms_per_step']:.1f} ms per step")
    print("full-year district KPIs:")
    for k, v in table.items():
        if k.startswith("district|"):
            print(f"  {k[9:]:48s} {float(v):.6f}")

    phase("25. neighborhood times")
    year = neighborhood_episode_inputs(cfg, params, D, tables)
    kernel_ms = time_cuda(lambda: k6.neighborhood_episode(**year, record=True), 5)
    out = k6.neighborhood_episode(**year, record=True)
    if not all(torch.isfinite(x).all() for x in out):
        raise AssertionError("K6 put out a non-finite value over the year")
    n_knots = year["curves"][0].shape[0]
    n_bytes = tensor_bytes(year) + tensor_bytes(out)
    n_ops = k6.operation_count(year["actions"], n_knots, D)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # PR 6-7's count: the prelude's work in every district
    per_district_bound_ms = max(bytes_ms, D * k6.operation_count(year["actions"], n_knots, 1)
                                / PEAK_FP32 * 1e3)
    post = p6.postpass_inputs(cfg, params, out[7][k6.R_COUT][:, :].contiguous(),
                              out[7][k6.R_HOUT].contiguous(), S)
    p6_ms = time_cuda(lambda: p6.postpass_kernel(**post), 10)
    p6_out = p6.postpass_kernel(**post)
    if not torch.isfinite(p6_out[0]).all():
        raise AssertionError("P6 put out a non-finite temperature over the year")
    p6_bytes = tensor_bytes(post) + tensor_bytes(p6_out[:3])
    p6_ops = p6.operation_count(post["weights"], post["lookback"], S)
    p6_bytes_ms, p6_ops_ms = p6_bytes / PEAK_BYTES * 1e3, p6_ops / PEAK_FP32 * 1e3
    p6_bound_ms = max(p6_bytes_ms, p6_ops_ms)
    eval_ms = time_cuda(lambda: evaluate_scripted(cfg, params, policy, n_districts=D,
                                                  device=dev), 5)
    # P6's chain: the cells of its longest building run one after another
    lookback = post["lookback"]
    chain_cells = max(max(S - lookback, 0) * lookback * u[k5.M_LAYERS]
                      for u in post["weights"].units)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    chain_ms = chain_cells * CELL_CYCLES / (clock_mhz * 1e3)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K6 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s); "
          f"plain {k6_plain_ms:.2f} ms for {QUARTER_STEPS} steps; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms), "
          f"share of bound {bound_ms / kernel_ms:.2%}; by PR 6-7's count (the prelude's work in "
          f"every district) {per_district_bound_ms:.4f} ms, "
          f"{per_district_bound_ms / kernel_ms:.2%}; build: "
          f"{results.get('ptxas', {}).get('neighborhood_episode')}")
    print(f"P6 {p6_ms:.2f} ms for the year of {B} buildings; plain {p6_plain_ms:.2f} ms for "
          f"{SHORT_STEPS} steps; bound {p6_bound_ms:.4f} ms ({p6_ops:.4g} fp32 ops -> "
          f"{p6_ops_ms:.4f} ms, {p6_bytes} bytes -> {p6_bytes_ms:.5f} ms), share of bound "
          f"{p6_bound_ms / p6_ms:.3%}; chain floor {chain_ms:.3f} ms ({chain_cells} cells in "
          f"sequence x {CELL_CYCLES} cycles at {clock_mhz:.0f} MHz), {p6_ms / chain_ms:.2f}x "
          f"of it; build: {results.get('ptxas', {}).get('neighborhood_postpass')}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; nvidia-smi sm clock, draw, "
          f"limit, temp: {power}")
    results.update(
        k6_ms=kernel_ms, k6_plain_ms=k6_plain_ms, k6_plain_steps=QUARTER_STEPS,
        k6_bound_ms=bound_ms, k6_bound_ops=n_ops, k6_bound_bytes=n_bytes, k6_max_abs_err=k6_err,
        k6_bound_ms_pr7_count=per_district_bound_ms,
        k6_launches=launches, k6_district_steps_per_s=D * S / kernel_ms * 1e3,
        p6_ms=p6_ms, p6_plain_ms=p6_plain_ms, p6_plain_steps=SHORT_STEPS,
        p6_bound_ms=p6_bound_ms, p6_bound_ops=p6_ops, p6_bound_bytes=p6_bytes,
        p6_chain_cells=chain_cells, p6_chain_floor_ms=chain_ms,
        p6_max_abs_err=p6_err, p6_launches=p6_launches, p6_quebec_parted=parted,
        p6_quebec_occupants=counts, neighborhood_table_error=worst,
        neighborhood_evaluate_scripted_ms=eval_ms, neighborhood_main_path_s=main_s,
        neighborhood_district_kpis={k: float(v) for k, v in table.items()
                                    if k.startswith("district|")},
        neighborhood_smi_after=power)
    return [{
        "name": "neighborhood_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/neighborhood_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_neighborhood.py:309",
        "launches": launches, "max_abs_err": k6_err, "ms": kernel_ms,
        "plain_ms": k6_plain_ms, "plain_steps": QUARTER_STEPS, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}, {
        "name": "neighborhood_postpass", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/neighborhood_postpass.cu",
        "replaces": "citylearn_tpu/core/neighborhood_eval.py:45 (an XLA scan, no Pallas kernel)",
        "launches": p6_launches, "max_abs_err": p6_err, "ms": p6_ms,
        "plain_ms": p6_plain_ms, "plain_steps": SHORT_STEPS, "bound_ms": p6_bound_ms,
        "bound_by": "bytes" if p6_bytes_ms > p6_ops_ms else "operations",
        "library_ms": None}]


def train_rates(tr, results, key):
    """Time FAMILY_CHUNK-step chunks of ``tr`` with and without their SAC
    updates; records and returns (ms per step, collect ms per step,
    district-steps/s)."""
    n = tr.cfg.n_districts
    chunk_ms = time_cuda(lambda: tr.train(FAMILY_CHUNK, chunk=FAMILY_CHUNK), 2)
    tr._update = lambda t, n_slots: None       # the same chunks without their updates
    collect_ms = time_cuda(lambda: tr.train(FAMILY_CHUNK, chunk=FAMILY_CHUNK), 2)
    del tr._update
    step_ms, collect_step_ms = chunk_ms / FAMILY_CHUNK, collect_ms / FAMILY_CHUNK
    rate = n * FAMILY_CHUNK / chunk_ms * 1e3
    results.update({f"{key}_train_step_ms": step_ms, f"{key}_collect_step_ms": collect_step_ms,
                    f"{key}_update_step_ms": step_ms - collect_step_ms,
                    f"{key}_train_district_steps_per_s": rate})
    return step_ms, collect_step_ms, rate


def check_trained(tr, w0, hist, label, reward_from=0):
    """The policy head moved, every reward is finite and some reward row
    from step ``reward_from`` on is non-zero."""
    moved = float((tr.base_state.nets.policy.mean_w.detach() - w0).abs().max())
    rew = tr.base_state.replay_rew[:FAMILY_WARMUP + FAMILY_STEPS]
    if not moved > 0:
        raise AssertionError(f"{label}: no SAC update changed the policy")
    if not (all(torch.isfinite(torch.tensor(hist))) and torch.isfinite(rew).all()):
        raise AssertionError(f"{label}: non-finite rewards")
    if not float(rew[reward_from:].abs().max()) > 0:
        raise AssertionError(f"{label}: every reward from step {reward_from} on is zero")
    return moved


def twin_q_grads(values, nets, act, dq, param_grads):
    """The gradients of sum(dq * values) to both networks' parameters or,
    without ``param_grads``, to ``act`` alone."""
    loss = (dq[0] * values[0]).sum() + (dq[1] * values[1]).sum()
    return torch.autograd.grad(loss, [*nets[0].parameters(), *nets[1].parameters()]
                               if param_grads else [act])


def twin_q_check(q1, q2, obs, act, label):
    """``twin_q``'s kernels on ``obs`` and ``act`` (a leaf), both ways
    that the update asks: values against two ``SoftQ.forward`` calls and
    against the plain version in float64 on the kernels' relu branches,
    whose flips it checks, and every parameter's gradient, then the
    action's alone, against the float64 one; returns the worst of each
    reading."""
    A, N, _ = obs.shape
    dq = torch.randn((2, A, N, 1), generator=torch.Generator(device=obs.device).manual_seed(SEED),
                     device=obs.device)
    wide = [copy.deepcopy(q).double() for q in (q1, q2)]
    wide_act = act.detach().double().requires_grad_()
    gap = lambda ours, ref: max(float(torch.linalg.vector_norm((x - y).double())
                                      / torch.linalg.vector_norm(y.double()))
                                for x, y in zip(ours, ref))
    value_gap = lambda ours, ref: max(float((x - y).detach().abs().max() / y.abs().mean())
                                      for x, y in zip(ours, ref))
    worst = {}
    for param_grads in (True, False):
        out = twin_q_mod.twin_q(q1, q2, obs, act, param_grads=param_grads)
        branches = twin_q_mod.relu_branches(out[0])
        ref, pre, scale = twin_q_mod.reference(*wide, obs.double(), wide_act, relu=branches)
        flips, flip_eps = twin_q_mod.branch_flips(branches, pre, scale)
        with torch.no_grad():
            plain = (q1(obs, act), q2(obs, act))
        found = {"value_gap": value_gap(out, ref), "plain_value_gap": value_gap(out, plain),
                 "grad_gap": gap(twin_q_grads(out, (q1, q2), act, dq, param_grads),
                                 twin_q_grads(ref, wide, wide_act, dq.double(), param_grads)),
                 "flips": flips, "flip_eps": flip_eps,
                 "max_abs_err": max(float((x - y).abs().max()) for x, y in zip(out, plain))}
        print(f"{label}, param_grads={param_grads}: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in found.items()))
        n_elements = sum(b.numel() for b in branches)
        if flip_eps > TWIN_FLIP_EPS or flips > 1 + TWIN_FLIP_SHARE * n_elements:
            raise AssertionError(f"{label}: {flips} relu branches of {n_elements} differ from "
                                 f"float64's, up to {flip_eps:.3g} epsilons of their scale")
        if not (found["value_gap"] < TOL_TWIN and found["plain_value_gap"] < TOL_TWIN
                and found["grad_gap"] < TOL_TWIN):
            raise AssertionError(f"{label}: twin_q against the plain version: {found}")
        worst = {k: max(v, worst.get(k, v)) for k, v in found.items()}
    return worst


def twin_q_times(q1, q2, obs, act, nxt):
    """Device milliseconds of an update's three twin passes (the target's,
    the critics' with their parameters' gradients, the policy loss's with
    the action's), the kernels and two ``SoftQ.forward`` calls with
    autograd, each as a CUDA graph of 20; and the passes' fp32 operations
    in their products."""
    A, N, K = obs.shape
    M = act.shape[-1]
    dq = torch.randn((2, A, N, 1), device=obs.device)
    plain = lambda q1_, q2_, o, a, param_grads=True: (q1_(o, a), q2_(o, a))

    def passes(fn):
        with torch.no_grad():
            fn(q1, q2, nxt, act.detach())
        twin_q_grads(fn(q1, q2, obs, act), (q1, q2), act, dq, True)
        twin_q_grads(fn(q1, q2, obs, act, param_grads=False), (q1, q2), act, dq, False)

    side = torch.cuda.Stream()       # PyTorch's warm-up of autograd before a capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in (twin_q_mod.twin_q, plain) * 3:
            passes(fn)
    torch.cuda.current_stream().wait_stream(side)
    kernel_ms = time_graph(lambda: passes(twin_q_mod.twin_q), 20)
    plain_ms = time_graph(lambda: passes(plain), 20)
    sizes = [K + M, *(g.shape[-1] for g in q1.ln_scale), 1]
    layers = list(zip(sizes[:-1], sizes[1:]))
    products = lambda pairs: 2 * 2 * A * N * sum(i * o for i, o in pairs)
    n_ops = (3 * products(layers)                               # three forwards
             + products(layers) + products(layers[1:])          # the critics': dW, dX past layer 0
             + products(layers[1:]) + products([(M, sizes[1])]))    # the policy loss's dX
    return kernel_ms, plain_ms, n_ops


def twin_q_path(dev, tr, results):
    """Phase 8(e): the twin soft-Q kernels on the main path of the trainer
    ``tr``, on its own critics and at the cell's shapes; returns the row
    of the ``kernels`` line."""
    nets = tr.state.nets
    per_step = 6 * len(nets.q1.ln_scale)     # launches a _sac_step: 3 L forward, 3 L backward
    nets.update_graph = Graph("sac")         # captured anew by the next chunk
    twin_q_mod.twin_q.launches = 0
    batches = []
    shipped = train_module.sac_update

    def keep(agent_nets, batch, *args, **kw):
        if not batches:
            batches.append([x.clone() for x in batch])
        return shipped(agent_nets, batch, *args, **kw)

    train_module.sac_update = keep
    try:
        with tracing.recording() as rec:
            tr.train(K_CHUNK, chunk=K_CHUNK)
        torch.cuda.synchronize()
    finally:
        train_module.sac_update = shipped
    launches = twin_q_mod.twin_q.launches
    steps, replays = len(rec.durations("sac.target")), len(rec.durations("sac.graph"))
    print(f"(e) {K_CHUNK} steps capturing the update anew: twin_q launches {launches}, "
          f"{len(rec.durations('twin_q'))} twin passes, {steps} _sac_step runs (eager and "
          f"capture), {replays} replays")
    if not steps or launches != per_step * steps or not replays:
        raise AssertionError(f"want {per_step} twin_q launches in each of the {steps} "
                             f"_sac_step runs and replays after them, got {launches} launches "
                             f"and {replays} replays")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof, \
            tracing.recording() as rec:
        tr.train(K_CHUNK, chunk=K_CHUNK)
        torch.cuda.synchronize()
    replays = len(rec.durations("sac.graph"))
    twin_kernels = sum(e.count for e in prof.key_averages()
                       if any(k in e.key for k in TWIN_KERNELS))
    print(f"one more chunk under the profiler: {replays} replays, {twin_kernels} twin kernels "
          f"on the device")
    if not replays or twin_kernels != per_step * replays:
        raise AssertionError(f"want {per_step} twin kernels in each of {replays} replays, "
                             f"got {twin_kernels}")

    # the kernels on the trainer's critics and a batch its update drew,
    # then at the cell's shapes on seeded networks and rows, where they are
    # also timed (the checks first: PyTorch ties an autograd graph's leaves
    # to the stream that made them, so none may live into a capture)
    obs, act, _, nxt, _ = batches[0]
    print(f"the trainer's batch: A, N, K, M = {(*obs.shape, act.shape[-1])}")
    worst = twin_q_check(nets.q1, nets.q2, obs, act.requires_grad_(), "the trainer's critics")
    (A, K, M, hidden), N = TWIN_CELL, TRAIN["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q1, q2 = (sac.SoftQ(A, K, M, hidden, gen, dev) for _ in range(2))
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    obs, nxt = (draw(N, A * K).view(N, A, K).transpose(0, 1) for _ in range(2))
    act = draw(A, N, M).tanh().requires_grad_()
    cell = twin_q_check(q1, q2, obs, act, f"A={A}, N={N}, {K + M} -> {hidden} -> 1")
    worst = {k: max(v, cell[k]) for k, v in worst.items()}
    kernel_ms, plain_ms, n_ops = twin_q_times(q1, q2, obs, act, nxt)
    bound_ms = n_ops / PEAK_FP32 * 1e3
    print(f"twin_q at A={A}, N={N}, {K + M} -> {hidden} -> 1: an update's three passes "
          f"{kernel_ms:.4f} ms on the device (CUDA graphs of 20), plain (two SoftQ.forward and "
          f"autograd) {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({n_ops / 1e9:.4f} GFLOP of "
          f"products at {PEAK_FP32 / 1e12:g} TFLOP/s fp32), share of bound "
          f"{bound_ms / kernel_ms:.2%}; build: {ptxas_report(results, 'twin_q')}")
    results.update(twin_q_launches=launches, twin_q_ms=kernel_ms, twin_q_plain_ms=plain_ms,
                   twin_q_bound_ms=bound_ms, twin_q_bound_ops=n_ops,
                   **{f"twin_q_{k}": v for k, v in worst.items()})
    return {"name": "twin_q", "route": "cuda", "source": "citylearn_tpu_torch/csrc/twin_q.cu",
            "replaces": None, "launches": launches, "max_abs_err": worst["max_abs_err"],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None}


def family_training(dev, results):
    """Phase 26: ``BatchedSAC`` on the thermal, EV, LSTM and neighborhood
    districts, each on the per-step collect."""
    phase("26. training on the families")
    t_phase = time.perf_counter()
    families = (("thermal", thermal_rbc_tables()), ("ev", ev_plans(EV_SHAPE[1])),
                ("lstm", lstm_plans()), ("eulp", neighborhood_plans()),
                ("quebec", neighborhood_plans()))
    kernels_of = {"thermal": (k3.thermal_episode,), "ev": (k4.ev_episode,),
                  "lstm": (k5.lstm_episode,),
                  "neighborhood": (k6.neighborhood_episode, p6.postpass_kernel)}
    for name, plans in families:
        t0 = time.perf_counter()
        n = FAMILY_D[name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")           # the quebec trees are absent
            tr = BatchedSAC(named_dataset(name), TrainConfig(
                warmup_steps=FAMILY_WARMUP, **dict(TRAIN, n_districts=n, replay_capacity=n * 64)),
                random_seed=SEED, episode_time_steps=TRAIN_EPISODE, device=dev)
        set_up_s = time.perf_counter() - t0
        if tr.use_kernel_collect:
            raise AssertionError(f"{name}: the trainer took the kernel collect")
        B = tr.env_cfg.n_buildings
        family_kernels = kernels_of[kernel_family(tr.env_cfg)]
        w0 = tr.base_state.nets.policy.mean_w.detach().clone()
        k2.battery_collect_chunk.launches = 0
        hist = tr.train(FAMILY_WARMUP + FAMILY_STEPS, chunk=FAMILY_WARMUP + FAMILY_STEPS)
        torch.cuda.synchronize()
        if k2.battery_collect_chunk.launches:
            raise AssertionError(f"{name}: the per-step path launched K2")
        moved = check_trained(tr, w0, hist, name, EV_REWARD_FROM if name == "ev" else 0)
        step_ms, collect_ms, rate = train_rates(tr, results, name)
        t0 = time.perf_counter()
        learned = tr.evaluate(n_steps=SHORT_STEPS)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        check_table(learned, (n,), f"{name} BatchedSAC.evaluate", B)
        for kernel in family_kernels:
            kernel.launches = 0
        baseline = tr.evaluate(policy=ScriptedPolicy(plans))
        torch.cuda.synchronize()
        launched = {kernel.__name__: kernel.launches for kernel in family_kernels}
        if not all(launched.values()):
            raise AssertionError(f"{name}: evaluate(policy=ScriptedPolicy) launched {launched}")
        check_table(baseline, (n,), f"{name} BatchedSAC.evaluate(ScriptedPolicy)", B)
        results.update({f"{name}_train_evaluate_168_s": eval_s,
                        f"{name}_train_set_up_s": set_up_s})
        print(f"{name}: D={n}, B={B}, obs {tr.obs_dim}, act {tr.act_dim}; set-up "
              f"{set_up_s:.1f} s; "
              f"{FAMILY_WARMUP}+{FAMILY_STEPS} steps on the per-step path, policy head moved "
              f"by {moved:.3e}, mean reward per step {hist[0]:.4f}; train step {step_ms:.2f} ms "
              f"(collect {collect_ms:.2f}, update {step_ms - collect_ms:.2f}) = {rate:.4g} "
              f"district-steps/s; evaluate at S={SHORT_STEPS} {eval_s:.2f} s, cost_total "
              f"{float(learned['district|cost_total'].mean()):.6f}; scripted plan through "
              f"{launched}, cost_total {float(baseline['district|cost_total'][0]):.6f}")
        del tr
    results["family_training_s"] = time.perf_counter() - t_phase
    print(f"phase 26: {results['family_training_s']:.1f} s; {nvidia_smi()}")


def marlisa_training(dev, results):
    """Phase 27: ``BatchedMARLISA`` on the battery+PV district."""
    phase(f"27. batched MARLISA at D={D}")
    t_phase = time.perf_counter()
    tr = BatchedMARLISA(named_dataset("battery"),
                        TrainConfig(warmup_steps=FAMILY_WARMUP, **TRAIN), random_seed=SEED,
                        regression_update_every=MARLISA_EVERY,
                        episode_time_steps=TRAIN_EPISODE, device=dev)
    if tr.use_kernel_collect:
        raise AssertionError("MARLISA took the kernel collect")
    w0 = tr.base_state.nets.policy.mean_w.detach().clone()
    hist = tr.train(FAMILY_WARMUP + FAMILY_STEPS, chunk=FAMILY_WARMUP + FAMILY_STEPS)
    torch.cuda.synchronize()
    moved = check_trained(tr, w0, hist, "MARLISA")
    ms = tr.state
    cv_total = float(ms.cv[..., 0].abs().max())
    if not (float(ms.reg_w.abs().max()) > 0 and cv_total > 0):
        raise AssertionError("MARLISA: the ridge weights or the coordination variables are zero")
    if not torch.equal(ms.cv[..., 1], tr.cap_dispatched.expand(ms.cv.shape[:2])):
        raise AssertionError("MARLISA: the capacity variables are not the dispatched shares")
    step_ms, collect_ms, rate = train_rates(tr, results, "marlisa")
    t0 = time.perf_counter()
    table = tr.evaluate(n_steps=SHORT_STEPS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    check_table(table, (D,), "BatchedMARLISA.evaluate")
    results.update(marlisa_evaluate_168_s=eval_s,
                   marlisa_s=time.perf_counter() - t_phase)
    print(f"MARLISA: {tr.iterations} sweeps of the ring over {N_BUILDINGS} agents, ridge of "
          f"{tr.reg_dim} features refit every {MARLISA_EVERY} steps; policy head moved by "
          f"{moved:.3e}, |cv total| up to {cv_total:.4f}; step {step_ms:.2f} ms (ring, step and "
          f"ridge {collect_ms:.2f}, update {step_ms - collect_ms:.2f}) = {rate:.4g} "
          f"district-steps/s; evaluate with the live ring at S={SHORT_STEPS} {eval_s:.2f} s, "
          f"cost_total {float(table['district|cost_total'].mean()):.6f}")
    print(f"phase 27: {results['marlisa_s']:.1f} s; {nvidia_smi()}")


def plan_actions(env, plans):
    """``s -> the env's action lists at step s`` under a family's expanded
    plans (name -> (S, n)): building actions by building, charger actions
    by charger, machine actions by machine; actions without a plan act 0."""
    slot = {}
    for key, names in (("electric_vehicle_storage",
                        [f"electric_vehicle_storage_{ch.charger_id}"
                         for b in env.spec.buildings for ch in b.chargers]),
                       ("washing_machine",
                        [wm.name for b in env.spec.buildings for wm in b.washing_machines])):
        slot.update({name: (key, i) for i, name in enumerate(names)})
    cols = [[slot.get(name, (name, bi)) for name in b.active_actions]
            for bi, b in enumerate(env.spec.buildings)]

    def actions(s):
        lists = [[float(plans[k][s, i]) if k in plans else 0.0 for k, i in row]
                 for row in cols]
        return [sum(lists, [])] if env.central_agent else lists

    return actions


def env_rows_error(rows, table, comfort_steps, steps):
    """Largest error of the env's KPI rows against a kernel-backed table,
    relative to max(|value|, 1); raises beyond ``TOL_ENV`` (the
    discomfort and resilience KPIs may also move by ``comfort_steps`` steps
    in ``steps``). An undefined row (None) must be NaN in the table."""
    by_key = {}
    for r in rows:
        v = float("nan") if r["value"] is None else r["value"]
        by_key.setdefault(f"{r['level']}|{r['cost_function']}", []).append(v)
    if set(by_key) != set(table):
        raise AssertionError(f"env rows and kernel table differ in KPIs: "
                             f"{sorted(set(by_key) ^ set(table))}")
    worst = worst_comfort = 0.0
    for k, b in table.items():
        a = torch.tensor(by_key[k], dtype=torch.float64)
        b = b.double().reshape(-1).cpu()
        if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError(f"env rows and kernel table differ in shape or NaN on {k}")
        finite = ~b.isnan()
        err = float(((a - b).abs()[finite] / b.abs()[finite].clamp(min=1.0)).max()) \
            if finite.any() else 0.0
        comfort = comfort_steps and k.split("|")[1].startswith(
            ("discomfort", "one_minus_thermal_resilience"))
        tol = TOL_ENV + (comfort_steps / steps if comfort else 0.0)
        if comfort:
            worst_comfort = max(worst_comfort, err)
        else:
            worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"env rows vs kernel table at S={steps}: {k} {err}")
    return worst, worst_comfort


def env_path(dev, results):
    """Phase 28: the Gym env on the card, each family's KPI rows against
    its kernel's table, steps/s, and the parity mode against the CPU."""
    phase("28. the Gym env on the card")
    t_phase = time.perf_counter()
    families = (
        ("battery", {"electrical_storage": basic_rbc_table()}, (k1.battery_episode,)),
        ("thermal", thermal_rbc_tables(), (k3.thermal_episode,)),
        ("ev", ev_plans(EV_SHAPE[1]), (k4.ev_episode,)),
        ("lstm", lstm_plans(), (k5.lstm_episode,)),
        ("eulp", neighborhood_plans(), (k6.neighborhood_episode, p6.postpass_kernel)),
        ("quebec", neighborhood_plans(), (k6.neighborhood_episode, p6.postpass_kernel)))
    shipped_step = environment.step_packed
    launched = {}
    for name, tables, kernels in families:
        t0 = time.perf_counter()
        rows_of_episode = N_ROWS if ENV_STEPS[name] is None else ENV_STEPS[name] + 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")           # the quebec trees are absent
            env = CityLearnEnv(named_dataset(name), episode_time_steps=rows_of_episode,
                               device=dev)
        set_up_s = time.perf_counter() - t0
        cfg, params = env.cfg, env.params
        S = cfg.time_steps - 1
        policy = ScriptedPolicy(tables)
        actions = plan_actions(env, policy.expanded(cfg, params, S))
        # the district step and its packing (one replay of the env's CUDA
        # graph), timed to its end on the card, inside env.step
        in_step = [0.0]

        def timed_step(*args):
            t = time.perf_counter()
            out = shipped_step(*args)
            torch.cuda.synchronize()
            in_step[0] += time.perf_counter() - t
            return out

        environment.step_packed = timed_step
        try:
            env.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in range(S):
                env.step(actions(s))
            episode_s = time.perf_counter() - t0
        finally:
            environment.step_packed = shipped_step
        if not env.terminated:
            raise AssertionError(f"{name}: the env did not end its episode after {S} steps")
        rows = env.evaluate_rows()
        baseline = ("_without_storage_and_partial_load" if cfg.has_dynamics
                    else "_without_storage")
        for kernel in kernels:
            kernel.launches = 0
        table = evaluate_scripted(cfg, params, policy, n_steps=S, baseline_condition=baseline,
                                  device=dev)
        torch.cuda.synchronize()
        counts = {kernel.__name__: kernel.launches for kernel in kernels}
        if not all(counts.values()):
            raise AssertionError(f"{name}: evaluate_scripted launched {counts}")
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n
        comfort = COMFORT_STEPS if cfg.has_dynamics else 0
        worst, worst_comfort = env_rows_error(rows, table, comfort, S)
        rate = S / episode_s
        outside = 1.0 - in_step[0] / episode_s
        results.update({f"env_{name}_steps_per_s": rate, f"env_{name}_ms_per_step":
                        episode_s * 1e3 / S, f"env_{name}_outside_step_share": outside,
                        f"env_{name}_table_error": worst,
                        f"env_{name}_comfort_error": worst_comfort,
                        f"env_{name}_set_up_s": set_up_s})
        print(f"{name}: B={cfg.n_buildings}, {S} env steps in {episode_s:.2f} s = {rate:.1f} "
              f"steps/s ({episode_s * 1e3 / S:.3f} ms a step, {outside:.1%} of it outside "
              f"step_packed); KPI rows vs the kernel table through {counts}: max error "
              f"{worst:.3e} (tolerance {TOL_ENV:g})"
              + (f", discomfort and resilience {worst_comfort:.3e} (tolerance "
                 f"{COMFORT_STEPS} steps in {S})" if comfort else "")
              + f"; set-up {set_up_s:.1f} s; {nvidia_smi()}")
        del env

    # the float64 parity mode: the card against the CPU on the same steps
    envs = [CityLearnEnv(named_dataset("battery"), episode_time_steps=PARITY_STEPS + 1,
                         parity_f64=True, device=d) for d in (dev, "cpu")]
    rng = torch.Generator().manual_seed(SEED)
    obs = [[env.reset()[0]] for env in envs]
    rewards = [[], []]
    for _ in range(PARITY_STEPS):
        acts = [torch.rand(len(b.active_actions), generator=rng, dtype=torch.float64) * 2 - 1
                for b in envs[0].spec.buildings]
        for i, env in enumerate(envs):
            o, r, *_ = env.step([a.numpy() for a in acts])
            obs[i].append(o)
            rewards[i].append(r)
    if not (envs[0].cfg.parity_f64 and envs[0].params.battery.capacity.dtype == torch.float64):
        raise AssertionError("the parity env did not pack at float64")
    errors = {}
    as_tensor = lambda x: torch.tensor(x, dtype=torch.float64)
    pairs = {"observations": [as_tensor([sum(o, []) for o in ob]) for ob in obs],
             "rewards": [as_tensor(r) for r in rewards]}
    pairs.update({f"history {k}": [torch.from_numpy(env._history[k]).double() for env in envs]
                  for k in envs[1]._history})
    for k, (card, cpu) in pairs.items():
        err = float((card - cpu).abs().max()) / max(1.0, float(cpu.abs().max()))
        errors[k] = err
        if not err <= TOL_PARITY:
            raise AssertionError(f"parity mode: the card and the CPU differ on {k} by {err}")
    values = lambda env: torch.tensor([float("nan") if r["value"] is None else r["value"]
                                       for r in env.evaluate_rows()], dtype=torch.float64)
    card_kpis, cpu_kpis = (values(env) for env in envs)
    finite = ~cpu_kpis.isnan()
    kpi_err = float(((card_kpis - cpu_kpis).abs()[finite]
                     / cpu_kpis.abs()[finite].clamp(min=1.0)).max())
    if not (torch.equal(card_kpis.isnan(), cpu_kpis.isnan()) and kpi_err <= TOL_PARITY):
        raise AssertionError(f"parity mode: the card's KPI rows differ from the CPU's by {kpi_err}")
    worst = max(errors, key=errors.get)
    print(f"parity mode, {PARITY_STEPS} battery+PV steps, the card against the CPU: max error "
          f"{errors[worst]:.3e} of scale ({worst}), observations {errors['observations']:.3e}, "
          f"rewards {errors['rewards']:.3e}, KPI rows {kpi_err:.3e} (tolerance {TOL_PARITY:g})")
    results.update(env_parity_max_error=errors[worst], env_parity_kpi_error=kpi_err,
                   env_yardstick_launches=launched, env_s=time.perf_counter() - t_phase)
    print(f"phase 28: yardstick launches {launched}; {results['env_s']:.1f} s; {nvidia_smi()}")


def cli_env_kwargs(**kw) -> str:
    """``--env_kwargs`` of a CLI run: the card is the CLI's own default."""
    if DEVICE != "cuda":
        kw["device"] = DEVICE
    return json.dumps(kw)


def cli_run(out, sid, *argv):
    """``cli.main`` once, in the process; (its summary JSON, its seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["simulate", *argv, "-d", out, "-id", sid])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mode = "train" if "train" in argv else "evaluation"
    with open(os.path.join(out, f"{sid}-{mode}.json")) as f:
        return json.load(f), seconds


def pivot_error(fast, stepped, comfort_steps, steps):
    """Largest error of a fast pivot against the stepped one, relative to
    max(|value|, 1); raises beyond ``TOL_ENV`` (the discomfort and
    resilience KPIs may also move by ``comfort_steps`` steps in ``steps``).
    None must meet None."""
    if set(fast) != set(stepped):
        raise AssertionError(f"fast and stepped pivots differ in KPIs: "
                             f"{sorted(set(fast) ^ set(stepped))}")
    worst = worst_comfort = 0.0
    for kpi, cols in stepped.items():
        comfort = comfort_steps and kpi.startswith(("discomfort", "one_minus_thermal_resilience"))
        tol = TOL_ENV + (comfort_steps / steps if comfort else 0.0)
        for name, w in cols.items():
            v = fast[kpi].get(name, "absent")
            if (v is None) != (w is None) or v == "absent":
                raise AssertionError(f"fast pivot {kpi}/{name} {v} against stepped {w}")
            if w is None:
                continue
            err = abs(v - w) / max(abs(w), 1.0)
            if not err <= tol:
                raise AssertionError(f"fast pivot {kpi}/{name} {v} against stepped {w}: {err}")
            if comfort:
                worst_comfort = max(worst_comfort, err)
            else:
                worst = max(worst, err)
    return worst, worst_comfort


def series_error(fast, stepped, dynamics):
    """Largest error of the fast run's kernel-recorded columns against the
    same columns of the stepped run, relative to each column's scale
    (max(|value|, 1)); the indoor temperature of the dynamics districts
    within K5's tolerance, 2e-4 |T| + 5e-3 C. Raises beyond."""
    worst = 0.0
    for b, cols in fast.items():
        for c, v in cols.items():
            a = torch.tensor(v, dtype=torch.float64)
            r = torch.tensor(stepped[b][c], dtype=torch.float64)
            if a.shape != r.shape:
                raise AssertionError(f"{b}/{c}: fast {tuple(a.shape)} against stepped "
                                     f"{tuple(r.shape)}")
            diff = (a - r).abs()
            if dynamics and c == "indoor_dry_bulb_temperature":
                if not bool((diff <= 2e-4 * r.abs() + 5e-3).all()):
                    raise AssertionError(f"{b}/{c}: fast against stepped {float(diff.max())} C")
                continue
            err = float(diff.max()) / max(1.0, float(r.abs().max()))
            if not err <= TOL_ENV:
                raise AssertionError(f"{b}/{c}: fast against stepped {err}")
            worst = max(worst, err)
    return worst


def cli_path(dev, results):
    """Phase 29: ``simulate`` through ``cli.main`` on the card: each family
    evaluated with and without ``--fast``, SAC trained, saved, reloaded and
    evaluated, and MARLISA."""
    phase("29. the CLI and the host-loop agents on the card")
    t_phase = time.perf_counter()
    for family in CLI_FAMILIES:
        named_dataset(family)
    os.environ["CITYLEARN_DATA_ROOT"] = data_root()
    wrappers = {"battery": (k1.battery_episode,), "thermal": (k3.thermal_episode,),
                "ev": (k4.ev_episode,), "lstm": (k5.lstm_episode,),
                "eulp": (k6.neighborhood_episode, p6.postpass_kernel),
                "quebec": (k6.neighborhood_episode, p6.postpass_kernel)}
    every = sorted({w for ws in wrappers.values() for w in ws}, key=lambda w: w.__name__)
    launched = {w.__name__: 0 for w in every}
    with tempfile.TemporaryDirectory() as out:
        # (a) evaluate with and without --fast
        for family, (agent, steps) in CLI_FAMILIES.items():
            name = DATASET_PREFIX + family
            rows = N_ROWS if steps is None else steps + 1
            args = [name, "evaluate", "-a", agent, "-k", cli_env_kwargs(episode_time_steps=rows)]
            summaries, seconds, counts = {}, {}, {}
            for fast in (True, False):
                for w in every:
                    w.launches = 0
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")           # the quebec trees are absent
                    summaries[fast], seconds[fast] = cli_run(
                        out, f"{family}-{'fast' if fast else 'stepped'}",
                        *args, *(["--fast"] if fast else []))
                counts[fast] = {w.__name__: w.launches for w in every}
            want = {w.__name__: int(w in wrappers[family]) for w in every}
            if counts[True] != want:
                raise AssertionError(f"{family}: --fast launched {counts[True]}, not {want}")
            if any(counts[False].values()):
                raise AssertionError(f"{family}: the stepped run launched {counts[False]}")
            for k, n in counts[True].items():
                launched[k] += n
            dynamics = family in ("lstm", "eulp", "quebec")
            S = rows - 1
            worst, worst_comfort = pivot_error(summaries[True]["kpis"], summaries[False]["kpis"],
                                               COMFORT_STEPS if dynamics else 0, S)
            series = series_error(summaries[True]["time_series"],
                                  summaries[False]["time_series"], dynamics)
            speed_up = seconds[False] / seconds[True]
            results.update({f"cli_{family}_fast_s": seconds[True],
                            f"cli_{family}_stepped_s": seconds[False],
                            f"cli_{family}_speed_up": speed_up,
                            f"cli_{family}_pivot_error": worst,
                            f"cli_{family}_comfort_error": worst_comfort,
                            f"cli_{family}_series_error": series})
            print(f"{family}: {agent.rsplit('.', 1)[1]}, {S} steps; evaluate --fast "
                  f"{seconds[True]:.2f} s (launches {counts[True]}), stepped {seconds[False]:.2f} "
                  f"s: {speed_up:.1f}x; pivot error {worst:.3e}"
                  + (f", discomfort and resilience {worst_comfort:.3e}" if dynamics else "")
                  + f"; kernel-recorded series error {series:.3e} (tolerance {TOL_ENV:g})")

        # (b) SAC: train with updates, save, reload and evaluate
        rows = CLI_SAC_STEPS + 1
        stamps, w0 = [], []
        shipped_update = sac.SAC.update

        def timed_update(agent, *args, **kw):
            if not w0:
                w0.extend(p.detach().clone() for p in agent.nets[0].policy.parameters())
            out_ = shipped_update(agent, *args, **kw)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return out_

        sac.SAC.update = timed_update
        try:
            train, train_s = cli_run(out, "sac", "smoke_battery", "train", "-a",
                                     "citylearn.agents.sac.SAC", "-k",
                                     cli_env_kwargs(episode_time_steps=rows), "-ak",
                                     json.dumps(CLI_SAC), "-rs", str(SEED), "--save_agent")
        finally:
            sac.SAC.update = shipped_update
        with open(os.path.join(out, "sac-agent.pkl"), "rb") as f:
            agent = pickle.load(f)
        first = CLI_SAC["batch_size"] - 1     # the first step whose update trains
        if not (agent.time_step == CLI_SAC_STEPS and all(agent.normalized)
                and len(stamps) == CLI_SAC_STEPS):
            raise AssertionError(f"SAC: {agent.time_step} steps, {len(stamps)} updates timed, "
                                 f"normalized {agent.normalized}")
        weights = list(agent.nets[0].policy.parameters())
        moved = max(float((p.detach() - q).abs().max()) for p, q in zip(weights, w0))
        finite = all(bool(torch.isfinite(p).all()) for n in agent.nets
                     for p in n.policy.parameters())
        if not (finite and moved > 0):
            raise AssertionError(f"SAC: weights finite {finite}, moved by {moved}")
        steps_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
        explore_ms = sum(steps_ms[:first - 1]) / (first - 1)
        update_ms = sum(steps_ms[first - 1:]) / len(steps_ms[first - 1:])
        evaluation, eval_s = cli_run(out, "sac-eval", "smoke_battery", "evaluate", "-fa",
                                     os.path.join(out, "sac-agent.pkl"), "-k",
                                     cli_env_kwargs(episode_time_steps=rows))
        values = [v for cols in evaluation["kpis"].values() for v in cols.values()]
        if not (len(values) > 20 and all(v is None or math.isfinite(v) for v in values)):
            raise AssertionError("SAC: the evaluation table is not finite")
        results.update(cli_sac_train_s=train_s, cli_sac_explore_ms=explore_ms,
                       cli_sac_update_ms=update_ms, cli_sac_evaluate_s=eval_s)
        print(f"SAC: hidden {CLI_SAC['hidden_dimension']}, batch {CLI_SAC['batch_size']}, "
              f"{CLI_SAC['update_per_time_step']} updates a step and agent, {CLI_SAC_STEPS} "
              f"steps in {train_s:.2f} s: {explore_ms:.2f} ms a step before the updates start "
              f"(step {first}), {update_ms:.2f} ms after; policy moved by {moved:.3e}; saved, "
              f"reloaded and evaluated over {CLI_SAC_STEPS} steps in {eval_s:.2f} s, "
              f"cost_total {evaluation['kpis']['cost_total']['District']:.6f}")

        # (c) MARLISA with the numpy PCA and regression
        _, marlisa_s = cli_run(out, "marlisa", "smoke_battery", "train", "-a",
                               "citylearn.agents.marlisa.MARLISA", "-k",
                               cli_env_kwargs(episode_time_steps=CLI_MARLISA_STEPS + 1), "-ak",
                               json.dumps(CLI_MARLISA), "-rs", str(SEED), "--save_agent")
        with open(os.path.join(out, "marlisa-agent.pkl"), "rb") as f:
            agent = pickle.load(f)
        fitted = all(agent.pca_flag) and all(
            math.isfinite(float(abs(e.coef_).max())) for e in agent.state_estimator)
        if not (fitted and agent.time_step == CLI_MARLISA_STEPS):
            raise AssertionError(f"MARLISA: PCA {agent.pca_flag}, {agent.time_step} steps")
        results.update(cli_marlisa_s=marlisa_s,
                       cli_marlisa_ms=marlisa_s * 1e3 / CLI_MARLISA_STEPS)
        print(f"MARLISA: {CLI_MARLISA_STEPS} steps in {marlisa_s:.2f} s "
              f"({marlisa_s * 1e3 / CLI_MARLISA_STEPS:.1f} ms a step), the regression from step "
              f"{CLI_MARLISA['start_regression_time_step']}, the PCA of "
              f"{agent.pca[0].n_components_} components and the first updates at step "
              f"{CLI_MARLISA['start_regression_time_step'] + 1 + CLI_MARLISA['batch_size']}, "
              f"the coordinated policy from step {CLI_MARLISA['end_exploration_time_step'] + 1}")
    results.update(cli_launches=launched, cli_s=time.perf_counter() - t_phase)
    print(f"phase 29: launches {launched}; {results['cli_s']:.1f} s; {nvidia_smi()}")
    return launched


def mesh_plans():
    """Each phase-30 family's hour tables (phases 5, 11, 15, 19 and 24's)."""
    return {"battery": {"electrical_storage": basic_rbc_table()},
            "thermal": thermal_rbc_tables(), "ev": ev_plans(EV_SHAPE[1]),
            "lstm": lstm_plans(), "eulp": neighborhood_plans()}


MESH_KERNELS = {"battery": (k1.battery_episode,), "thermal": (k3.thermal_episode,),
                "ev": (k4.ev_episode,), "lstm": (k5.lstm_episode,),
                "neighborhood": (k6.neighborhood_episode, p6.postpass_kernel)}
MESH_RUN = {"battery": rollout_fast.run_battery_episode,
            "thermal": rollout_fast.run_thermal_episode, "ev": rollout_fast.run_ev_episode,
            "lstm": rollout_fast.run_lstm_episode,
            "neighborhood": rollout_fast.run_neighborhood_episode}


def same_bits(a, b) -> bool:
    """``a`` and ``b`` equal element for element, NaN where the other is NaN."""
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and torch.equal(a[~nan], b[~nan]))


def same_table(a, b) -> bool:
    return set(a) == set(b) and all(same_bits(a[k], b[k]) for k in a)


def mesh_evaluation(mesh, job):
    """Phase 30's sharded ``evaluate_scripted`` on every family: one launch
    of each kernel of the family and no collective on this rank, the table
    and record bit-equal to a single process's over all D districts, and
    this rank's state outputs bit-equal to its rows of the single launch."""
    out = {}
    rows = district_slice(mesh, D)
    for name in MESH_FAMILIES:
        cfg, params, _ = pack(compile_schema(job["schemas"][name]), device=mesh.device)
        family = kernel_family(cfg)
        plans = job["plans"][name]
        policy = ScriptedPolicy(plans)
        kernels = MESH_KERNELS[family]
        for kernel in kernels:
            kernel.launches = 0
        before = mesh.collectives
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table, rec = evaluate_scripted(cfg, params, policy, n_districts=D, mesh=mesh,
                                       return_series=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
        collectives = mesh.collectives - before
        if any(n != 1 for n in launches.values()) or collectives:
            raise AssertionError(f"{name}: sharded evaluate_scripted launched {launches} "
                                 f"and issued {collectives} collectives")
        single, single_rec = evaluate_scripted(cfg, params, policy, n_districts=D,
                                               device=mesh.device, return_series=True)
        if not (same_table(table, single) and torch.equal(rec, single_rec)):
            raise AssertionError(f"{name}: the rank's table differs from the single launch's")
        plan = policy.expanded(cfg, params, cfg.time_steps - 1)
        action = plan["electrical_storage"] if family == "battery" else plan
        share = MESH_RUN[family](cfg, params, D, action, mesh=mesh)
        whole = MESH_RUN[family](cfg, params, D, action, device=mesh.device)
        if not all(a.shape[0] == D // mesh.world_size and torch.equal(a, b[rows])
                   for a, b in zip(share, whole, strict=True)):
            raise AssertionError(f"{name}: the rank's state outputs differ from its rows of "
                                 "the single launch")
        # the counted call above was this process's first of the family;
        # once more, warm, and the single process over all D as warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_scripted(cfg, params, policy, n_districts=D, mesh=mesh)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        evaluate_scripted(cfg, params, policy, n_districts=D, device=mesh.device)
        torch.cuda.synchronize()
        out[name] = dict(ms=ms, warm_ms=warm_ms, single_warm_ms=(time.perf_counter() - t0) * 1e3,
                         launches=launches, collectives=collectives)
    return out


def flat_nets(tr) -> torch.Tensor:
    """Every network weight and Adam moment of a trainer, in one vector."""
    flat = []

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif torch.is_tensor(tree) and tree.is_floating_point():
            # Adam's step counts live on the host
            flat.append(tree.detach().reshape(-1).to(tr.device, torch.float32))
    walk(tr.base_state.nets.state_dict())
    return torch.cat(flat)


def replicas_identical(mesh, tr) -> bool:
    """Every rank holds the same networks and Adam states, bit for bit."""
    mine = flat_nets(tr)
    return all(torch.equal(mine, peer) for peer in all_gather(mesh, mine))


def mesh_training(mesh, job):
    """Phase 30's sharded ``BatchedSAC`` and ``BatchedMARLISA`` on the
    battery+PV district at phase 8's settings."""
    schema = job["schemas"]["battery"]
    rows = district_slice(mesh, D)
    trainer = lambda warmup, **kw: BatchedSAC(
        schema, TrainConfig(warmup_steps=warmup, **TRAIN), random_seed=SEED,
        episode_time_steps=TRAIN_EPISODE, **kw)
    sharded, whole = trainer(K_CHUNK, mesh=mesh), trainer(K_CHUNK, device=mesh.device)
    if not (sharded.use_kernel_collect and whole.use_kernel_collect):
        raise AssertionError("the trainers did not take the kernel collect")
    # 64 warmup steps: this rank's rows of the unsharded trainer's, bit for bit
    for tr in (sharded, whole):
        tr.train(K_CHUNK, chunk=K_CHUNK)
    torch.cuda.synchronize()
    a, b = sharded.state, whole.state
    pairs = [(f, getattr(a.env_state, f), getattr(b.env_state, f)[rows])
             for f in ("t", "data_offset", "battery_soc", "battery_efficiency",
                       "battery_degraded_capacity")]
    pairs += [("cur_obs", a.cur_obs, b.cur_obs[rows])]
    pairs += [(f, getattr(a, f), getattr(b, f)[:, rows])
              for f in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done")]
    for f, x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"warmup: the rank's {f} differs from the unsharded trainer's")
    del whole
    # two chunks with updates: the replicas stay identical, finite, and move
    w0 = sharded.state.nets.policy.mean_w.detach().clone()
    k2.battery_collect_chunk.launches = 0
    chunk_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = sharded.train(K_CHUNK, chunk=K_CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    k2_launches = k2.battery_collect_chunk.launches
    if k2_launches != 2:
        raise AssertionError(f"K2 launched {k2_launches} times in two chunks")
    moved = float((sharded.state.nets.policy.mean_w.detach() - w0).abs().max())
    if not (replicas_identical(mesh, sharded) and torch.isfinite(flat_nets(sharded)).all()
            and moved > 0
            and math.isfinite(hist[0])):
        raise AssertionError("the ranks' networks differ, are not finite or did not move")
    # the chunk's parts: the collect alone, and the batch all_reduce alone
    sharded._update = lambda t, n_slots: None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded.train(K_CHUNK, chunk=K_CHUNK)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) * 1e3
    del sharded._update
    A = sharded.env_cfg.n_buildings
    batch = torch.zeros((TRAIN["batch_size"], A * (2 * sharded.obs_dim + sharded.act_dim + 1)
                         + 1), device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(K_CHUNK):
        all_reduce(mesh, batch)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3
    table = sharded.evaluate(n_steps=MESH_EVALUATE_STEPS)
    check_table(table, (D,), "sharded BatchedSAC.evaluate")
    del sharded
    # MARLISA: the ridge the same on every rank
    marlisa = BatchedMARLISA(schema, TrainConfig(warmup_steps=FAMILY_WARMUP, **TRAIN),
                             random_seed=SEED, regression_update_every=MARLISA_EVERY,
                             episode_time_steps=TRAIN_EPISODE, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marlisa.train(MESH_MARLISA_STEPS, chunk=MESH_MARLISA_STEPS)
    torch.cuda.synchronize()
    marlisa_ms = (time.perf_counter() - t0) * 1e3 / MESH_MARLISA_STEPS
    reg_w = marlisa.state.reg_w
    if not (float(reg_w.abs().max()) > 0
            and all(torch.equal(reg_w, peer) for peer in all_gather(mesh, reg_w))
            and replicas_identical(mesh, marlisa)):
        raise AssertionError("MARLISA: the ranks' ridge weights or networks differ")
    return dict(chunk_ms=chunk_ms, collect_ms=collect_ms,
                updates_ms=sum(chunk_ms) / 2 - collect_ms, reduce_ms=reduce_ms,
                batch_bytes=batch.numel() * 4, moved=moved, k2_launches=k2_launches,
                marlisa_ms=marlisa_ms)


def mesh_nccl(mesh, job):
    """Phase 30(b): one rank under NCCL, whose collectives run for real,
    gives what the run without a mesh gives, bit for bit: battery+PV
    ``evaluate_scripted`` and one 64-step ``BatchedSAC`` chunk with updates."""
    schema = job["schemas"]["battery"]
    cfg, params, _ = pack(compile_schema(schema), device=mesh.device)
    policy = ScriptedPolicy(job["plans"]["battery"])
    k1.battery_episode.launches = 0
    table = evaluate_scripted(cfg, params, policy, n_districts=D, mesh=mesh)
    k1_launches = k1.battery_episode.launches
    if not same_table(table, evaluate_scripted(cfg, params, policy, n_districts=D,
                                               device=mesh.device)):
        raise AssertionError("NCCL: the table differs from the run without a mesh")
    trainer = lambda **kw: BatchedSAC(
        schema, TrainConfig(warmup_steps=FAMILY_WARMUP, **TRAIN), random_seed=SEED,
        episode_time_steps=TRAIN_EPISODE, **kw)
    sharded, whole = trainer(mesh=mesh), trainer(device=mesh.device)
    before = mesh.collectives
    k2.battery_collect_chunk.launches = 0
    sharded.train(K_CHUNK, chunk=K_CHUNK)
    k2_launches = k2.battery_collect_chunk.launches
    collectives = mesh.collectives - before
    whole.train(K_CHUNK, chunk=K_CHUNK)
    a, b = sharded.state, whole.state
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in a.BUFFERS) and \
        torch.equal(a.env_state.battery_soc, b.env_state.battery_soc) and \
        torch.equal(flat_nets(sharded), flat_nets(whole))
    if not same:
        raise AssertionError("NCCL: the chunk differs from the run without a mesh")
    return dict(k1_launches=k1_launches, k2_launches=k2_launches, collectives=collectives)


def mesh_context(mesh, job):
    """Phase 30(c): every kernel of the mesh's path launched on this rank's
    card while another card is the current CUDA device. Each wrapper
    launches under its tensors' device, so each launch counts once and
    gives what it gives with the rank's own card current, bit for bit."""
    other = (mesh.device.index + 1) % torch.cuda.device_count()
    launches = {}
    for name in MESH_FAMILIES:
        cfg, params, _ = pack(compile_schema(job["schemas"][name]), device=mesh.device)
        policy = ScriptedPolicy(job["plans"][name])
        kernels = MESH_KERNELS[kernel_family(cfg)]
        mine = evaluate_scripted(cfg, params, policy, n_districts=D, mesh=mesh)
        for kernel in kernels:
            kernel.launches = 0
        with torch.cuda.device(other):
            theirs = evaluate_scripted(cfg, params, policy, n_districts=D, mesh=mesh)
        torch.cuda.synchronize(mesh.device)
        launches.update({kernel.__name__: kernel.launches for kernel in kernels})
        if not same_table(mine, theirs) or any(kernel.launches != 1 for kernel in kernels):
            raise AssertionError(f"{name}: with cuda:{other} current the table differs or the "
                                 "kernels did not launch once each")
    # K2 on the inputs that a sharded trainer hands it in one chunk
    handed = {}
    shipped = train_module.battery_collect_chunk

    def keep(*args, **kw):
        handed.update(args=[a.clone() if torch.is_tensor(a) else a for a in args], kw=kw)
        return shipped(*args, **kw)

    trainer = BatchedSAC(job["schemas"]["battery"], TrainConfig(warmup_steps=K_CHUNK, **TRAIN),
                         random_seed=SEED, episode_time_steps=TRAIN_EPISODE, mesh=mesh)
    train_module.battery_collect_chunk = keep
    try:
        trainer.train(K_CHUNK, chunk=K_CHUNK)
    finally:
        train_module.battery_collect_chunk = shipped
    mine = k2.battery_collect_chunk(*handed["args"], **handed["kw"])
    k2.battery_collect_chunk.launches = 0
    with torch.cuda.device(other):
        theirs = k2.battery_collect_chunk(*handed["args"], **handed["kw"])
    torch.cuda.synchronize(mesh.device)
    launches["battery_collect_chunk"] = k2.battery_collect_chunk.launches
    if not (launches["battery_collect_chunk"] == 1
            and all(torch.equal(a, b) for a, b in zip(mine, theirs, strict=True))):
        raise AssertionError(f"K2: with cuda:{other} current the outputs differ")
    return dict(other=other, launches=launches)


def mesh_rank(rank, world, port, job, out_dir):
    """One rank of phase 30, in a process of its own, started with the
    variables that ``torchrun`` sets and joined through
    ``initialize_distributed`` from them."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    initialize_distributed(backend=job["backend"])
    if world == 1:
        # a world of one joins no group, as the JAX package's does not; (b)
        # joins one itself, so that its collectives run through NCCL
        if torch.distributed.is_initialized():
            raise AssertionError("initialize_distributed joined a group at a world of one")
        torch.distributed.init_process_group("nccl", init_method="env://", world_size=1, rank=0)
    try:
        mesh = district_mesh(device=job["device"])
        backend = torch.distributed.get_backend(mesh.group)
        if backend != (job["backend"] or "nccl"):
            raise AssertionError(f"rank {rank} joined a {backend} group")
        if job["part"] == "a":
            out = dict(evaluation=mesh_evaluation(mesh, job), training=mesh_training(mesh, job))
        elif job["part"] == "b":
            out = mesh_nccl(mesh, job)
        else:
            if mesh.device != torch.device("cuda", rank):
                raise AssertionError(f"rank {rank}'s mesh is on {mesh.device}")
            out = dict(evaluation=mesh_evaluation(mesh, job), context=mesh_context(mesh, job),
                       training=mesh_training(mesh, job))
        with open(os.path.join(out_dir, f"{job['part']}-rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_mesh(world, job, out_dir):
    """Run ``mesh_rank`` on ``world`` processes; raises if any rank fails
    (the others are stopped). Returns each rank's numbers."""
    torch.multiprocessing.spawn(mesh_rank, args=(world, free_port(), job, out_dir),
                                nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{job['part']}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_job():
    return dict(schemas={name: named_dataset(name) for name in MESH_FAMILIES},
                plans=mesh_plans())


def print_mesh_evaluation(ranks, launched, results, key):
    for name in MESH_FAMILIES:
        per_rank = [r["evaluation"][name] for r in ranks]
        for r in per_rank:
            for k, n in r["launches"].items():
                launched[k] = launched.get(k, 0) + n
        ms = " / ".join(f"{r['ms']:.1f}" for r in per_rank)
        warm = " / ".join(f"{r['warm_ms']:.1f}" for r in per_rank)
        single = " / ".join(f"{r['single_warm_ms']:.1f}" for r in per_rank)
        print(f"  {name}: evaluate_scripted over the year, launches per rank "
              f"{per_rank[0]['launches']}, collectives {per_rank[0]['collectives']}; table, "
              f"record and state share bit-equal to the single launch's; {ms} ms, warm {warm} "
              f"ms; one process over all D, warm: {single} ms (ranks in order)")
        results[f"{key}_{name}_evaluate_ms"] = [r["ms"] for r in per_rank]
        results[f"{key}_{name}_evaluate_warm_ms"] = [r["warm_ms"] for r in per_rank]
        results[f"{key}_{name}_single_warm_ms"] = [r["single_warm_ms"] for r in per_rank]


def print_mesh_training(tr, launched):
    launched["battery_collect_chunk"] = (launched.get("battery_collect_chunk", 0)
                                         + sum(t["k2_launches"] for t in tr))
    chunk_ms = " / ".join(f"{c:.1f}" for c in tr[0]["chunk_ms"])
    print(f"  BatchedSAC at D={D}: {K_CHUNK} warmup steps bit-equal to the unsharded trainer's "
          f"rows; two {K_CHUNK}-step chunks with updates, K2 launched {tr[0]['k2_launches']} "
          f"times per rank, replicas bit-identical, policy moved by {tr[0]['moved']:.3e}; ms per "
          f"chunk {chunk_ms} (rank 0): collect "
          f"{tr[0]['collect_ms']:.1f}, {K_CHUNK} updates {tr[0]['updates_ms']:.1f}, of which "
          f"{K_CHUNK} batch all_reduces of {tr[0]['batch_bytes']} bytes {tr[0]['reduce_ms']:.1f} "
          f"(alone); MARLISA {tr[0]['marlisa_ms']:.1f} ms a step, ridge identical on every rank")


def mesh_path(dev, results):
    """Phase 30: the district mesh on the one card. Returns the main path's
    launches of each kernel, summed over the ranks."""
    phase("30. the district mesh: two gloo ranks sharing the card, then one NCCL rank")
    t_phase = time.perf_counter()
    job = mesh_job()
    with tempfile.TemporaryDirectory() as out:
        # NCCL refuses two ranks on one card; gloo exchanges CUDA tensors
        # through the host, so two gloo ranks can share it
        ranks = spawn_mesh(2, dict(job, part="a", backend="gloo", device="cuda:0"), out)
        nccl = spawn_mesh(1, dict(job, part="b", backend=None, device=None), out)[0]
    smi = nvidia_smi()
    absent = f"cuda:{torch.cuda.device_count()}"
    try:
        district_mesh(device=absent)
    except RuntimeError as e:
        print(f"a mesh on {absent} raises: {e}")
    else:
        raise AssertionError(f"a mesh on the absent {absent} did not raise")
    launched = {}
    print(f"(a) two gloo ranks on {smi}, each with {D // 2} of D={D} districts; times are "
          "of two ranks sharing one card, not of two cards:")
    print_mesh_evaluation(ranks, launched, results, "mesh")
    tr = [r["training"] for r in ranks]
    print_mesh_training(tr, launched)
    print(f"(b) one NCCL rank: battery+PV evaluate_scripted ({nccl['k1_launches']} K1 launch) "
          f"and one {K_CHUNK}-step BatchedSAC chunk ({nccl['k2_launches']} K2 launch, "
          f"{nccl['collectives']} NCCL collectives) bit-equal to the run without a mesh")
    launched["battery_episode"] += nccl["k1_launches"]
    launched["battery_collect_chunk"] += nccl["k2_launches"]
    results.update(mesh_training=tr, mesh_nccl=nccl, mesh_launches=launched,
                   mesh_s=time.perf_counter() - t_phase)
    print(f"phase 30: launches {launched}; {results['mesh_s']:.1f} s; {smi}")
    return launched


GEN_SAMPLES = 3               # the README's build: sample_count=3, partial_loads_simulations=2
GEN_PARTIAL = 2
GEN_EPOCHS = 4                # LSTM_CONFIG's 144 epochs cut to what phase 31's budget holds
AUTOSIZE_DEVICES = ("electrical_storage", "pv", "cooling_device", "heating_device",
                    "dhw_device", "cooling_storage", "heating_storage", "dhw_storage")


def autosized(schema_path, devices, epw_seed=SEED):
    """Set ``autosize`` on ``devices`` of every building that has them,
    point PV at a seeded ``weather.epw`` beside the schema, rewrite it."""
    root = os.path.dirname(schema_path)
    write_epw(os.path.join(root, "weather.epw"), seed=epw_seed)
    with open(schema_path) as f:
        schema = json.load(f)
    for b in schema["buildings"].values():
        for key in devices:
            if b.get(key) is not None:
                b[key]["autosize"] = True
        if "pv" in devices and b.get("pv") is not None:
            b["pv"]["autosize_attributes"] = {"epw_filepath": "weather.epw"}
    with open(schema_path, "w") as f:
        json.dump(schema, f, indent=2)
    return schema_path


def stepped_temperature(cfg, params, policy, n_steps, dev):
    """District 0's predicted indoor temperature over ``n_steps`` of the
    stepped ``district_step`` under ``policy``: (n_steps, B)."""
    fn = policy.as_policy_fn(cfg, params, n_steps)
    states = batched_initial_states(cfg, params, 1, device=dev)
    temps = []
    for _ in range(n_steps):
        states, out = district_step(cfg, params, states, fn(params, states))
        temps.append(out.indoor_temperature[0])
    return torch.stack(temps)


def trace_names_kernel(trace_path, annotation, kernel_names):
    """Whether the Chrome trace at ``trace_path`` holds CUDA kernel events
    of every name in ``kernel_names``, each inside the card's side of the
    ``annotation`` range. Returns (ok, what was found)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in kernel_names)]
    marks = [e for e in events if e.get("name") == annotation
             and e.get("cat") == "gpu_user_annotation"]
    inside = lambda e: any(m["ts"] <= e["ts"] and e["ts"] + e["dur"] <= m["ts"] + m["dur"]
                           for m in marks)
    found = {k: sum(k in e["name"] and inside(e) for e in kernels) for k in kernel_names}
    return all(found.values()), dict(kernels=found, annotations=len(marks))


def profiled_year(rank, device, out_path):
    """Phase 31(c) in a fresh process (``torch.multiprocessing`` spawn): the
    battery+PV year through ``evaluate_scripted`` at D inside
    ``utilities.Profiler``, its trace checked by ``trace_names_kernel``.
    A process that has run for minutes loses the first kernel events of
    its traces, more the longer it has run, so the check runs where the
    profiler starts as a user's script does. Writes the result to
    ``out_path``."""
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_battery_pv_dataset(tmp, N_BUILDINGS, N_ROWS, SEED)
        cfg, params, _ = pack(compile_schema(schema), device=dev)
        policy = ScriptedPolicy({"electrical_storage": basic_rbc_table()})
        k1.battery_episode.launches = 0
        with Profiler(tmp) as prof:
            evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
        if not os.path.isfile(prof.trace_path):
            raise AssertionError("the profiler wrote no trace")
        ok, found = trace_names_kernel(prof.trace_path, "battery_episode",
                                       ("prelude_kernel", "district_kernel"))
        result = dict(ok=ok, found=found, launches=k1.battery_episode.launches,
                      trace_mb=os.path.getsize(prof.trace_path) / 2 ** 20)
    with open(out_path, "w") as f:
        json.dump(result, f)


def tools_path(dev, results):
    """Phase 31: autosized districts, the debug physics checks, the
    profiler and dataset generation. Returns the main path's launches of
    each kernel."""
    phase("31. autosize, debug checks, profiler, dataset generation")
    t_phase = time.perf_counter()
    launched = {}
    count = lambda kernels: {k.__name__: k.launches for k in kernels}

    # (a) autosized thermal and battery+PV districts through K3 and K1
    with tempfile.TemporaryDirectory() as tmp:
        misc = os.path.join(tmp, "misc")
        write_battery_choices(misc, seed=SEED)
        thermal_dir, battery_dir = os.path.join(tmp, "thermal"), os.path.join(tmp, "battery")
        thermal_schema = autosized(write_thermal_dataset(thermal_dir, THERMAL_BUILDINGS, N_ROWS,
                                                         SEED), AUTOSIZE_DEVICES)
        battery_schema = autosized(write_battery_pv_dataset(battery_dir, N_BUILDINGS, N_ROWS,
                                                            SEED), ("electrical_storage", "pv"))
        shipped_misc = os.environ.get("CITYLEARN_MISC_ROOT")
        os.environ["CITYLEARN_MISC_ROOT"] = misc
        try:
            t0 = time.perf_counter()
            specs = {"thermal": compile_schema(thermal_schema),
                     "battery": compile_schema(battery_schema)}
            compile_s = time.perf_counter() - t0
        finally:
            if shipped_misc is None:
                del os.environ["CITYLEARN_MISC_ROOT"]
            else:
                os.environ["CITYLEARN_MISC_ROOT"] = shipped_misc
    print(f"(a) autosized districts compiled in {compile_s:.2f} s")
    for name, spec in specs.items():
        for b in spec.buildings:
            sizes = {"cooling_device": b.cooling_device.nominal_power,
                     "dhw_device": b.dhw_device.nominal_power,
                     "cooling_storage": b.cooling_storage.capacity,
                     "dhw_storage": b.dhw_storage.capacity,
                     "battery": (b.battery.capacity, b.battery.nominal_power),
                     "pv": b.pv_nominal_power}
            if name == "battery":
                sizes = {k: sizes[k] for k in ("battery", "pv")}
            print(f"  {name} {b.name}: " + ", ".join(
                f"{k} {v if isinstance(v, tuple) else round(v, 4)}" for k, v in sizes.items()))
            solar = torch.from_numpy(b.series["solar_generation"])
            if not b.pv_nominal_power > 0 or not torch.isfinite(solar).all():
                raise AssertionError(f"{name} {b.name}: PV autosize gave no array")
        if name == "thermal" and not all(b.cooling_storage.capacity_npf32
                                         for b in spec.buildings):
            raise AssertionError("a cooling tank was not autosized")
    autosize = {}
    for name, spec, kernel, tables, eligible_fn in (
            ("thermal", specs["thermal"], k3.thermal_episode, thermal_rbc_tables(),
             eligible_thermal),
            ("battery", specs["battery"], k1.battery_episode,
             {"electrical_storage": basic_rbc_table()}, eligible)):
        cfg, params, _ = pack(spec, device=dev)
        if not eligible_fn(cfg):
            raise AssertionError(f"the autosized {name} district is not kernel-eligible")
        policy = ScriptedPolicy(tables)
        kernel.launches = 0
        t0 = time.perf_counter()
        table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
        torch.cuda.synchronize()
        year_s = time.perf_counter() - t0
        check_table(table, (), f"autosized {name} evaluate_scripted", cfg.n_buildings)
        if kernel.launches != 1:
            raise AssertionError(f"autosized {name}: evaluate_scripted launched "
                                 f"{kernel.__name__} {kernel.launches} times")
        launched[kernel.__name__] = launched.get(kernel.__name__, 0) + kernel.launches
        states = batched_initial_states(cfg, params, D, device=dev)
        fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
        stepped = evaluate_districts(cfg, params, states,
                                     policy.as_policy_fn(cfg, params, SHORT_STEPS),
                                     n_steps=SHORT_STEPS, device=dev)
        worst = table_error(fast, stepped)
        autosize[name] = dict(year_s=year_s, table_error=worst,
                              cost_total=float(table["district|cost_total"]))
        print(f"  {name}: full-year evaluate_scripted at D={D} through {kernel.__name__} "
              f"(1 launch) in {year_s:.3f} s, cost_total {autosize[name]['cost_total']:.6f}; "
              f"kernel vs stepped KPI table at S={SHORT_STEPS}: max error {worst:.3e} "
              f"(tolerance {TOL_TABLE:g})")
        if name == "battery":
            battery_cfg, battery_params, battery_policy = cfg, params, policy

    # (b) the debug physics checks on 168 stepped battery+PV steps at D
    cfg, params, policy = battery_cfg, battery_params, battery_policy
    states = batched_initial_states(cfg, params, D, device=dev)
    stepped = lambda: evaluate_districts(cfg, params, states,
                                         policy.as_policy_fn(cfg, params, SHORT_STEPS),
                                         n_steps=SHORT_STEPS, device=dev)
    off_ms = time_cuda(stepped, 2) / SHORT_STEPS
    debug.enable_checks(True)
    try:
        checked = stepped()
        on_ms = time_cuda(stepped, 2) / SHORT_STEPS
        bad = dataclasses.replace(states, battery_soc=torch.full_like(states.battery_soc, 2.5))
        try:
            district_step(cfg, params, bad, policy.as_policy_fn(cfg, params, 1)(params, bad))
        except debug.PhysicsCheckError as e:
            message = str(e)
        else:
            raise AssertionError("a corrupted battery SOC passed the physics checks")
    finally:
        debug.enable_checks(False)
    check_table(checked, (D,), "evaluate_districts with the physics checks")
    if not message.startswith("physics invariant violated: soc_prev_in_[0,1]"):
        raise AssertionError(f"the corrupted state raised {message!r}")
    print(f"(b) {SHORT_STEPS} stepped battery+PV steps at D={D} with the physics checks on: "
          f"passed; {off_ms:.3f} ms a step with the checks off, {on_ms:.3f} ms on "
          f"({on_ms / off_ms:.2f}x); a battery SOC of 2.5 raised {message!r}")

    # (c) the profiler around one full-year K1 evaluation, in a fresh process
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "profiled.json")
        torch.multiprocessing.spawn(profiled_year, args=(DEVICE, out), nprocs=1, join=True)
        with open(out) as f:
            profiled = json.load(f)
    if not profiled["ok"]:
        raise AssertionError(f"the trace does not name battery_episode's kernels: {profiled}")
    launched["battery_episode"] += profiled["launches"]
    print(f"(c) Profiler trace of a full-year evaluate_scripted ({profiled['trace_mb']:.2f} MiB, "
          f"a fresh process): K1's kernels inside the card's battery_episode annotation: "
          f"{profiled['found']}")

    # (d) dataset generation at LSTM_CONFIG's width, trained on the card
    fits = []
    shipped_fit = gen_lstm.fit_lstm

    def timed_fit(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = shipped_fit(*args, **kw)
        torch.cuda.synchronize()
        fits.append((time.perf_counter() - t0, losses))
        return state, losses

    gen_root = tempfile.TemporaryDirectory()
    gen_lstm.fit_lstm = timed_fit
    try:
        t0 = time.perf_counter()
        built = Neighborhood().build(gen_root.name, sample_count=GEN_SAMPLES,
                                     n_time_steps=N_ROWS,
                                     partial_loads_simulations=GEN_PARTIAL,
                                     lstm_kwargs=dict(epochs=GEN_EPOCHS), random_seed=SEED,
                                     device=dev)
        build_s = time.perf_counter() - t0
    finally:
        gen_lstm.fit_lstm = shipped_fit
    steps = sum(len(losses) for _, losses in fits)
    train_s = sum(t for t, _ in fits)
    per_epoch = len(fits[0][1]) // GEN_EPOCHS
    for _, losses in fits:
        if losses.device.type != dev.type or not torch.isfinite(losses).all():
            raise AssertionError(f"the LSTM did not train on {dev} to finite losses")
        if not float(losses[-per_epoch:].mean()) < float(losses[:per_epoch].mean()):
            raise AssertionError(f"the LSTM loss did not fall: {losses.tolist()}")
    rows = built.citylearn_simulation_test_evaluation
    defined = [r["value"] for r in rows if r["value"] is not None and not math.isnan(r["value"])]
    if not defined or not all(map(math.isfinite, defined)):
        raise AssertionError("the generated dataset's smoke run gave no finite KPI rows")
    adam_ms = train_s / steps * 1e3
    print(f"(d) Neighborhood().build: {GEN_SAMPLES} buildings {built.bldg_ids} (cluster labels "
          f"{built.sample_cluster_labels}) x {N_ROWS} steps, {GEN_PARTIAL} partial-load "
          f"simulations each, LSTM hidden {gen_build.LSTM_CONFIG['hidden']} x "
          f"{gen_build.LSTM_CONFIG['num_layers']} layers, lookback "
          f"{gen_build.LSTM_CONFIG['lookback']}, batch {gen_build.LSTM_CONFIG['batch_size']}, "
          f"lr {gen_build.LSTM_CONFIG['lr']}, {len(gen_build.LSTM_CHANNELS)} channels, "
          f"{GEN_EPOCHS} of {gen_build.LSTM_CONFIG['epochs']} epochs: {build_s:.2f} s in all "
          f"({build_s / GEN_SAMPLES:.2f} s a building), of which LSTM training "
          f"{train_s:.2f} s over {steps} Adam steps = {adam_ms:.3f} ms a step; loss "
          f"{float(fits[0][1][:per_epoch].mean()):.5f} -> "
          f"{float(fits[0][1][-per_epoch:].mean()):.5f} (building 1, first and last epoch); "
          f"smoke run {len(rows)} KPI rows")
    # the generated dataset as built (the default reward: the neighborhood
    # kernels serve it, in the JAX package's dispatch too) and with the
    # ComfortReward of the LSTM family (K5)
    with open(built.schema_filepath) as f:
        schema = json.load(f)
    comfort = dict(schema, reward_function={
        "type": "citylearn.reward_function.ComfortReward", "attributes": None})
    plans = {k: v for k, v in lstm_plans().items() if k in ("cooling_device",
                                                             "electrical_storage")}
    generated = {}
    for name, sch, kernels in (
            ("as built", schema, (k6.neighborhood_episode, p6.postpass_kernel)),
            ("ComfortReward", comfort, (k5.lstm_episode,))):
        cfg, params, _ = pack(compile_schema(sch), device=dev)
        policy = ScriptedPolicy(plans)
        for kernel in kernels:
            kernel.launches = 0
        table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
        torch.cuda.synchronize()
        counts = count(kernels)
        if set(counts.values()) != {1}:
            raise AssertionError(f"generated ({name}): evaluate_scripted launched {counts}")
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n
        check_table(table, (), f"generated ({name}) evaluate_scripted", cfg.n_buildings)
        states = batched_initial_states(cfg, params, D, device=dev)
        fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
        stepped = evaluate_districts(cfg, params, states,
                                     policy.as_policy_fn(cfg, params, SHORT_STEPS),
                                     n_steps=SHORT_STEPS, device=dev)
        worst, worst_comfort = table_error(fast, stepped, COMFORT_STEPS)
        generated[name] = dict(launches=counts, table_error=worst, comfort_error=worst_comfort)
        line = (f"  generated, {name}: full-year evaluate_scripted at D={D} through {counts}; "
                f"kernel vs stepped KPI table at S={SHORT_STEPS}: max error {worst:.3e} "
                f"(tolerance {TOL_TABLE:g}), discomfort and resilience {worst_comfort:.3e} "
                f"(tolerance {COMFORT_STEPS} steps in {SHORT_STEPS})")
        if name == "ComfortReward":
            lookback, layers, hidden, channels = cfg.dyn_groups[0][:4]
            rec = rollout_fast.run_lstm_episode(cfg, params, 1, plans, n_steps=SHORT_STEPS,
                                                record_series=True, device=dev)[-1]
            ours, ref = rec[k5.R_TEMP], stepped_temperature(cfg, params, policy,
                                                            SHORT_STEPS, dev)
            temp = float((ours - ref).abs().max())
            if not ((ours - ref).abs() <= TEMP_RTOL * ref.abs() + TEMP_ATOL).all():
                raise AssertionError(f"generated: K5's temperature is off the stepped path's "
                                     f"by {temp}")
            generated[name]["temperature_error"] = temp
            line += (f"; K5 (H={hidden}, {layers} layers, lookback {lookback}, {channels} "
                     f"channels) temperature vs the stepped path's over {SHORT_STEPS} steps: "
                     f"max|diff| {temp:.3e} C (tolerance {TEMP_RTOL:g} |T| + {TEMP_ATOL:g})")
        print(line)
    gen_root.cleanup()
    results.update(tools_autosize=autosize, tools_autosize_compile_s=compile_s,
                   tools_check_off_ms_per_step=off_ms,
                   tools_check_on_ms_per_step=on_ms, tools_trace=profiled,
                   tools_build_s=build_s, tools_build_s_per_building=build_s / GEN_SAMPLES,
                   tools_train_s=train_s, tools_adam_steps=steps, tools_adam_ms=adam_ms,
                   tools_generated=generated, tools_launches=launched,
                   tools_s=time.perf_counter() - t_phase)
    print(f"phase 31: launches {launched}; {results['tools_s']:.1f} s; {nvidia_smi()}")
    return launched


def cards_main(n_cards, json_path=None):
    """Phase 30(c) alone: ``n_cards`` NCCL ranks, one on each card, each
    joined through ``initialize_distributed()``'s defaults (torchrun's
    variables, ``env://``, nccl) and placed by ``district_mesh()``'s
    (``cuda:$LOCAL_RANK``)."""
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < n_cards:
        print(f"chip_smoke.py: --cards {n_cards} on {torch.cuda.device_count()} card(s)",
              file=sys.stderr)
        return 1
    phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(f"devices: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:\n{smi}")
    phase("2. build kernels")
    t0 = time.perf_counter()
    print(f"built {sorted(_build.build()) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    phase(f"30(c). the district mesh: {n_cards} NCCL ranks, one on each card")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ranks = spawn_mesh(n_cards, dict(mesh_job(), part="c", backend=None, device=None), out)
    results, launched = {}, {}
    print(f"{n_cards} NCCL ranks, rank r on cuda:r, each with {D // n_cards} of D={D} "
          "districts; each rank's single process runs on its own card:")
    print_mesh_evaluation(ranks, launched, results, "cards")
    for r, c in enumerate(ranks):
        print(f"  rank {r} with cuda:{c['context']['other']} current: every kernel launched "
              f"once on cuda:{r}, {c['context']['launches']}, bit-equal to its own card current")
    tr = [r["training"] for r in ranks]
    print_mesh_training(tr, launched)
    results.update(cards=n_cards, cards_training=tr, cards_launches=launched,
                   cards_context=[c["context"] for c in ranks],
                   cards_s=time.perf_counter() - t_phase)
    print(f"phase 30(c): launches {launched}; {results['cards_s']:.1f} s")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(dict(results, nvidia_smi=smi, device=device), f, indent=1)
    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main(json_path=None):
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    results = {}

    phase("1. device")
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    phase("2. build kernels")
    t0 = time.perf_counter()
    logs = _build.build()
    results["build_s"] = time.perf_counter() - t0
    results["ptxas"] = {name: [line.strip() for line in log.splitlines()
                               if "registers" in line or "spill" in line
                               or "entry function" in line]
                        for name, log in logs.items()}
    for name, lines in results["ptxas"].items():
        for line in lines:
            print(f"{name}: {line}")
    print(f"built {sorted(logs) or 'nothing (cached)'} in {results['build_s']:.2f} s")

    phase("3. dataset, compile, pack")
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_battery_pv_dataset(tmp, N_BUILDINGS, N_ROWS, SEED)
        spec = compile_schema(schema)
        cfg, params, _ = pack(spec, device=dev)
    if not eligible(cfg):
        raise AssertionError("the synthetic district is not kernel-eligible")
    S = cfg.time_steps - 1
    print(f"{cfg.n_buildings} buildings, {cfg.time_steps} rows, S={S} steps, "
          f"reward {cfg.reward_type}, central_agent={cfg.central_agent}")
    rbc = basic_rbc_table()

    phase(f"4. kernel vs plain at D={D}, S={S}")
    inputs = battery_episode_inputs(cfg, params, D, rbc)
    seeded = with_seeded_states(inputs, torch.Generator(device=dev).manual_seed(SEED))
    ours = k1.battery_episode(**seeded, record=True)
    ref, plain_ms = timed_once(lambda: k1.battery_episode_reference(**seeded, record=True))
    max_abs = check_bit_equal("K1", OUTPUTS, ours, ref)
    print(f"6 outputs and {k1.N_REC} rows bit-equal from per-district seeded states")
    results["max_abs_err"] = max_abs

    phase("5. main path")
    policy = ScriptedPolicy({"electrical_storage": rbc})
    k1.battery_episode.launches = 0
    t0 = time.perf_counter()
    table = evaluate_scripted(cfg, params, policy, n_districts=D, device=dev)
    torch.cuda.synchronize()
    results["evaluate_scripted_s"] = time.perf_counter() - t0
    check_table(table, (), "evaluate_scripted")
    states = batched_initial_states(cfg, params, D, device=dev)
    served = evaluate_districts(cfg, params, states, policy, device=dev)
    check_table(served, (D,), "evaluate_districts")
    for k, v in served.items():
        if not torch.equal(v[0].nan_to_num(), table[k].nan_to_num()):
            raise AssertionError(f"evaluate_districts dispatch differs on {k}")
    fast = evaluate_districts(cfg, params, states, policy, n_steps=SHORT_STEPS, device=dev)
    t0 = time.perf_counter()
    stepped = evaluate_districts(cfg, params, states,
                                 policy.as_policy_fn(cfg, params, SHORT_STEPS),
                                 n_steps=SHORT_STEPS, device=dev)
    torch.cuda.synchronize()
    results["stepped_168_s"] = time.perf_counter() - t0
    launches = k1.battery_episode.launches
    print(f"K1 launches on the main path: {launches}")
    if launches == 0:
        raise AssertionError("the main path never launched K1")
    worst = table_error(fast, stepped)
    print(f"kernel vs stepped KPI table at S={SHORT_STEPS}, D={D}: max error {worst:.3e} "
          f"(tolerance {TOL_TABLE:g})")
    print("full-year district KPIs:")
    for k, v in table.items():
        if k.startswith("district|"):
            print(f"  {k[9:]:48s} {float(v):.6f}")
    results.update(launches=launches, table_error=worst,
                   district_kpis={k: float(v) for k, v in table.items() if k.startswith("district|")})

    phase("6. times")
    kernel_ms = time_cuda(lambda: k1.battery_episode(**seeded, record=True), 20)
    main_ms = time_cuda(lambda: k1.battery_episode(**inputs, record=True), 20)
    # end to end after warm-up: the full-year kernel-backed table (one K1
    # launch at D=4096 plus the KPI assembly) and the stepped 168-step table
    eval_ms = time_cuda(lambda: evaluate_scripted(cfg, params, policy, n_districts=D,
                                                  device=dev), 5)
    stepped_ms = time_cuda(lambda: evaluate_districts(
        cfg, params, states, policy.as_policy_fn(cfg, params, SHORT_STEPS),
        n_steps=SHORT_STEPS, device=dev), 2)
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; "
          f"stepped evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms")
    results.update(evaluate_scripted_ms=eval_ms, stepped_168_ms=stepped_ms)
    B = N_BUILDINGS
    n_knots = inputs["curves"][0].shape[0]
    n_bytes = 4 * (5 * S * B + 8 * B + 4 * n_knots * B + 3 * D * B + 6 * D * B + 3 * S * B)
    n_ops = k1.operation_count(inputs["actions"], n_knots, D, request_once=True)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the count with the energy request in every district
    per_district_bound_ms = max(bytes_ms, k1.operation_count(inputs["actions"], n_knots, D)
                                / PEAK_FP32 * 1e3)
    cycles, chain = chain_cycles("battery_episode")
    chain_ms, clock_mhz = chain_floor_ms(cycles, S)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K1 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{main_ms:.4f} ms on the main path's inputs); plain {plain_ms:.2f} ms; bound "
          f"{bound_ms:.4f} ms ({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> "
          f"{bytes_ms:.5f} ms), share of bound {bound_ms / kernel_ms:.2%}; by the count with "
          f"the request in every district {per_district_bound_ms:.4f} ms; chain floor "
          f"{chain_ms:.4f} ms ({S} steps x {cycles:g} cycles at {clock_mhz:.0f} MHz, read from this "
          f"build's SASS along {chain}), "
          f"{kernel_ms / chain_ms:.2f}x of it; build: {ptxas_report(results, 'battery_episode')}; "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    results.update(kernel_ms=kernel_ms, main_inputs_ms=main_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_ops=n_ops, bound_bytes=n_bytes,
                   bound_ms_per_district=per_district_bound_ms, chain_floor_ms=chain_ms,
                   chain_cycles=cycles,
                   district_steps_per_s=D * S / kernel_ms * 1e3, smi_after=power)

    phase(f"7. K2 vs plain at D={D}, K={K_CHUNK}")
    prep = k2.prepare_battery_collect(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    streams = (rand(-1.0, 1.0, (K_CHUNK, D, N_BUILDINGS)),
               rand(0.2, 3.0, (K_CHUNK, D, N_BUILDINGS)),
               rand(0.0, 3.0, (K_CHUNK, D, N_BUILDINGS)))
    cap = params.battery.capacity
    chunk_state = (rand(0.0, 1.0, (D, N_BUILDINGS)), rand(0.85, 0.95, (D, N_BUILDINGS)),
                   (cap * rand(0.9, 1.0, (D, N_BUILDINGS))).contiguous())
    # every seventh SOC at 1e-35, below the fast division's range: those
    # lanes redo their first step with IEEE operations
    tiny_soc = chunk_state[0].clone()
    tiny_soc.view(-1)[::7] = 1e-35
    n_knots = prep.curves[0].shape[0]
    cases = {"seeded": (prep, chunk_state),
             "tiny-soc": (prep, (tiny_soc, *chunk_state[1:])),
             "8-knots": (prep._replace(curves=tuple(
                 torch.cat([c, c[-1:].expand(8 - n_knots, -1)]).contiguous()
                 for c in prep.curves)), chunk_state),
             "subhour": (prep._replace(hours_ratio=0.25, ratio=4.0), chunk_state)}
    k2_max_abs = 0.0
    for label, (case_prep, case_state) in cases.items():
        for first in (True, False):
            print(f"{label}, first_chunk={first}:")
            ours = k2.battery_collect_chunk(case_prep, *streams, *case_state, first_chunk=first)
            ref = k2.battery_collect_chunk_reference(case_prep, *streams, *case_state,
                                                     first_chunk=first)
            k2_max_abs = max(k2_max_abs, check_bit_equal(
                f"K2 ({label}, first_chunk={first})", COLLECT_OUTPUTS, ours, ref))
    print(f"4 outputs bit-equal in {2 * len(cases)} runs from per-district seeded states")
    collect = lambda: k2.battery_collect_chunk(prep, *streams, *chunk_state, first_chunk=False)
    k2_ms = time_graph(collect, 100)
    k2_eager_ms = time_cuda(collect, 100)
    k2_plain_ms = time_cuda(lambda: k2.battery_collect_chunk_reference(
        prep, *streams, *chunk_state, first_chunk=False), 3)
    k2_bytes = 4 * (4 * K_CHUNK * D * B + 6 * D * B + 8 * B + 4 * n_knots * B)
    k2_ops = k2.collect_operation_count(prep, streams[0])
    k2_bytes_ms, k2_ops_ms = k2_bytes / PEAK_BYTES * 1e3, k2_ops / PEAK_FP32 * 1e3
    k2_bound_ms = max(k2_bytes_ms, k2_ops_ms)
    k2_cycles, k2_chain = chain_cycles("battery_collect", "collect_kernel")
    k2_chain_ms, clock_mhz = chain_floor_ms(k2_cycles, K_CHUNK)
    print(f"K2 {k2_ms:.5f} ms/launch on the device (a CUDA graph of 100 launches; "
          f"{D * K_CHUNK / k2_ms * 1e3:.4g} district-steps/s), {k2_eager_ms:.5f} ms a call "
          f"back to back through the wrapper; plain {k2_plain_ms:.3f} ms; bound "
          f"{k2_bound_ms:.5f} ms ({k2_ops:.4g} fp32 ops -> {k2_ops_ms:.5f} ms, {k2_bytes} bytes "
          f"-> {k2_bytes_ms:.5f} ms), share of bound {k2_bound_ms / k2_ms:.2%}; chain floor "
          f"{k2_chain_ms:.5f} ms ({K_CHUNK} steps x {k2_cycles:g} cycles at {clock_mhz:.0f} MHz, "
          f"read from this build's SASS along {k2_chain}), {k2_ms / k2_chain_ms:.2f}x of it; "
          f"build: {ptxas_report(results, 'battery_collect')}")
    results.update(k2_ms=k2_ms, k2_eager_ms=k2_eager_ms, k2_plain_ms=k2_plain_ms,
                   k2_bound_ms=k2_bound_ms, k2_bound_ops=k2_ops, k2_bound_bytes=k2_bytes,
                   k2_max_abs_err=k2_max_abs, k2_chain_floor_ms=k2_chain_ms,
                   k2_chain_cycles=k2_cycles)

    phase(f"8. training at D={D}, hidden {TRAIN['hidden']}, {K_CHUNK}-step chunks")
    with tempfile.TemporaryDirectory() as tmp:
        schema = write_battery_pv_dataset(tmp, N_BUILDINGS, N_ROWS, SEED)
        trainer = lambda collect, warmup: BatchedSAC(
            schema, TrainConfig(collect=collect, warmup_steps=warmup, **TRAIN),
            random_seed=SEED, episode_time_steps=TRAIN_EPISODE, device=dev)
        scan, kern = trainer("scan", 10**9), trainer("kernel", 10**9)
        tr = trainer("kernel", 8)
    if scan.use_kernel_collect or not kern.use_kernel_collect or not tr.use_kernel_collect:
        raise AssertionError("the trainers did not take the collect paths asked for")

    # (a) the per-step and the kernel collect, 64 warmup steps each
    for t in (scan, kern):
        t.train(K_CHUNK, chunk=K_CHUNK)
    torch.cuda.synchronize()
    if not torch.equal(scan.state.replay_act, kern.state.replay_act):
        raise AssertionError("per-step and kernel collect drew different actions")
    paths_err = 0.0
    pairs = [(f, getattr(scan.state, f), getattr(kern.state, f))
             for f in ("replay_obs", "replay_rew", "replay_next", "replay_done", "cur_obs")]
    pairs += [(f, getattr(scan.state.env_state, f), getattr(kern.state.env_state, f))
              for f in ("battery_soc", "battery_efficiency", "battery_degraded_capacity")]
    for name, a, b in pairs:
        diff = float((a - b).abs().max())
        paths_err = max(paths_err, diff)
        if not diff <= TOL_PATHS:
            raise AssertionError(f"per-step vs kernel collect: {name} differs by {diff}")
    print(f"(a) per-step vs kernel collect over {K_CHUNK} warmup steps: actions bit-equal, "
          f"replay rows and battery state max|diff| {paths_err:.3e} (tolerance {TOL_PATHS:g})")
    del scan, kern

    # (b) the main path: training on the kernel path
    w0 = tr.state.nets.policy.mean_w.detach().clone()
    k1.battery_episode.launches = 0
    k2.battery_collect_chunk.launches = 0
    hist = tr.train(16, chunk=16) + tr.train(K_CHUNK, chunk=K_CHUNK)
    torch.cuda.synchronize()
    k2_launches = k2.battery_collect_chunk.launches
    moved = float((tr.state.nets.policy.mean_w.detach() - w0).abs().max())
    print(f"(b) 80 steps: K2 launches {k2_launches}, mean reward per step {hist}, "
          f"policy head moved by {moved:.3e}")
    if k2_launches == 0:
        raise AssertionError("the training path never launched K2")
    if not moved > 0:
        raise AssertionError("no SAC update changed the policy")
    if not all(torch.isfinite(torch.tensor(hist))):
        raise AssertionError(f"non-finite rewards: {hist}")

    # (c) the train step's rate, split into collect and updates
    chunk_ms = time_cuda(lambda: tr.train(K_CHUNK, chunk=K_CHUNK), 3)
    tr._update = lambda t, n_slots: None       # the same chunks without their updates
    collect_ms = time_cuda(lambda: tr.train(K_CHUNK, chunk=K_CHUNK), 3)
    del tr._update
    update_ms = chunk_ms - collect_ms
    train_rate = D * K_CHUNK / chunk_ms * 1e3
    print(f"(c) train step: {chunk_ms:.2f} ms per {K_CHUNK}-step chunk = {train_rate:.4g} "
          f"district-steps/s; collect (policy sweep, K2, replay writes) {collect_ms:.2f} ms, "
          f"{K_CHUNK} updates {update_ms:.2f} ms")
    # K2 on the main path's own inputs: the streams and state that the
    # trainer hands it in one more chunk after warmup (policy actions)
    handed = {}
    shipped = train_module.battery_collect_chunk

    def keep(*args, **kw):
        handed.update(args=[a.clone() if torch.is_tensor(a) else a for a in args], kw=kw)
        return shipped(*args, **kw)

    train_module.battery_collect_chunk = keep
    try:
        tr.train(K_CHUNK, chunk=K_CHUNK)
    finally:
        train_module.battery_collect_chunk = shipped
    main_args, main_kw = handed["args"], handed["kw"]
    actions = main_args[1]
    if tuple(actions.shape) != (K_CHUNK, D, N_BUILDINGS):
        raise AssertionError(f"the trainer handed K2 streams of {tuple(actions.shape)}")
    check_bit_equal("K2 (the main path's inputs)", COLLECT_OUTPUTS,
                    k2.battery_collect_chunk(*main_args, **main_kw),
                    k2.battery_collect_chunk_reference(*main_args, **main_kw))
    k2_main_ms = time_graph(lambda: k2.battery_collect_chunk(*main_args, **main_kw), 100)
    warps = actions.reshape(K_CHUNK, -1)[:, :D * N_BUILDINGS // 32 * 32].reshape(K_CHUNK, -1, 32)
    mixed = float(((warps >= 0).any(-1) & (warps < 0).any(-1)).float().mean())
    charging = float((actions >= 0).float().mean())
    print(f"K2 on the main path's inputs (policy actions, {charging:.1%} charging; "
          f"{mixed:.1%} of warp-steps mixed in sign): {k2_main_ms:.5f} ms/launch on "
          f"the device, bit-equal to its plain version; {k2_main_ms / collect_ms:.2%} of the "
          f"collect")
    results.update(k2_main_inputs_ms=k2_main_ms, k2_main_mixed_warp_steps=mixed)
    # where a chunk's time goes: one more chunk under the profiler (which
    # slows the host side); device busy time against the wall clock
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(K_CHUNK, chunk=K_CHUNK)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    ops = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"profiled chunk: wall {profiled_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle {1 - busy_ms / profiled_ms:.1%}); top operations by device time, then "
          f"by host time:")
    for key in ("self_device_time_total", "self_cpu_time_total"):
        for e in sorted(ops, key=lambda e: -getattr(e, key))[:8]:
            print(f"  {e.key[:56]:56s} device {e.self_device_time_total / 1e3:8.2f} ms  "
                  f"host {e.self_cpu_time_total / 1e3:8.2f} ms  x{e.count}")
    results.update(k2_launches=k2_launches, train_chunk_ms=chunk_ms,
                   train_collect_ms=collect_ms, train_updates_ms=update_ms,
                   train_district_steps_per_s=train_rate, paths_err=paths_err,
                   profiled_chunk_ms=profiled_ms, profiled_device_busy_ms=busy_ms)

    # (d) evaluation: the trained policy, and a scripted baseline through K1
    t0 = time.perf_counter()
    learned = tr.evaluate(n_steps=SHORT_STEPS)
    torch.cuda.synchronize()
    results["train_evaluate_168_s"] = time.perf_counter() - t0
    check_table(learned, (D,), "BatchedSAC.evaluate")
    k1.battery_episode.launches = 0
    baseline = tr.evaluate(policy=policy)
    torch.cuda.synchronize()
    check_table(baseline, (D,), "BatchedSAC.evaluate(ScriptedPolicy)")
    if k1.battery_episode.launches == 0:
        raise AssertionError("evaluate(policy=ScriptedPolicy) did not launch K1")
    print(f"(d) evaluate at S={SHORT_STEPS}: {results['train_evaluate_168_s']:.2f} s, "
          f"cost_total {float(learned['district|cost_total'].mean()):.6f}; scripted "
          f"baseline through K1 ({k1.battery_episode.launches} launch), cost_total "
          f"{float(baseline['district|cost_total'][0]):.6f}")
    twin_kernel = twin_q_path(dev, tr, results)
    del tr

    thermal_kernel = thermal_path(dev, results)
    ev_kernel = ev_path(dev, results)
    lstm_kernel = lstm_path(dev, results)
    neighborhood_kernels = neighborhood_path(dev, results)
    family_training(dev, results)
    marlisa_training(dev, results)
    env_path(dev, results)
    cli_launches = cli_path(dev, results)
    mesh_launches = mesh_path(dev, results)
    tools_launches = tools_path(dev, results)

    kernels = {"kernels": [{
        "name": "battery_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/battery_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_battery.py:222",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}, {
        "name": "battery_collect_chunk", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/battery_collect.cu",
        "replaces": "citylearn_tpu/ops/pallas_collect.py:214",
        "launches": k2_launches, "max_abs_err": k2_max_abs, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": "bytes" if k2_bytes_ms > k2_ops_ms else "operations",
        "library_ms": None}, thermal_kernel, ev_kernel, lstm_kernel, *neighborhood_kernels,
        twin_kernel]}
    # the main path's launches of phases 29, 30 and 31 beside each row's own
    row_of = {"postpass_kernel": "neighborhood_postpass"}
    for row in kernels["kernels"]:
        row["launches"] += sum(n for launched in (cli_launches, mesh_launches, tools_launches)
                               for k, n in launched.items() if row_of.get(k, k) == row["name"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(dict(results, nvidia_smi=smi, device=device, **kernels), f, indent=1)
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measured numbers to this file")
    ap.add_argument("--cards", type=int, default=1,
                    help="above 1: run phase 30(c) alone, one NCCL rank on each of this many "
                         "cards")
    args = ap.parse_args()
    sys.exit(main(args.json) if args.cards == 1 else cards_main(args.cards, args.json))
