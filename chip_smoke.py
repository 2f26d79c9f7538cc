#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them: the
battery+PV district's evaluation (kernel K1) and training (K2), the
thermal-storage district's evaluation (K3), the EV district's (K4) and
the LSTM-dynamics district's (K5).

    python3 chip_smoke.py [--json PATH]

Phases, each of which raises on failure:
  1. the device: name, count, torch and CUDA versions, nvidia-smi;
  2. build every CUDA kernel from ``citylearn_tpu_torch/csrc``;
  3. write a seeded 5-building, 8760-row battery+PV dataset (the shape of
     ``citylearn_challenge_2022_phase_1``), compile it and pack it on the card;
  4. kernel vs plain: K1 (``battery_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over the full year;
     the plain version's one run is timed;
  5. the main path, with the launch counts reset just before and read just
     after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both kernel-backed),
     then at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
  6. times with CUDA events: K1 per launch and its bound;
  7. kernel vs plain: K2 (``battery_collect_chunk``) against its plain
     PyTorch version at D=4096 districts x K=64 steps, with and without the
     first-step accounting, and its times;
  8. the training path, ``BatchedSAC`` at the JAX package's ``sac_train_step``
     settings (D=4096, hidden 256x256, batch 256, 64-step chunks):
     (a) the per-step and the kernel collect agree over 64 warmup steps;
     (b) the main path, with the launch counts reset just before and read
     just after: 80 training steps on the kernel path, whose updates must
     move the policy; (c) the train step's rate over 3 more 64-step chunks,
     split into collect and updates; (d) ``evaluate`` of the trained policy
     over 168 steps, and of a scripted baseline through K1;
  9. write a seeded 9-building, 8760-row thermal-storage dataset (cooling
     and DHW devices and tanks, battery, PV: the shape of
     ``citylearn_challenge_2021``), compile it and pack it on the card;
 10. kernel vs plain: K3 (``thermal_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over a summer quarter
     of the year (2190 steps: the plain version's run is the long part of
     this script, and the kernel is timed over the full year in phase 12),
     all 8 outputs and the 9 recorded rows, under plans that take both
     priority orders of both end uses; the plain version's one run is timed;
 11. the thermal main path, with the launch counts reset just before and
     read just after: ``evaluate_scripted`` at D=4096 over the full year
     and ``evaluate_districts`` with a scripted policy (both K3-backed),
     then at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
 12. times with CUDA events: K3 per launch and its bound, the full-year
     ``evaluate_scripted`` and the stepped thermal path per step;
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
 15. the EV main path, with the launch counts reset just before and read
     just after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both K4-backed), then
     at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
 16. times with CUDA events: K4 per launch and its bound, the full-year
     ``evaluate_scripted`` and the stepped EV path per step; K4 once more
     with the default reward, which leaves the reward's phase out;
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
     stepped LSTM path per step.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi name and power
limit, and last ``{"ok": true, "device": {...}}``; ``--json PATH`` also
writes every number measured to PATH. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
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
    thermal_episode_inputs,
)
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.ops import collect as k2
from citylearn_tpu_torch.ops import ev as k4
from citylearn_tpu_torch.ops import lstm as k5
from citylearn_tpu_torch.ops import thermal as k3
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_lstm_dataset,
    write_thermal_dataset,
)
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

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
PEAK_FP32 = 67e12             # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
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
TOL_PATHS = 2e-5              # per-step vs kernel collect: replay rows and state
# KPIs that are NaN by the reference's semantics on data with no occupants
# and no outage (a proportion of zero occupied or zero outage steps)
NAN_KPIS = {"discomfort_proportion", "discomfort_cold_proportion",
            "discomfort_hot_proportion", "one_minus_thermal_resilience_proportion",
            "power_outage_normalized_unserved_energy_total"}


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
    print(f"\n== {title}", flush=True)


def scaled_error(a, b):
    """(max |a - b|, max |a - b| / max |b|)."""
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-30)


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


def table_error(fast, stepped, comfort_steps=0):
    """Largest error of the kernel-backed KPI table against the stepped
    one, relative to max(|value|, 1); raises beyond ``TOL_TABLE``. The
    discomfort and resilience KPIs, which count or average the steps
    beyond a comfort threshold, may also move by ``comfort_steps`` steps
    in ``SHORT_STEPS`` (their own largest error is returned second)."""
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
            tol = TOL_TABLE + comfort_steps / SHORT_STEPS
        else:
            worst = max(worst, err)
            tol = TOL_TABLE
        if not err <= tol:
            raise AssertionError(f"kernel vs stepped table at S={SHORT_STEPS}: {k} {err}")
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

    both_orders = with_both_orders(inputs)
    quarter = with_both_orders(thermal_episode_inputs(
        cfg, params, D, tables, n_steps=QUARTER_STEPS, data_offset=S // 2))
    ours = k3.thermal_episode(**quarter, record=True)
    ref, plain_ms = timed_once(lambda: k3.thermal_episode_reference(**quarter, record=True))
    max_abs = 0.0
    for name, a, b in zip(THERMAL_OUTPUTS, ours, ref):
        diff, rel = scaled_error(a, b)
        max_abs = max(max_abs, diff)
        tol = TOL_SUM if name in ("reward", "cost", "emission") else TOL_STEP
        print(f"{name:11s} max|diff| {diff:.3e}  scaled {rel:.3e}  (tolerance {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"K3 {name} disagrees with its plain version: {rel}")
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
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K3 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{main_ms:.4f} ms on the main path's inputs, whose DHW tanks never charge); "
          f"plain {plain_ms:.2f} ms for {QUARTER_STEPS} steps; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms), "
          f"share of bound {bound_ms / kernel_ms:.2%}; "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; stepped "
          f"evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms "
          f"({stepped_ms / SHORT_STEPS:.3f} ms per step)")
    results.update(
        k3_ms=kernel_ms, k3_main_inputs_ms=main_ms, k3_plain_ms=plain_ms,
        k3_plain_steps=QUARTER_STEPS,
        k3_bound_ms=bound_ms, k3_bound_ops=n_ops, k3_bound_bytes=n_bytes,
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
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K4 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s; "
          f"{default_ms:.4f} ms with the default reward); plain {plain_ms:.2f} ms for "
          f"{QUARTER_STEPS} steps; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms), "
          f"share of bound {bound_ms / kernel_ms:.2%}; "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    print(f"evaluate_scripted full year at D={D}: {eval_ms:.3f} ms; stepped "
          f"evaluate_districts S={SHORT_STEPS} at D={D}: {stepped_ms:.1f} ms "
          f"({stepped_ms / SHORT_STEPS:.3f} ms per step)")
    results.update(
        k4_ms=kernel_ms, k4_default_reward_ms=default_ms, k4_plain_ms=plain_ms,
        k4_plain_steps=QUARTER_STEPS, k4_bound_ms=bound_ms, k4_bound_ops=n_ops,
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
                               if "registers" in line or "spill" in line]
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
    ours = k1.battery_episode(**inputs, record=True)
    ref, plain_ms = timed_once(lambda: k1.battery_episode_reference(**inputs, record=True))
    max_abs = 0.0
    for name, a, b in zip(OUTPUTS, ours, ref):
        diff, rel = scaled_error(a, b)
        max_abs = max(max_abs, diff)
        tol = TOL_SUM if name in ("reward", "cost", "emission") else TOL_STEP
        print(f"{name:9s} max|diff| {diff:.3e}  scaled {rel:.3e}  (tolerance {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"K1 {name} disagrees with its plain version: {rel}")
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
    kernel_ms = time_cuda(lambda: k1.battery_episode(**inputs, record=True), 20)
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
    n_ops = k1.operation_count(inputs["actions"], n_knots, D)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    power = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"K1 {kernel_ms:.4f} ms/launch ({D * S / kernel_ms * 1e3:.4g} district-steps/s); "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
          f"({n_ops:.4g} fp32 ops -> {ops_ms:.4f} ms, {n_bytes} bytes -> {bytes_ms:.5f} ms); "
          f"nvidia-smi sm clock, draw, limit, temp: {power}")
    results.update(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_ops=n_ops, bound_bytes=n_bytes,
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
    k2_max_abs = 0.0
    for first in (True, False):
        ours = k2.battery_collect_chunk(prep, *streams, *chunk_state, first_chunk=first)
        torch.cuda.synchronize()
        ref = k2.battery_collect_chunk_reference(prep, *streams, *chunk_state,
                                                 first_chunk=first)
        for name, a, b in zip(COLLECT_OUTPUTS, ours, ref):
            diff, rel = scaled_error(a, b)
            k2_max_abs = max(k2_max_abs, diff)
            print(f"first_chunk={first!s:5} {name:6s} max|diff| {diff:.3e}  scaled {rel:.3e}  "
                  f"(tolerance {TOL_STEP:g})")
            if not rel <= TOL_STEP:
                raise AssertionError(f"K2 {name} disagrees with its plain version: {rel}")
    k2_ms = time_cuda(lambda: k2.battery_collect_chunk(prep, *streams, *chunk_state,
                                                       first_chunk=False), 50)
    k2_plain_ms = time_cuda(lambda: k2.battery_collect_chunk_reference(
        prep, *streams, *chunk_state, first_chunk=False), 3)
    n_knots = prep.curves[0].shape[0]
    k2_bytes = 4 * (4 * K_CHUNK * D * B + 6 * D * B + 8 * B + 4 * n_knots * B)
    k2_ops = k2.collect_operation_count(prep, streams[0])
    k2_bytes_ms, k2_ops_ms = k2_bytes / PEAK_BYTES * 1e3, k2_ops / PEAK_FP32 * 1e3
    k2_bound_ms = max(k2_bytes_ms, k2_ops_ms)
    print(f"K2 {k2_ms:.4f} ms/launch ({D * K_CHUNK / k2_ms * 1e3:.4g} district-steps/s); "
          f"plain {k2_plain_ms:.3f} ms; bound {k2_bound_ms:.5f} ms ({k2_ops:.4g} fp32 ops -> "
          f"{k2_ops_ms:.5f} ms, {k2_bytes} bytes -> {k2_bytes_ms:.5f} ms)")
    results.update(k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_bound_ms=k2_bound_ms,
                   k2_bound_ops=k2_ops, k2_bound_bytes=k2_bytes, k2_max_abs_err=k2_max_abs)

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

    thermal_kernel = thermal_path(dev, results)
    ev_kernel = ev_path(dev, results)
    lstm_kernel = lstm_path(dev, results)

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
        "library_ms": None}, thermal_kernel, ev_kernel, lstm_kernel]}
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
    sys.exit(main(ap.parse_args().json))
