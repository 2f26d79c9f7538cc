#!/usr/bin/env python3
"""Drive the PyTorch port's battery+PV path on one CUDA card and check it.

    python3 chip_smoke.py [--json PATH]

Phases, each of which raises on failure:
  1. the device: name, count, torch and CUDA versions, nvidia-smi;
  2. build every CUDA kernel from ``citylearn_tpu_torch/csrc``;
  3. write a seeded 5-building, 8760-row battery+PV dataset (the shape of
     ``citylearn_challenge_2022_phase_1``), compile it and pack it on the card;
  4. kernel vs plain: K1 (``battery_episode``) against its plain PyTorch
     version on the same tensors at D=4096 districts over the full year;
  5. the main path, with the launch counts reset just before and read just
     after: ``evaluate_scripted`` at D=4096 over the full year and
     ``evaluate_districts`` with a scripted policy (both kernel-backed),
     then at 168 steps the kernel-backed table against the stepped
     ``evaluate_districts`` at D=4096;
  6. times with CUDA events: K1 per launch, its plain version, its bound.

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
from citylearn_tpu_torch.core.rollout_fast import battery_episode_inputs, eligible
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

DEVICE = "cuda"
D = 4096                      # districts per batch
N_BUILDINGS, N_ROWS, SEED = 5, 8760, 0
SHORT_STEPS = 168             # the kernel-vs-stepped table comparison
PEAK_FP32 = 67e12             # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
# expected bit-equal (-fmad=false, IEEE div/sqrt); held to these errors
# relative to each output's largest magnitude
TOL_STEP = 1e-6               # per-step record and final state
TOL_SUM = 1e-5                # year-long reward/cost/emission sums
TOL_TABLE = 1e-5              # KPI tables: ratios of sums taken in another order
OUTPUTS = ("reward", "cost", "emission", "soc", "eff", "deg", "record")
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


def check_table(table, lead, where):
    """Every KPI has shape ``lead`` (+ (B,) for building rows) and is
    finite, except those NaN by the reference's semantics on this data."""
    if len(table) != 37:
        raise AssertionError(f"{where}: {len(table)} KPIs, want 37")
    for k, v in table.items():
        shape = lead + ((N_BUILDINGS,) if k.startswith("building|") else ())
        if tuple(v.shape) != shape:
            raise AssertionError(f"{where}: {k} has shape {tuple(v.shape)}, want {shape}")
        if k.split("|")[1] not in NAN_KPIS and not torch.isfinite(v).all():
            raise AssertionError(f"{where}: {k} is not finite: {v}")


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
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
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
    torch.cuda.synchronize()
    ref = k1.battery_episode_reference(**inputs, record=True)
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
    worst = 0.0
    for k in fast:
        a, b = fast[k], stepped[k]
        if tuple(a.shape) != tuple(b.shape) or not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError(f"kernel and stepped tables differ in shape or NaN on {k}")
        finite = ~b.isnan()
        err = float(((a - b).abs()[finite] / b.abs()[finite].clamp(min=1.0)).max()) \
            if finite.any() else 0.0
        worst = max(worst, err)
        if not err <= TOL_TABLE:
            raise AssertionError(f"kernel vs stepped table at S={SHORT_STEPS}: {k} {err}")
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
    plain_ms = time_cuda(lambda: k1.battery_episode_reference(**inputs, record=True), 1)
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

    kernels = {"kernels": [{
        "name": "battery_episode", "route": "cuda",
        "source": "citylearn_tpu_torch/csrc/battery_episode.cu",
        "replaces": "citylearn_tpu/ops/pallas_battery.py:222",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None}]}
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
