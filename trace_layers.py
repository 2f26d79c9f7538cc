#!/usr/bin/env python3
"""Where the time of the benchmark's one-card cells goes, by the
program's own spans (``citylearn_tpu_torch.tracing``), on one CUDA card.

    python3 trace_layers.py [--seed N] [--calls 8] [--steps 2000] [--pairs 24] [--json PATH]

The cells are built as ``benchmark/`` builds them (``BENCHMARK.json``'s
``challenge2022_phase1.sac_train``, ``challenge2022_phase1.gym_year``,
``challenge2023_phase1.sac_train`` and
``challenge2022_phase_all_plus_evs.sac_train``, from the seed) and warmed up; then,
for each, in one process:

1. spans: ``--calls`` train calls (``--steps`` env steps) with the tracer
   on and nothing else; every span name's count and mean milliseconds,
   the calls (steps) a second of the same stretch, and the counts of
   ``sac.graph`` and ``sac.capture`` with the share of updates that
   replayed the update's CUDA graph;
2. launches: two calls (500 steps) with the tracer on under a
   ``torch.profiler`` trace of the device; the CUDA runtime's launches,
   copies, memsets and graph launches, each put down to the innermost
   program span open when its host call began, per span opened; and the
   card's idle time, each gap put down to the innermost program span at
   its middle;
3. on-cost: ``--pairs`` pairs of one call (300 steps) with the tracer on
   and off, in alternating order; calls (steps) a second of each side and
   the paired relative difference's quartiles;
4. the SAC cells' update graph (``update_graph``), captured anew by one
   call: the twin soft-Q passes (span ``twin_q``) and kernel launches
   (``twin_q.launches``) a ``_sac_step`` run makes, then the graph's replays alone under the device trace: the
   device kernels one replay runs, the twin kernels' count and device time
   a replay, and the kernels that take most of it.

The per-step LSTM cell runs a quarter of ``--calls`` and of ``--pairs``
(a call is 64 district steps there, each with its own update), and adds
each step's time outside its update (``train.step`` less ``train.update``)
and the share of it in ``step.dynamics`` (the LSTM) and
``step.partial_load`` (both seen only in eager steps: a replay of the
step's CUDA graph runs neither as Python). For it and the Gym cell,
``step_graph`` counts ``step.graph`` (a replay of the district step's
CUDA graph) and ``step.capture`` in the warm-up and in stretch 1, and
the share of stretch 1's district steps that replayed.

The per-step EV cell (``challenge2022_phase_all_plus_evs.sac_train``)
runs as the LSTM cell does, and adds: an eager EV step's split (twenty
``district_step`` calls off the step's graph, each ended by a
synchronize: the step's milliseconds, and the host milliseconds of its
``step.ev`` and ``step.washing_machines`` spans and of the rest), the
charger steps counted in stretch 1 (``train.charger_steps``, D x C a
step), and the step's CUDA graph's replays alone under the device trace
(the device kernels one replay runs and its busy time, as for the
update's graph, which is traced too, at 17 agents).

Prints one JSON object, also written to ``--json`` (default
``chiprun_out/trace_layers.json``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import harness
from benchmark.entries import gym as gym_entry
from benchmark.entries import sac_train as sac_entry
from benchmark.entries import sac_train_evs as evs_entry
from benchmark.entries import sac_train_scan as scan_entry
from citylearn_tpu_torch import tracing

LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def span_table(rec: tracing.Recording) -> dict:
    """Each span name's count and mean milliseconds."""
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-6)
    return {name: {"n": len(v), "mean_ms": sum(v) / len(v)} for name, v in sorted(by.items())}


def graph_share(table: dict) -> dict:
    """How many updates replayed ``sac_update``'s CUDA graph (``sac.graph``)
    and how many captured it (``sac.capture``), and the replays' share of
    the updates (``train.update``)."""
    n = lambda name: table.get(name, {}).get("n", 0)
    updates = n("train.update")
    return {"sac.graph": n("sac.graph"), "sac.capture": n("sac.capture"),
            "replayed_share": n("sac.graph") / updates if updates else None}


def step_graph_share(table: dict, steps: str, warmup: dict) -> dict:
    """How many district steps replayed their owner's CUDA graph of the step
    (``step.graph``) and how many captured it (``step.capture``), in the
    warm-up and in the recorded stretch, and the replays' share of the
    recorded stretch's steps (spans named ``steps``)."""
    n = lambda t, name: t.get(name, {}).get("n", 0)
    return {"step.graph": n(table, "step.graph"), "step.capture": n(table, "step.capture"),
            "warmup_step.graph": n(warmup, "step.graph"),
            "warmup_step.capture": n(warmup, "step.capture"),
            "replayed_share": (n(table, "step.graph") / n(table, steps)
                               if n(table, steps) else None)}


def innermost(spans, starts, t: float):
    """The latest-begun span (name, start, end) open at ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][2] >= t:
            return spans[i]
        i -= 1
    return None


def launches_and_idle(run: harness.Run, rec: tracing.Recording) -> dict:
    """Runtime launches per span opened, by innermost span, and the idle
    time of the traced window by innermost span at each gap's middle."""
    spans = sorted(((s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in rec.spans),
                   key=lambda x: x[1])
    starts = [s[1] for s in spans]
    opened = {}
    for name, _, _ in spans:
        opened[name] = opened.get(name, 0) + 1
    launches, outside = {}, 0
    for name, s, _, annotated in run.host_ops:
        if not annotated and name.startswith(LAUNCHES):
            inner = innermost(spans, starts, s)
            if inner is None:
                outside += 1
            else:
                launches[inner[0]] = launches.get(inner[0], 0) + 1
    gaps, end = [], run.trace_window[0]
    for _, s, e in sorted(run.device_ops, key=lambda x: x[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if run.trace_window[1] > end:
        gaps.append((end, run.trace_window[1]))
    idle = {}
    for a, b in gaps:
        inner = innermost(spans, starts, 0.5 * (a + b))
        key = inner[0] if inner else "no span"
        idle[key] = idle.get(key, 0.0) + (b - a)
    window = run.trace_window[1] - run.trace_window[0]
    idle_s = sum(idle.values())
    return {
        "launches_per_span": {n: launches[n] / opened[n] for n in sorted(launches)},
        "launches_total": sum(launches.values()), "launches_outside_spans": outside,
        "idle_s": {k: v for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_share_pct": 100.0 * idle_s / window,
        "idle_in_program_span_pct": 100.0 * (idle_s - idle.get("no span", 0.0)) / idle_s,
        "window_s": window,
    }


def on_off(pairs: int, once) -> dict:
    """``once()`` timed with the tracer on and off, alternating which goes
    first; rates are 1 / seconds."""
    on, off = [], []
    for k in range(pairs):
        for traced in ((True, False) if k % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            if traced:
                with tracing.recording():
                    once()
            else:
                once()
            (on if traced else off).append(1.0 / (time.perf_counter() - t0))
    rel = [100.0 * (a / b - 1.0) for a, b in zip(on, off)]
    q = statistics.quantiles(rel, n=4)
    spread = statistics.quantiles(off, n=4)
    return {"on_median": statistics.median(on), "off_median": statistics.median(off),
            "paired_pct_median": statistics.median(rel), "paired_pct_q1": q[0],
            "paired_pct_q3": q[2],
            "off_spread_pct": 100.0 * (spread[2] - spread[0]) / statistics.median(off)}


TWIN_KERNELS = ("forward_layer", "rows_layer", "columns_layer")


def update_graph_kernels(tr, job, replays: int = 32) -> dict:
    """The update's CUDA graph captured anew by one train call: the twin
    soft-Q forward passes (span ``twin_q``) and kernel launches
    (``twin_q.launches``) per ``_sac_step`` run (the eager first update and
    the capture: a replay runs no Python); then
    ``replays`` replays of the graph alone under the device trace: the
    device kernels a replay runs, the twin kernels' count and device time a
    replay (``csrc/twin_q.cu``), the replay's busy time, and the kernels
    that took most of it. The replays update the nets once more each, so
    this runs last in its cell."""
    from citylearn_tpu_torch.graphs import Graph
    from citylearn_tpu_torch.ops.twin_q import twin_q

    nets = tr.state.nets
    nets.update_graph = Graph("sac")
    before = twin_q.launches
    with tracing.recording() as rec:
        tr.train(job.chunk, chunk=job.chunk)
    torch.cuda.synchronize()
    steps = len(rec.durations("sac.target"))
    replayed, run = replay_kernels(nets.update_graph.captured, replays)
    twin_s, twin_n = run.kernel_seconds(lambda name: any(k in name for k in TWIN_KERNELS))
    return {"sac_steps": steps, "sac.capture": len(rec.durations("sac.capture")),
            "twin_passes_per_sac_step": len(rec.durations("twin_q")) / steps if steps else None,
            "twin_launches_per_sac_step": (twin_q.launches - before) / steps if steps else None,
            "twin_kernels_per_replay": twin_n / replays,
            "twin_ms_per_replay": 1e3 * twin_s / replays, **replayed}


def replay_kernels(graph, replays: int = 32):
    """``replays`` replays of a captured CUDA graph alone under the device
    trace: the device kernels a replay runs, its kernels' and its busy
    milliseconds, and the kernels that took most of it; and the trace."""
    run = harness.Run()
    with harness.device_trace(run):
        for _ in range(replays):
            graph.replay()
    by_name = {}
    for name, s, e in run.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"replays": replays, "kernels_per_replay": len(run.device_ops) / replays,
            "kernel_ms_per_replay": 1e3 * sum(by_name.values()) / replays,
            "busy_ms_per_replay": 1e3 * run.busy_s() / replays,
            "top_kernels_ms_per_replay": [[name[:96], 1e3 * t / replays] for name, t in top]}, run


def eager_ev_split(tr, steps: int = 20) -> dict:
    """``steps`` eager ``district_step`` calls of the EV district off the
    step's graph, from the trainer's state under zero actions, each ended
    by a synchronize: the step's milliseconds, and the host milliseconds of
    its EV and machine blocks' spans and of the rest of the step."""
    from citylearn_tpu_torch.core.step import district_step

    a = torch.zeros((tr.n_local,) + tuple(tr.act_low.shape), device=tr.device)
    actions = tr._actions_dict(a)
    state = tr.state.env_state
    times = []
    with tracing.recording() as rec:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            district_step(tr.env_cfg, tr.params, state, actions)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    step_ms = 1e3 * sum(times) / steps
    ms = lambda name: 1e3 * sum(rec.durations(name)) / steps
    ev, wm = ms("step.ev"), ms("step.washing_machines")
    return {"steps": steps, "step_ms": step_ms, "step.ev_ms": ev,
            "step.charging_constraints_ms": ms("step.charging_constraints"),
            "step.washing_machines_ms": wm, "rest_ms": step_ms - ev - wm}


def traced(fn):
    run, rec = harness.Run(), None
    with harness.device_trace(run), tracing.recording() as rec:
        fn()
    return launches_and_idle(run, rec)


def sac_cell(seed: int, calls: int, pairs: int, root: str) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "challenge2022_phase1.sac_train")
    sac_entry._no_tf32()
    job, _, tr, _ = sac_entry.build(cell, seed, root, torch.device("cuda:0"))
    once = lambda: tr.train(job.chunk, chunk=job.chunk)
    for _ in range(3):
        once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.recording() as rec:
        for _ in range(calls):
            once()
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    table = span_table(rec)
    call_ids = {s.id for s in rec.spans if s.name == "train.call"}
    children = sum(s.end_ns - s.start_ns for s in rec.spans if s.parent in call_ids)
    out = {"calls": calls, "calls_per_s": calls / elapsed,
           "dsteps_per_s": calls * job.chunk * job.n_districts / elapsed, "spans": table,
           "call_children_ms": children * 1e-6 / calls, "graph": graph_share(table)}
    out["trace"] = traced(lambda: (once(), once()))
    out["on_off"] = on_off(pairs, once)
    out["update_graph"] = update_graph_kernels(tr, job)
    del tr
    torch.cuda.empty_cache()
    return out


def scan_cell(seed: int, calls: int, pairs: int, root: str) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "challenge2023_phase1.sac_train")
    sac_entry._no_tf32()
    job, _, tr, _ = scan_entry.build(cell, seed, root, torch.device("cuda:0"))
    once = lambda: tr.train(job.chunk, chunk=job.chunk)
    with tracing.recording() as warm:
        for _ in range(3):
            once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.recording() as rec:
        for _ in range(calls):
            once()
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    table = span_table(rec)
    total = lambda name: sum(rec.durations(name)) * 1e3
    steps = table.get("train.step", {}).get("n", 0)
    outside = total("train.step") - total("train.update")
    out = {"calls": calls, "calls_per_s": calls / elapsed,
           "dsteps_per_s": calls * job.chunk * job.n_districts / elapsed, "spans": table,
           "graph": graph_share(table),
           "step_graph": step_graph_share(table, "train.step", span_table(warm)),
           "step_less_update_ms": outside / steps if steps else None,
           "dynamics_share_of_step_pct": 100.0 * total("step.dynamics") / outside if steps else None,
           "partial_load_share_of_step_pct":
               100.0 * total("step.partial_load") / outside if steps else None}
    out["trace"] = traced(once)
    out["on_off"] = on_off(pairs, once)
    out["update_graph"] = update_graph_kernels(tr, job)
    del tr
    torch.cuda.empty_cache()
    return out


def ev_cell(seed: int, calls: int, pairs: int, root: str) -> dict:
    import citylearn_tpu_torch.train as train_mod

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "challenge2022_phase_all_plus_evs.sac_train")
    sac_entry._no_tf32()
    job, _, tr, _ = evs_entry.build(cell, seed, root, torch.device("cuda:0"))
    once = lambda: tr.train(job.chunk, chunk=job.chunk)
    with tracing.recording() as warm:
        for _ in range(3):
            once()
    torch.cuda.synchronize()
    before = train_mod.charger_steps
    t0 = time.perf_counter()
    with tracing.recording() as rec:
        for _ in range(calls):
            once()
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    table = span_table(rec)
    total = lambda name: sum(rec.durations(name)) * 1e3
    steps = table.get("train.step", {}).get("n", 0)
    out = {"calls": calls, "calls_per_s": calls / elapsed,
           "dsteps_per_s": calls * job.chunk * job.n_districts / elapsed, "spans": table,
           "graph": graph_share(table),
           "step_graph": step_graph_share(table, "train.step", span_table(warm)),
           "charger_steps": train_mod.charger_steps - before,
           "charger_steps_per_step": (train_mod.charger_steps - before) / steps if steps else None,
           "step_less_update_ms": (total("train.step") - total("train.update")) / steps
           if steps else None}
    out["eager_step"] = eager_ev_split(tr)
    out["step_replay"] = replay_kernels(tr._step_graph.graph.captured)[0]
    out["trace"] = traced(once)
    out["on_off"] = on_off(pairs, once)
    out["update_graph"] = update_graph_kernels(tr, job)
    del tr
    torch.cuda.empty_cache()
    return out


def gym_cell(seed: int, steps: int, pairs: int, root: str) -> dict:
    from citylearn_tpu_torch.envs.environment import CityLearnEnv

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "challenge2022_phase1.gym_year")
    env = CityLearnEnv(sac_entry.write_district(cell.config, seed, root),
                       device=torch.device("cuda:0"))
    actions, _ = gym_entry.draw_actions(env, seed, env.time_steps - 1)
    env.reset()

    def run_steps(n):
        for _ in range(n):
            _, _, terminated, _, _ = env.step(actions[env.time_step])
            if terminated:
                env.reset()

    with tracing.recording() as warm:
        run_steps(int(cell.traffic["warmup_steps"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.recording() as rec:
        run_steps(steps)
    elapsed = time.perf_counter() - t0
    table = span_table(rec)
    out = {"steps": steps, "steps_per_s": steps / elapsed, "spans": table,
           "step_graph": step_graph_share(table, "env.district_step", span_table(warm))}
    out["trace"] = traced(lambda: run_steps(int(cell.traffic["trace_steps"])))
    out["on_off"] = on_off(pairs, lambda: run_steps(300))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2**31 + 17)
    p.add_argument("--calls", type=int, default=8)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--pairs", type=int, default=24)
    p.add_argument("--json", default=os.path.join("chiprun_out", "trace_layers.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_layers.py needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    root = tempfile.mkdtemp(prefix="trace-layers-")
    try:
        out = {"card": card, "seed": args.seed,
               "sac_train": sac_cell(args.seed, args.calls, args.pairs, root),
               "gym_year": gym_cell(args.seed, args.steps, args.pairs, root),
               "lstm_sac_train": scan_cell(args.seed, max(1, args.calls // 4),
                                           max(2, args.pairs // 4), root),
               "ev_sac_train": ev_cell(args.seed, max(1, args.calls // 4),
                                       max(2, args.pairs // 4), root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
