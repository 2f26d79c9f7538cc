"""What every cell's run shares: finding the cell's files by name, the
process clock, spans around calls into the program, the device trace, the
result line and the check that no JAX module was loaded."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "citylearn_tpu")
# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def process_age() -> float:
    """Seconds since this process started, by the kernel's record of its
    start (so the interpreter's start and every import count)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared as whole names."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


# --- the cell's files -------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]       # the metrics this cell reports with --trace 0
    per_layer: List[dict]        # and with --trace 1
    root: Path = ROOT


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, root)


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``benchmark/metrics/<metric>.py``'s ``read(run) -> float | None``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# --- what a run hands the metric readers -------------------------------------

@dataclass
class Run:
    """A run's readings: spans (seconds per call, by name), counters, the
    device trace's operations on the traced card ((name, start, end) in
    seconds) and host annotations, the traced window, and the shapes and
    counts the entry records."""
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float, int]] = field(default_factory=list)
    trace_window: Tuple[float, float] = None
    info: Dict[str, object] = field(default_factory=dict)

    def add(self, counter: str, value: float = 1.0):
        self.counters[counter] = self.counters.get(counter, 0.0) + value

    def busy_s(self, t0: float = None, t1: float = None) -> float:
        """Seconds of the window in which some device operation ran: the
        union of their intervals, clipped to the window."""
        a, b = self.trace_window if t0 is None else (t0, t1)
        total, end = 0.0, a
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            s, e = max(s, end), min(e, b)
            if e > s:
                total += e - s
                end = e
        return total

    def kernel_seconds(self, predicate: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed device seconds and count of the operations whose name
        ``predicate`` accepts."""
        hits = [e - s for n, s, e in self.device_ops if predicate(n)]
        return sum(hits), len(hits)


@contextlib.contextmanager
def spans(run: Run, targets: List[Tuple[object, str, str]], sync: Callable[[], None] = None):
    """Wrap ``getattr(obj, attr)`` for each (obj, attr, span). With a
    ``sync``, every call is timed to its completion on the device (``sync``
    before the clock is read) into ``run.spans``. Without one, only the
    host's start and end of each call are kept, beside the device trace's
    host events, on its clock; nothing waits for the device."""
    saved = []
    for obj, attr, name in targets:
        fn = getattr(obj, attr)
        times = run.spans.setdefault(name, []) if sync is not None else None

        def wrapped(*args, _fn=fn, _times=times, _name=name, **kw):
            if _times is None:
                t0 = time.time_ns()
                out = _fn(*args, **kw)
                run.host_ops.append((_name, t0 * 1e-9, time.time_ns() * 1e-9, 1))
                return out
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            sync()
            _times.append(time.perf_counter() - t0)
            return out

        saved.append((obj, attr, obj.__dict__.get(attr, None) if hasattr(obj, "__dict__") else None))
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


@contextlib.contextmanager
def device_trace(run: Run, device_index: int = 0):
    """``torch.profiler`` over the block, tracing the device's activity
    only (the host's operators are not recorded, so the host runs at its
    own pace); afterwards ``run`` holds the traced card's operations, the
    host events the trace has (the CUDA runtime's calls) beside the spans'
    host edges, on one clock in seconds, and the window's bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        yield
        torch.cuda.synchronize()
        t1 = time.time_ns()
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.device_index() != device_index:
                continue
            device_ops.append((e.name(), start, end))
        else:
            host_ops.append((e.name(), start, end, 1 if e.is_user_annotation() else 0))
    run.device_ops = device_ops
    run.host_ops = run.host_ops + host_ops
    lo = min([s for _, s, _ in device_ops] + [t0 * 1e-9])
    hi = max([e for _, _, e in device_ops] + [t1 * 1e-9])
    run.trace_window = (lo, hi)


def breakdown(run: Run, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    card summed by what the host was doing in each gap (the innermost
    annotation and host operation at the gap's middle)."""
    per_op: Dict[str, float] = {}
    for n, s, e in run.device_ops:
        per_op[n] = per_op.get(n, 0.0) + (e - s)
    gaps, end = [], run.trace_window[0]
    for _, s, e in sorted(run.device_ops, key=lambda x: x[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if run.trace_window[1] > end:
        gaps.append((end, run.trace_window[1]))
    host = sorted(run.host_ops, key=lambda x: x[1])
    starts = [h[1] for h in host]
    import bisect

    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        span, op = None, None
        for n, s, e, annotated in reversed(host[max(0, i - 4000):i]):
            if e >= mid:
                if annotated and span is None:
                    span = n
                elif not annotated and op is None:
                    op = n
            if span and op:
                break
        label = f"{span or 'no span'}/{op or 'python'}"
        idle[label] = idle.get(label, 0.0) + (b - a)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(per_op), "idle_gaps": rank(idle)}


# --- the result ----------------------------------------------------------------

@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Every number that has a limit, beside it (a missing number is NaN,
    which fails)."""
    return [Check(k, float(values.get(k, float("nan"))), float(v)) for k, v in limits.items()]


def device_info(chips: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak_bytes)}


def emit(cell: Cell, values: Dict[str, float], run: Optional[Run], trace: bool, device: dict,
         checks: List[Check], attempted: int, failed: int) -> int:
    """Print the checks on standard error and the result line last on
    standard output; returns the exit code."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(m["name"], cell.root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = bool(checks) and all(c.ok for c in checks)
    line = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = breakdown(run)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the ``boottime`` clock."""
    return boottime() - process_age()


def log_phases(phases: List[Tuple[str, float]]):
    """Seconds of each set-up phase, on standard error."""
    print("setup " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                in zip(phases, phases[1:])), file=sys.stderr)
