"""Batched SAC training on the kernel collect path: ``BatchedSAC.train(K,
chunk=K)`` called back to back on one card.

Set-up writes the seeded district, builds the trainer, loads the
benchmark's seeded weights into it and runs its first three train calls
(which also warm up every shape the window uses) while recording what the
comparison reads. The window then calls ``train`` until ``--seconds`` have
passed and closes at the end of the last call begun before then. Through
the window (and past its close, untimed, until it comes) the collect
chunk that ends the first episode and the one that starts the next are
recorded with the program's state at their start. After the window the
reference follows the same three calls from the same inputs, and follows
the two recorded chunks from the program's recorded state; the numbers
below are compared, each with its limit from the traffic file:

- ``loss_gap``: each call's mean critic and actor loss over its updates;
- ``grad_gap``: the norm of each leaf's first gradient, read from the
  program's Adam state after one update (``exp_avg / (1 - beta1)``);
- ``change_gap``: the norm of each leaf's change over the three calls;
- ``reward_gap``, ``action_gap``: the collect's physics and policy
  sweep, the largest over the first call's replay rewards and actions and
  the two recorded chunks';
- ``state_gap``: the battery state after the first call;
- ``reset_gap``: the elements that differ at the episode's end, which
  must be none: the done flags of the two chunks, and after the reset the
  new window offsets, the episode position and the battery state.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark import harness
from benchmark.frozen import counts, synthetic
from benchmark.reference import sac as ref_sac
from benchmark.reference.train import Job, ReferenceTrainer

FIRST_CALLS = 3
NETS = ("q1", "q2", "policy")


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def write_district(config: dict, seed: int, root: str) -> str:
    """The seeded district of the configuration's shape; where the
    configuration states the observations and the battery and PV
    attributes, the schema takes them from it (the writer draws only the
    series then)."""
    writer = getattr(synthetic, config["writer"])
    path = writer(root, n_buildings=config["n_buildings"], n_rows=config["n_rows"],
                  seed=seed % 2 ** 32)
    if not any(k in config for k in ("observations", "electrical_storage", "pv")):
        return path
    with open(path) as f:
        schema = json.load(f)
    if "observations" in config:
        shared = set(config.get("shared_in_central_agent", ()))
        schema["observations"] = {k: {"active": True, "shared_in_central_agent": k in shared}
                                  for k in config["observations"]}
    for device in ("electrical_storage", "pv"):
        if device in config:
            for building in schema["buildings"].values():
                building[device]["attributes"] = dict(config[device])
    with open(path, "w") as f:
        json.dump(schema, f, indent=2)
    return path


def seeded_nets(job: Job, n_agents: int, obs_dim: int, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return ref_sac.init_params(n_agents, obs_dim, 1, job.hidden, g, device)


def build(cell, seed: int, root: str, device, mark=lambda name: None):
    """The district, the trainer with the benchmark's weights, and those
    weights."""
    from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

    mark("program import")
    job = Job.of(cell.traffic)
    schema = write_district(cell.config, seed, root)
    mark("district written")
    cfg = TrainConfig(n_districts=job.n_districts, hidden=job.hidden, batch_size=job.batch_size,
                      replay_capacity=job.n_districts * job.replay_slots,
                      warmup_steps=job.warmup_steps, collect="kernel",
                      collect_chunk=job.chunk, lr=job.lr, discount=job.discount, tau=job.tau,
                      alpha=job.alpha, reward_scale=job.reward_scale)
    tr = BatchedSAC(schema, cfg, seed=seed, device=device,
                    episode_time_steps=job.episode_time_steps)
    mark("trainer built")
    nets = seeded_nets(job, tr.env_cfg.n_buildings, tr.obs_dim, seed, tr.device)
    with torch.no_grad():
        for name in NETS:
            for leaf, p in getattr(tr.state.nets, name).named_parameters():
                p.copy_(nets[name][leaf])
        for name in ("q1", "q2"):
            for leaf, p in getattr(tr.state.nets, f"{name}_target").named_parameters():
                p.copy_(nets[name][leaf])
    return job, schema, tr, nets


@dataclass
class Chunk:
    """One collect chunk of the program's: its start (step count, episode
    position, window offsets, battery state, the policy's weights) and
    what it wrote (replay rewards, actions and done flags) and left (the
    state after it, the reset included)."""
    kc: int
    first: bool
    reset: bool
    t0: int
    t: int
    offset: torch.Tensor
    state: tuple
    policy: Dict[str, torch.Tensor]
    rewards: torch.Tensor = None
    actions: torch.Tensor = None
    done: torch.Tensor = None
    after_offset: torch.Tensor = None
    after_t: torch.Tensor = None
    after_state: tuple = None


@dataclass
class ProgramRecord:
    losses: List[List[Dict[str, torch.Tensor]]] = field(default_factory=list)
    first_grads: Dict[str, Dict[str, torch.Tensor]] = None
    after: Dict[str, Dict[str, torch.Tensor]] = None
    first_rewards: torch.Tensor = None
    first_actions: torch.Tensor = None
    first_state: tuple = None
    boundary: Optional[List[Chunk]] = field(default_factory=list)


def _battery(es) -> tuple:
    return tuple(x.clone() for x in (es.battery_soc, es.battery_efficiency,
                                     es.battery_degraded_capacity))


class BoundaryRecorder:
    """Wraps the trainer's ``_collect_chunk`` to record the chunk that ends
    the first episode it sees end and the chunk after it. Recording clones
    a few tensors on the card and reads no value on the host."""

    def __init__(self, tr, rec: ProgramRecord):
        self.tr, self.rec = tr, rec

    @property
    def done(self) -> bool:
        return len(self.rec.boundary) == 2

    def __enter__(self):
        tr, rec = self.tr, self.rec
        shipped = tr._collect_chunk

        def collect(kc, first_chunk, do_reset):
            if self.done or not (do_reset or rec.boundary):
                return shipped(kc, first_chunk, do_reset)
            ts = tr.state
            es = ts.env_state
            chunk = Chunk(kc, bool(first_chunk), bool(do_reset), int(ts.step), tr._phase,
                          es.data_offset.clone(), _battery(es),
                          {k: p.detach().clone() for k, p in ts.nets.policy.named_parameters()})
            slot = ts.replay_pos
            out = shipped(kc, first_chunk, do_reset)
            slots = (slot + torch.arange(kc, device=tr.device)) % ts.replay_done.shape[0]
            es = ts.env_state
            chunk.rewards, chunk.actions = ts.replay_rew[slots].clone(), ts.replay_act[slots].clone()
            chunk.done = ts.replay_done[slots].clone()
            chunk.after_offset, chunk.after_t = es.data_offset.clone(), es.t.clone()
            chunk.after_state = _battery(es)
            rec.boundary.append(chunk)
            return out

        tr._collect_chunk = collect
        return self

    def __exit__(self, *exc):
        del self.tr._collect_chunk


def first_calls(tr, job: Job) -> ProgramRecord:
    """The trainer's first calls through the window's own ``train``, with
    its losses and first Adam state recorded."""
    import citylearn_tpu_torch.train as train_mod

    rec = ProgramRecord()
    shipped = train_mod.sac_update
    nets = tr.state.nets

    def recorded(*args, **kw):
        out = shipped(*args, **kw)
        rec.losses[-1].append({k: v.detach().clone() for k, v in out.items()})
        if rec.first_grads is None:
            rec.first_grads = {
                name: {leaf: getattr(nets, f"{name}_opt").state[p]["exp_avg"] / (1 - ref_sac.BETA1)
                       for leaf, p in getattr(nets, name).named_parameters()
                       if p in getattr(nets, f"{name}_opt").state}
                for name in NETS}
        return out

    train_mod.sac_update = recorded
    try:
        for call in range(FIRST_CALLS):
            rec.losses.append([])
            tr.train(job.chunk, chunk=job.chunk)
            if call == 0:
                ts = tr.state
                rec.first_rewards = ts.replay_rew[:job.chunk].clone()
                rec.first_actions = ts.replay_act[:job.chunk].clone()
                rec.first_state = _battery(ts.env_state)
    finally:
        train_mod.sac_update = shipped
    rec.after = {name: {leaf: p.detach().clone() for leaf, p in
                        getattr(nets, name).named_parameters()} for name in NETS}
    return rec


# --- the comparison ----------------------------------------------------------

def _leaf_norms(tree) -> Dict[str, float]:
    return {f"{n}/{leaf}": float(torch.linalg.vector_norm(x.double()))
            for n, leaves in tree.items() for leaf, x in leaves.items()}


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float], keys, what: str) -> float:
    """The worst leaf's gap of norms, against the larger of the reference
    leaf's norm and the median leaf's (the leaf named on standard error)."""
    keys = list(keys)
    if not keys:
        return float("nan")
    median = sorted(ref[k] for k in keys)[len(keys) // 2]
    gap, leaf = max((abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30), k) for k in keys)
    print(f"{what}: worst leaf {leaf} (program {prog.get(leaf, 0.0):.9g}, reference "
          f"{ref[leaf]:.9g}, median leaf {median:.9g})", file=sys.stderr)
    return gap


def _elem_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double()
    if p.shape != r.shape:
        return float("inf")
    return float((p - r).abs().max() / r.abs().mean().clamp(min=1e-30))


def _loss_gap(prog, ref) -> float:
    worst = 0.0
    for p_call, r_call in zip(prog, ref):
        if len(p_call) != len(r_call) or not r_call:
            return float("inf")
        for kinds in (("q1", "q2"), ("policy",)):
            stack = lambda call: torch.stack([torch.stack([u[k].double() for k in kinds])
                                              for u in call])
            p, r = stack(p_call), stack(r_call)
            scale = float(r.abs().mean().clamp(min=1e-30))
            worst = max(worst, float((p.mean() - r.mean()).abs()) / scale)
    return worst


def _mismatches(p: torch.Tensor, r) -> int:
    r = torch.as_tensor(r, device=p.device).expand_as(p)
    return int((p.double() != r.double()).sum())


def boundary_readings(chunks: List[Chunk], ref: ReferenceTrainer) -> Dict[str, float]:
    """The two recorded chunks against the reference's following of them
    (NaN where the window recorded none). ``state_gap`` here, the battery
    state after the chunk that starts the new episode, is printed and not
    compared: it carries the policy's action gaps through 49 steps, to
    within 2x of the control's reading after the first call."""
    if len(chunks) != 2:
        return {k: float("nan") for k in ("reward_gap", "action_gap", "state_gap", "reset_gap")}
    out = {"reward_gap": 0.0, "action_gap": 0.0, "reset_gap": 0}
    for c in chunks:
        r = ref.follow(c)
        out["reward_gap"] = max(out["reward_gap"], _elem_gap(c.rewards, r["rewards"]))
        out["action_gap"] = max(out["action_gap"], _elem_gap(c.actions, r["actions"]))
        out["reset_gap"] += _mismatches(c.done, r["done"])
        if c.reset:
            out["reset_gap"] += (_mismatches(c.after_offset, r["offset"])
                                 + _mismatches(c.after_t, r["t"])
                                 + sum(_mismatches(p, q) for p, q in zip(c.after_state, r["state"])))
        else:
            out["state_gap"] = max(_elem_gap(p, q) for p, q in zip(c.after_state, r["state"]))
    out.setdefault("state_gap", float("nan"))
    return out


def readings(rec: ProgramRecord, ref: ReferenceTrainer, nets) -> Dict[str, float]:
    r_grads = _leaf_norms(ref.agents.first_grads)
    p_grads = _leaf_norms(rec.first_grads or {})
    median = sorted(r_grads.values())[len(r_grads) // 2]
    moved = [k for k, v in r_grads.items() if v >= 1e-3 * median]
    change = lambda after: _leaf_norms({n: {leaf: after[n][leaf] - nets[n][leaf]
                                            for leaf in nets[n]} for n in NETS})
    rr = ref.record
    out = {
        "loss_gap": _loss_gap(rec.losses, rr.losses),
        "grad_gap": _norm_gap(p_grads, r_grads, r_grads, "grad_gap"),
        "change_gap": _norm_gap(change(rec.after), change(ref.agents.trained()), moved,
                                "change_gap"),
        "reward_gap": _elem_gap(rec.first_rewards, rr.first_rewards),
        "action_gap": _elem_gap(rec.first_actions, rr.first_actions),
        "state_gap": max(_elem_gap(p, r) for p, r in zip(rec.first_state, rr.first_state)),
    }
    if rec.boundary is None:
        return out
    b = boundary_readings(rec.boundary, ref)
    print("first call: " + ", ".join(f"{k} {out[k]!r}" for k in ("reward_gap", "action_gap",
                                                                 "state_gap"))
          + "; episode's end: " + ", ".join(f"{k} {v!r}" for k, v in b.items())
          + " (its state_gap not compared)", file=sys.stderr)
    for k in ("reward_gap", "action_gap"):
        out[k] = max(out[k], b[k]) if b[k] == b[k] else b[k]
    out["reset_gap"] = b["reset_gap"]
    return out


def reference_record(schema, job, seed, nets, device, precision="fp32", fault=None):
    """The reference's first calls (the control: ``precision='tf32'``)."""
    _no_tf32()
    ref = ReferenceTrainer(schema, job, seed, nets, device, precision, fault)
    for _ in range(FIRST_CALLS):
        ref.train_call()
    return ref


def as_program_record(ref: ReferenceTrainer) -> ProgramRecord:
    """A reference run in the program's place (the control and the faults
    planted in the reference): its first calls only, no episode's end."""
    rr = ref.record
    return ProgramRecord(losses=rr.losses, first_grads=ref.agents.first_grads,
                         after=ref.agents.trained(), first_rewards=rr.first_rewards,
                         first_actions=rr.first_actions, first_state=rr.first_state,
                         boundary=None)


# --- the window ------------------------------------------------------------------

def _sync(tr):
    return (lambda: torch.cuda.synchronize(tr.device)) if tr.device.type == "cuda" else (lambda: None)


def window(tr, job: Job, seconds: float):
    """Train calls until ``seconds`` have passed; the last call begun
    before then is finished and timed. Returns (calls, seconds)."""
    sync = _sync(tr)
    sync()
    t0 = time.perf_counter()
    deadline, calls, last, times = t0 + seconds, 0, t0, []
    while last < deadline:
        tr.train(job.chunk, chunk=job.chunk)
        calls += 1
        now = time.perf_counter()
        times.append(now - last)
        last = now
    sync()
    elapsed = time.perf_counter() - t0
    times.sort()
    if times:
        print(f"window: {calls} calls in {elapsed:.3f} s; a call {times[0]:.4f} / "
              f"{times[len(times) // 2]:.4f} / {times[-1]:.4f} s (least / median / most)",
              file=sys.stderr)
    return calls, elapsed


def traced_window(tr, job: Job, seconds: float, run: harness.Run, trace_calls: int):
    """The traced run's window, in three stretches: ``trace_calls`` calls
    under the device trace (what ``k2_roofline`` and the device's idle
    share read; the host is timed only at the spans' edges, with no
    synchronize); half of ``seconds`` of plain calls, whose work and time
    ``mfu.train`` reads; and the other half with spans around the update
    and the collect, each ending in a synchronize, which the layers' times
    read. Returns (calls, seconds of all three)."""
    import citylearn_tpu_torch.train as train_mod

    cuda = tr.device.type == "cuda"
    sync = _sync(tr)
    A, K, M = tr.env_cfg.n_buildings, tr.obs_dim, tr.act_dim
    update_flops = counts.sac_update_flops(A, K, M, job.hidden, job.batch_size)
    policy_flops = counts.policy_forward_flops(A, K, M, job.hidden)
    shipped_k2, shipped_policy = train_mod.battery_collect_chunk, tr._policy_actions
    shipped_update = tr._update
    counting = [False]
    launches = []        # K2's shapes and its charging count, read after the stretch

    def k2(prep, actions, *args, **kw):
        if counting[0] or run.info.get("profiling"):
            launches.append((tuple(actions.shape), prep.curves[0].shape[0], (actions >= 0).sum(),
                             bool(run.info.get("profiling"))))
        return shipped_k2(prep, actions, *args, **kw)

    def policy(obs, noise):
        if counting[0]:
            run.add("flops", policy_flops * obs.shape[0])
        return shipped_policy(obs, noise)

    def update(*args, **kw):
        if counting[0]:
            run.add("flops", update_flops)
        return shipped_update(*args, **kw)

    def k2_counts():
        for (Kc, D, B), n_knots, charging, profiled in launches:
            ops = counts.k2_operations(Kc, D, B, n_knots, int(charging))
            if profiled:
                run.info.setdefault("k2_launches", []).append(
                    (ops, counts.k2_bytes(Kc, D, B, n_knots)))
            else:
                run.add("flops", ops)
        launches.clear()

    def calls_for(s: float):
        sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() < t0 + s:
            tr.train(job.chunk, chunk=job.chunk)
            n += 1
        sync()
        return n, time.perf_counter() - t0

    named = [(tr, "_collect_chunk", "collect_chunk"), (tr, "_update", "sac_update")]
    train_mod.battery_collect_chunk = k2
    tr._policy_actions, tr._update = policy, update
    try:
        calls, elapsed = 0, 0.0
        if trace_calls and cuda:
            run.info["profiling"] = True
            sync()
            t0 = time.perf_counter()
            with harness.spans(run, named), harness.device_trace(run, tr.device.index or 0):
                for _ in range(trace_calls):
                    tr.train(job.chunk, chunk=job.chunk)
            calls, elapsed = trace_calls, time.perf_counter() - t0
            run.info.update(profiling=False, traced_calls=trace_calls)
        counting[0] = True
        n, s = calls_for(seconds / 2)
        counting[0] = False
        k2_counts()
        run.info.update(plain_calls=n, window_s=s)
        calls, elapsed = calls + n, elapsed + s
        with harness.spans(run, named, sync):
            n, s = calls_for(seconds / 2)
        calls, elapsed = calls + n, elapsed + s
    finally:
        train_mod.battery_collect_chunk = shipped_k2
        del tr._policy_actions, tr._update
    return calls, elapsed


def run_cell(cell, seed: int, seconds: float, trace: bool, device, fault=None) -> dict:
    """The whole run: set-up, window, and the comparison. Returns the
    values, checks and readings that the result line needs."""
    _no_tf32()
    started = harness.process_start()
    root = tempfile.mkdtemp(prefix="bench-district-")
    try:
        phases = [("start", started)]
        mark = lambda name: phases.append((name, harness.boottime()))
        mark("imports")
        job, schema, tr, nets = build(cell, seed, root, device, mark)
        if fault is not None:
            fault()
        rec = first_calls(tr, job)
        mark("first calls")
        setup_s = harness.boottime() - started
        harness.log_phases(phases)
        run = harness.Run()
        with BoundaryRecorder(tr, rec) as boundary:
            if trace:
                calls, elapsed = traced_window(tr, job, seconds, run,
                                               int(cell.traffic.get("trace_calls", 2)))
            else:
                calls, elapsed = window(tr, job, seconds)
            peak = torch.cuda.max_memory_allocated(tr.device) if tr.device.type == "cuda" else 0
            late = 0
            while not boundary.done:
                # the episode's end was not yet due in the window: its
                # chunks are still recorded, untimed
                tr.train(job.chunk, chunk=job.chunk)
                late += 1
        if late:
            print(f"the episode's end came {late} call(s) after the window", file=sys.stderr)
        dev = tr.device
        del tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_record(schema, job, seed, nets, dev)
        return {"setup_s": setup_s, "calls": calls, "elapsed": elapsed, "peak": peak,
                "train_dsteps_per_s": calls * job.chunk * job.n_districts / elapsed,
                "run": run, "readings": readings(rec, ref, nets)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(cell, seed: int, seconds: float, trace: bool) -> int:
    out = run_cell(cell, seed, seconds, trace, torch.device("cuda:0"))
    run = out["run"]
    dev = harness.device_info(cell.chips, out["peak"])
    if trace:
        dev["busy_s"] = run.busy_s()
        dev["window_s"] = run.trace_window[1] - run.trace_window[0]
    metrics = {"setup_s": out["setup_s"], "train_dsteps_per_s": out["train_dsteps_per_s"]}
    return harness.emit(cell, metrics, run, trace, dev,
                        harness.checks(out["readings"], cell.traffic["limits"]), out["calls"], 0)
