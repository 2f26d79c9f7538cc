"""Batched SAC training on the per-step collect path: ``BatchedSAC.train(K,
chunk=K)`` on ``collect="scan"`` called back to back on one card, on an
LSTM-dynamics district. Every step runs the stepped ``district_step`` (the
partial-load heat pump, the DHW heater and tank, the battery, the LSTM's
indoor temperature and the ComfortReward) for every district, then one
SAC update.

Set-up writes the seeded district, builds the trainer, loads the
benchmark's seeded weights into it and runs its first three train calls
(which also warm up every shape the window uses, the update's CUDA graph
included) while recording what the comparison reads. The window then calls
``train`` until ``--seconds`` have passed and closes at the end of the last
call begun before then. The call that crosses the first episode's end is
recorded with the trainer's whole state at its start (in the window, or
past its close, untimed, until it comes).

After the window the reference (``benchmark/reference/train_scan.py``)
follows the same three calls from the same inputs, and the recorded call
from the program's recorded start, each forced on the program's actions:
under a policy that changes every step two float32 trainers drift apart
(Adam makes a gradient element's rounding near zero a whole step of the
learning rate, and the next actions follow), so each step's action is
held to what the program's own policy of that step gives, and the
districts, the LSTM and the learner to the reference on those actions.
The numbers below are compared, each with its limit from the traffic file:

- ``loss_gap``: each call's mean critic and actor loss over its updates,
  the three calls' and the recorded call's;
- ``grad_gap``: the norm of each leaf's first gradient, read from the
  program's Adam state after one update (``exp_avg / (1 - beta1)``);
- ``change_gap``: the norm of each leaf's change over the three calls;
- ``temperature_gap``: the LSTM's indoor temperature of every step of the
  three calls and of the recorded call;
- ``reward_gap``: every reward the first call and the recorded call wrote
  to the replay, against the reference's ComfortReward of the program's
  own temperature at that step (the reward steps at its band's edges: a
  temperature within rounding of an edge may fall on either side, so the
  temperature is compared above and the reward from it here);
- ``action_gap``: the actions the first call and the recorded call wrote,
  against the reference's sample of the program's policy of each step,
  with the step's drawn noise;
- ``state_gap``: after the first call and after the recorded one, the
  battery's state of charge, efficiency and capacity, the DHW tank's state
  of charge, the LSTM's hidden state ``h`` and ``c`` and its window of
  normalized channels;
- ``reset_gap``: the elements that differ at the episode's end, which
  must be none: the recorded call's done flags, and the state the reset
  starts from (window offsets, battery, tank, a zero LSTM state).
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import harness
from benchmark.entries.sac_train import (
    FIRST_CALLS,
    NETS,
    _elem_gap,
    _leaf_norms,
    _loss_gap,
    _mismatches,
    _no_tf32,
    _norm_gap,
    _sync,
    window,
)
from benchmark.frozen import synthetic
from benchmark.reference import lstm_district
from benchmark.reference import sac as ref_sac
from benchmark.reference.train import Job
from benchmark.reference.train_scan import Record, ReferenceScanTrainer, policy_actions

STATE_KEYS = ("soc", "eff", "deg", "dhw_soc", "h", "c", "window")
RESET_KEYS = ("offset", "t", "soc", "eff", "deg", "dhw_soc", "h", "c", "window")


def write_district(config: dict, seed: int, root: str) -> str:
    """The seeded LSTM district of the configuration's shape; its schema
    must hold the observations and actions the configuration states."""
    lstm = config["lstm"]
    path = getattr(synthetic, config["writer"])(
        root, n_buildings=config["n_buildings"], n_rows=config["n_rows"], seed=seed % 2 ** 32,
        hidden_size=lstm["hidden_size"], num_layers=lstm["num_layers"],
        lookback=lstm["lookback"])
    with open(path) as f:
        schema = json.load(f)
    active = lambda key: [k for k, v in schema[key].items() if v["active"]]
    if active("observations") != config["observations"] or \
            sorted(active("actions")) != sorted(config["actions"]):
        raise ValueError("the written schema's observations or actions are not the "
                         "configuration's")
    return path


def seeded_nets(job: Job, A: int, K: int, M: int, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return ref_sac.init_params(A, K, M, job.hidden, g, device)


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
                      warmup_steps=job.warmup_steps, collect="scan",
                      collect_chunk=job.chunk, lr=job.lr, discount=job.discount, tau=job.tau,
                      alpha=job.alpha, reward_scale=job.reward_scale)
    tr = BatchedSAC(schema, cfg, seed=seed, device=device,
                    episode_time_steps=job.episode_time_steps)
    mark("trainer built")
    nets = seeded_nets(job, tr.env_cfg.n_buildings, tr.obs_dim, tr.act_dim, seed, tr.device)
    with torch.no_grad():
        for name in NETS:
            for leaf, p in getattr(tr.state.nets, name).named_parameters():
                p.copy_(nets[name][leaf])
        for name in ("q1", "q2"):
            for leaf, p in getattr(tr.state.nets, f"{name}_target").named_parameters():
                p.copy_(nets[name][leaf])
    return job, schema, tr, nets


# --- the program's state in the reference's layout -----------------------------------

def district_state(es) -> Dict[str, torch.Tensor]:
    """An :class:`EnvState` of the program's as
    :func:`benchmark.reference.train_scan.state_of` lays it out (one LSTM
    group holds every building, in building order)."""
    return {"offset": es.data_offset.long().clone(), "t": es.t[0].long().cpu().clone(),
            "soc": es.battery_soc.clone(), "eff": es.battery_efficiency.clone(),
            "deg": es.battery_degraded_capacity.clone(), "dhw_soc": es.dhw_storage_soc.clone(),
            "h": es.lstm_h[0].permute(1, 2, 0, 3).clone(),
            "c": es.lstm_c[0].permute(1, 2, 0, 3).clone(),
            "window": es.dyn_input[0].permute(1, 0, 3, 2).clone()}


def trainer_start(tr) -> dict:
    """Everything a call of the trainer starts from, for
    :meth:`ReferenceScanTrainer.resumed`."""
    ts, nets = tr.state, tr.state.nets
    leaves = lambda net: {k: p.detach().clone() for k, p in net.named_parameters()}
    adam = {}
    for name in NETS:
        opt = getattr(nets, f"{name}_opt")
        adam[name] = {leaf: (opt.state[p]["step"].clone(), opt.state[p]["exp_avg"].clone(),
                             opt.state[p]["exp_avg_sq"].clone())
                      for leaf, p in getattr(nets, name).named_parameters() if p in opt.state}
    s = district_state(ts.env_state)
    state = lstm_district.State(offset=s["offset"], t=int(s["t"]), soc=s["soc"], eff=s["eff"],
                                deg=s["deg"], dhw_soc=s["dhw_soc"], h=s["h"], c=s["c"],
                                window=s["window"])
    return {"nets": {n: leaves(getattr(nets, n)) for n in NETS},
            "targets": {n: leaves(getattr(nets, f"{n}_target")) for n in ("q1", "q2")},
            "adam": adam,
            "replay": tuple(x.clone() for x in (ts.replay_obs, ts.replay_act, ts.replay_rew,
                                                ts.replay_next, ts.replay_done)),
            "pos": ts.replay_pos, "full": ts.replay_full, "step": ts.step, "phase": tr._phase,
            "state": state}


class Steps:
    """What the program's steps record while a :func:`stepped` block is
    open: each step's indoor temperature, its policy before the step's
    action (if asked), and each reset's new state."""

    def __init__(self, policies: bool = False):
        self.temperature: List[torch.Tensor] = []
        self.policies: List[Dict[str, torch.Tensor]] = [] if policies else None
        self.resets: List[Dict[str, torch.Tensor]] = []


@contextlib.contextmanager
def stepped(tr, steps: Steps):
    """Record into ``steps`` by wrapping the program's own ``district_step``
    (its output's indoor temperature; the policy it acted with, which the
    step's update has not yet changed) and ``_broadcast_initial``; clones
    on the card, no value read."""
    import citylearn_tpu_torch.train as train_mod

    shipped_step, shipped_reset = train_mod.district_step, tr._broadcast_initial

    def step(*args, **kw):
        if steps.policies is not None:
            steps.policies.append({k: p.detach().clone()
                                   for k, p in tr.state.nets.policy.named_parameters()})
        state, out = shipped_step(*args, **kw)
        steps.temperature.append(out.indoor_temperature.clone())
        return state, out

    def reset(offsets):
        st = shipped_reset(offsets)
        steps.resets.append(district_state(st))
        return st

    train_mod.district_step, tr._broadcast_initial = step, reset
    try:
        yield
    finally:
        train_mod.district_step = shipped_step
        del tr._broadcast_initial


def written(ts, slot: int, n: int, name: str) -> torch.Tensor:
    """The ``n`` replay rows of buffer ``name`` written from ``slot`` on."""
    buf = getattr(ts, name)
    return buf[(slot + torch.arange(n, device=buf.device)) % buf.shape[0]].clone()


def first_calls(tr, job: Job) -> Record:
    """The trainer's first calls through the window's own ``train``, with
    their losses, first Adam state, actions and temperatures, and the
    first call's rewards, policies and state, recorded."""
    import citylearn_tpu_torch.train as train_mod

    rec, actions = Record(), []
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
    temperature = []
    try:
        for call in range(FIRST_CALLS):
            rec.losses.append([])
            steps, slot = Steps(policies=call == 0), tr.state.replay_pos
            with stepped(tr, steps):
                tr.train(job.chunk, chunk=job.chunk)
            ts = tr.state
            actions.append(written(ts, slot, job.chunk, "replay_act"))
            temperature += steps.temperature
            if call == 0:
                rec.rewards = written(ts, slot, job.chunk, "replay_rew")
                rec.policies = steps.policies
                rec.state = district_state(ts.env_state)
    finally:
        train_mod.sac_update = shipped
    rec.actions, rec.temperature = torch.cat(actions), torch.stack(temperature)
    rec.after = {name: {leaf: p.detach().clone() for leaf, p in
                        getattr(nets, name).named_parameters()} for name in NETS}
    return rec


class BoundaryRecorder:
    """Wraps the trainer's ``train`` to record the first call that crosses
    an episode's end: the trainer's whole state at its start, the rewards,
    actions and done flags it wrote, its losses, temperatures and policies,
    and the reset's new state. Recording clones on the card and reads the
    episode position from the card at the call's start and end."""

    def __init__(self, tr):
        self.tr, self.call = tr, None

    @property
    def done(self) -> bool:
        return self.call is not None

    def __enter__(self):
        import citylearn_tpu_torch.train as train_mod

        tr = self.tr
        shipped = tr.train
        S_ep = tr.env_cfg.time_steps - 1

        def train(n_steps, chunk=200):
            if self.done or tr._phase + n_steps < S_ep:
                return shipped(n_steps, chunk=chunk)
            ts = tr.state
            call = {"start": trainer_start(tr), "losses": []}
            slot, steps = ts.replay_pos, Steps(policies=True)
            shipped_update = train_mod.sac_update

            def update(*args, **kw):
                out = shipped_update(*args, **kw)
                call["losses"].append({k: v.detach().clone() for k, v in out.items()})
                return out

            train_mod.sac_update = update
            try:
                with stepped(tr, steps):
                    out = shipped(n_steps, chunk=chunk)
            finally:
                train_mod.sac_update = shipped_update
            call.update(rewards=written(ts, slot, n_steps, "replay_rew"),
                        actions=written(ts, slot, n_steps, "replay_act"),
                        done=written(ts, slot, n_steps, "replay_done"),
                        temperature=torch.stack(steps.temperature), policies=steps.policies,
                        resets=steps.resets, after=district_state(ts.env_state))
            self.call = call
            return out

        tr.train = train
        return self

    def __exit__(self, *exc):
        del self.tr.train


# --- the comparison ----------------------------------------------------------------

def reward_gap(rewards: torch.Tensor, temperature: torch.Tensor,
               steps: List[Dict[str, torch.Tensor]], ref: ReferenceScanTrainer) -> float:
    """Rewards (K, D, B) against the reference's ComfortReward, scaled, of
    the same steps' temperatures (K, D, B), at the reference's steps' data
    rows and heating flags."""
    expected = torch.stack([lstm_district.comfort(ref.district, s["rows"], t, s["heating"])
                            for s, t in zip(steps, temperature)]) * ref.job.reward_scale
    return _elem_gap(rewards, expected)


def action_gap(actions: torch.Tensor, policies, steps, ref: ReferenceScanTrainer) -> float:
    """Actions (K, D, B, M) against what the recorded policies, one a step,
    take at the reference's steps."""
    return _elem_gap(actions, policy_actions(ref, policies, steps))


def boundary_readings(call: dict, schema: str, job: Job, seed: int, device) -> Dict[str, float]:
    """The recorded call against the reference's following of it from the
    program's recorded start, on the program's actions (NaN where the run
    recorded none)."""
    keys = ("loss_gap", "reward_gap", "action_gap", "temperature_gap", "reset_gap")
    if call is None:
        return {k: float("nan") for k in keys}
    n = call["actions"].shape[0]
    ref = ReferenceScanTrainer.resumed(schema, job, seed, call["start"], device,
                                       actions=list(call["actions"]))
    ref.train_call()
    steps = ref.steps[-n:]
    out = {"loss_gap": _loss_gap([call["losses"]], ref.record.losses[-1:]),
           "reward_gap": reward_gap(call["rewards"], call["temperature"], steps, ref),
           "action_gap": action_gap(call["actions"], call["policies"], steps, ref),
           "temperature_gap": _elem_gap(call["temperature"], ref.stacked("temperature", n)),
           "reset_gap": _mismatches(call["done"], ref.stacked("done", n).to(device)[:, None])}
    if len(call["resets"]) != len(ref.record.resets) or not call["resets"]:
        out["reset_gap"] += 1
    for p, r in zip(call["resets"], ref.record.resets):
        out["reset_gap"] += sum(_mismatches(p[k], r[k].to(p[k].device)) for k in RESET_KEYS)
    end = {k: _elem_gap(call["after"][k], getattr(ref.state, k))
           for k in ("soc", "dhw_soc", "h", "c", "window")}
    print("episode's end: " + ", ".join(f"{k} {v!r}" for k, v in out.items())
          + "; the state after the call: " + ", ".join(f"{k} {v!r}" for k, v in end.items()),
          file=sys.stderr)
    out["state_gap"] = max(end.values())
    return out


def readings(rec: Record, ref: ReferenceScanTrainer, nets, boundary: Dict[str, float] = None
             ) -> Dict[str, float]:
    """``rec`` (the program's, or a reference run in its place) against
    ``ref``, the reference forced on ``rec``'s actions."""
    r_grads = _leaf_norms(ref.agents.first_grads)
    p_grads = _leaf_norms(rec.first_grads or {})
    median = sorted(r_grads.values())[len(r_grads) // 2]
    moved = [k for k, v in r_grads.items() if v >= 1e-3 * median]
    change = lambda after: _leaf_norms({n: {leaf: after[n][leaf] - nets[n][leaf]
                                            for leaf in nets[n]} for n in NETS})
    K = ref.job.chunk
    first = ref.steps[:K]
    out = {
        "loss_gap": _loss_gap(rec.losses, ref.record.losses),
        "grad_gap": _norm_gap(p_grads, r_grads, r_grads, "grad_gap"),
        "change_gap": _norm_gap(change(rec.after), change(ref.agents.trained()), moved,
                                "change_gap"),
        "temperature_gap": _elem_gap(rec.temperature, ref.record.temperature),
        "reward_gap": reward_gap(rec.rewards, rec.temperature[:K], first, ref),
        "action_gap": action_gap(rec.actions[:K], rec.policies, first, ref),
        "state_gap": max(_elem_gap(rec.state[k], ref.record.state[k]) for k in STATE_KEYS),
    }
    if boundary is None:
        return out
    print("first calls: " + ", ".join(f"{k} {out[k]!r}" for k in out), file=sys.stderr)
    for k in ("loss_gap", "reward_gap", "action_gap", "temperature_gap", "state_gap"):
        out[k] = max(out[k], boundary[k]) if boundary[k] == boundary[k] else boundary[k]
    out["reset_gap"] = boundary["reset_gap"]
    return out


def reference_run(schema, job, seed, nets, device, precision="fp32", fault=None, actions=None):
    """The reference's first calls, forced on ``actions`` where given (the
    control: ``precision='tf32'``)."""
    _no_tf32()
    ref = ReferenceScanTrainer(schema, job, seed, nets, device, precision, fault,
                               actions=None if actions is None else list(actions))
    for _ in range(FIRST_CALLS):
        ref.train_call()
    return ref


def as_program_record(ref: ReferenceScanTrainer) -> Record:
    """A reference run in the program's place (the control and the faults
    planted in the reference): its first calls only, no episode's end."""
    rr = ref.record
    return Record(losses=rr.losses, first_grads=ref.agents.first_grads,
                  after=ref.agents.trained(), rewards=rr.rewards, actions=rr.actions,
                  policies=rr.policies, temperature=rr.temperature, state=rr.state)


# --- the window --------------------------------------------------------------------

@contextlib.contextmanager
def synced(run: harness.Run, targets, sync):
    """Wrap ``getattr(obj, attr)`` for each (obj, attr, span): every call
    is timed from a synchronize before it to one after it, into
    ``run.spans``, so that each layer's time is its own work on the card."""
    saved = []
    for obj, attr, name in targets:
        fn, times = getattr(obj, attr), run.spans.setdefault(name, [])

        def wrapped(*args, _fn=fn, _times=times, **kw):
            sync()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            sync()
            _times.append(time.perf_counter() - t0)
            return out

        saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def traced_window(tr, job: Job, seconds: float, run: harness.Run, trace_calls: int):
    """The traced run's window, in two stretches: ``trace_calls`` calls
    under the device trace, with the host's edges of each
    ``district_step``, its ``dynamics_update`` and each update kept
    (what ``step_launches.scan`` and ``device_idle.scan`` read; nothing
    synchronizes); then calls for ``seconds`` with each of the three timed
    to its completion on the card between two synchronizes (what
    ``district_step_ms.scan``, ``dynamics_ms.scan`` and
    ``sac_update_ms.scan`` read). Returns (calls, seconds of both)."""
    import citylearn_tpu_torch.core.step as step_mod
    import citylearn_tpu_torch.train as train_mod

    sync = _sync(tr)
    edges = [(train_mod, "district_step", "district_step"),
             (step_mod, "dynamics_update", "dynamics_update"), (tr, "_update", "scan_update")]
    calls, elapsed = 0, 0.0
    if trace_calls and tr.device.type == "cuda":
        sync()
        t0 = time.perf_counter()
        with harness.spans(run, edges), harness.device_trace(run, tr.device.index or 0):
            for _ in range(trace_calls):
                tr.train(job.chunk, chunk=job.chunk)
        calls, elapsed = trace_calls, time.perf_counter() - t0
    with synced(run, edges, sync):
        sync()
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            tr.train(job.chunk, chunk=job.chunk)
            calls += 1
        sync()
    return calls, elapsed + time.perf_counter() - t0


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
        with BoundaryRecorder(tr) as boundary:
            if trace:
                calls, elapsed = traced_window(tr, job, seconds, run,
                                               int(cell.traffic.get("trace_calls", 1)))
            else:
                calls, elapsed = window(tr, job, seconds)
            peak = torch.cuda.max_memory_allocated(tr.device) if tr.device.type == "cuda" else 0
            late = 0
            while not boundary.done:
                # the episode's end was not yet due in the window: its
                # call is still recorded, untimed
                tr.train(job.chunk, chunk=job.chunk)
                late += 1
        if late:
            print(f"the episode's end came {late} call(s) after the window", file=sys.stderr)
        dev, call = tr.device, boundary.call
        del tr, boundary
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        b = boundary_readings(call, schema, job, seed, dev)
        del call
        ref = reference_run(schema, job, seed, nets, dev, actions=rec.actions)
        return {"setup_s": setup_s, "calls": calls, "elapsed": elapsed, "peak": peak,
                "train_dsteps_per_s": calls * job.chunk * job.n_districts / elapsed,
                "run": run, "readings": readings(rec, ref, nets, b)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(cell, seed: int, seconds: float, trace: bool) -> int:
    out = run_cell(cell, seed, seconds, trace, torch.device("cuda:0"))
    run = out["run"]
    dev = harness.device_info(cell.chips, out["peak"])
    if trace:
        dev["busy_s"] = run.busy_s() if run.trace_window else 0.0
        dev["window_s"] = run.trace_window[1] - run.trace_window[0] if run.trace_window else 0.0
    metrics = {"setup_s": out["setup_s"], "train_dsteps_per_s": out["train_dsteps_per_s"]}
    return harness.emit(cell, metrics, run, trace, dev,
                        harness.checks(out["readings"], cell.traffic["limits"]), out["calls"], 0)
