"""The Gym env stepped by a user's loop: a ``CityLearnEnv`` on the
district, ``reset()``, then ``step`` with per-building action lists through
the year, ``evaluate_rows()`` at the episode's end, ``reset()`` and on into
the next episode, until ``--seconds`` have passed.

The actions are drawn from the seed once, uniform in each building's
action space, one row a step of the episode, and every episode replays
them; set-up steps the env ``warmup_steps`` times and evaluates and resets
it, so that every path of the window has run. After the window the
reference works out the episode from the dataset files and the same
actions, and these are compared, each with its limit from the traffic
file:

- ``obs_gap``: every observation the window returned, against the largest
  magnitude of its column in the episode;
- ``reward_gap``: every reward the window returned, against the mean
  magnitude;
- ``kpi_gap``: the energy KPIs of the first episode's ``evaluate_rows()``.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness
from benchmark.entries.sac_train import write_district
from benchmark.reference import district as district_model
from benchmark.reference import env as ref_env


def draw_actions(env, seed: int, n_steps: int) -> List[list]:
    """(n_steps) per-building action lists, uniform in the action space."""
    rng = np.random.default_rng(seed)
    lows = np.concatenate([np.asarray(s.low, np.float64) for s in env.action_space])
    highs = np.concatenate([np.asarray(s.high, np.float64) for s in env.action_space])
    a = (lows + rng.random((n_steps, lows.size)) * (highs - lows)).astype(np.float32)
    return [[row[i:i + 1] for i in range(lows.size)] for row in a], a


def _step_loop(env, actions, seconds):
    """Step until ``seconds`` have passed; returns the window's seconds,
    every step's (seconds, position in the episode, observations, rewards)
    and the first episode's KPI rows."""
    steps, kpi_rows = [], None
    pos = env.time_step
    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    while now < deadline:
        obs, reward, terminated, _, _ = env.step(actions[pos])
        after = time.perf_counter()
        steps.append((after - now, pos, obs, reward))
        pos += 1
        if terminated:
            if kpi_rows is None:
                kpi_rows = env.evaluate_rows()
            env.reset()
            pos = 0
        now = time.perf_counter()
    return time.perf_counter() - t0, steps, kpi_rows


def compare(d, actions: np.ndarray, steps, kpi_rows, dtype=torch.float32, fault=None,
            names=None) -> Dict[str, float]:
    run = ref_env.episode(d, actions, dtype, fault)
    obs_ref = ref_env.observations(d).astype(np.float64)
    if dtype != torch.float32:
        obs_ref = torch.tensor(obs_ref).to(dtype).double().numpy()
    scale = np.maximum(np.abs(obs_ref).max(0), 1e-6)                 # (B, K)
    obs_gap = reward_gap = 0.0
    mean_reward = max(float(np.abs(run["rewards"]).mean()), 1e-12)
    for _, pos, obs, reward in steps:
        o = np.asarray(obs, np.float64)
        obs_gap = max(obs_gap, float((np.abs(o - obs_ref[pos + 1]) / scale).max()))
        reward_gap = max(reward_gap, float(np.abs(np.asarray(reward) - run["rewards"][pos]).max())
                         / mean_reward)
    out = {"obs_gap": obs_gap, "reward_gap": reward_gap}
    if kpi_rows is not None:
        names = names or [b.name for b in d.buildings]
        ref = ref_env.kpis(d, run, names)
        prog = {f"{r['name']}|{r['cost_function']}": r["value"] for r in kpi_rows}
        gaps = [abs(prog[k] - v) / max(abs(v), 1e-3) if prog.get(k) is not None and v is not None
                else (0.0 if prog.get(k) is v else float("inf")) for k, v in ref.items()]
        out["kpi_gap"] = max(gaps)
    return out


def run_env(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    from citylearn_tpu_torch.envs import environment as env_mod

    started = harness.process_start()
    phases = [("start", started)]
    mark = lambda name: phases.append((name, harness.boottime()))
    mark("imports")
    root = tempfile.mkdtemp(prefix="bench-district-")
    try:
        schema = write_district(cell.config, seed, root)
        mark("district written")
        env = env_mod.CityLearnEnv(schema, device=device)
        mark("env built")
        S = env.time_steps - 1
        actions, table = draw_actions(env, seed, S)
        env.reset()
        for t in range(int(cell.traffic["warmup_steps"])):
            env.step(actions[t])
        env.evaluate_rows()
        env.reset()
        mark("warm-up")
        setup_s = harness.boottime() - started
        harness.log_phases(phases)

        run = harness.Run()
        cuda = device.type == "cuda"
        sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
        first_steps = []
        if trace:
            n_traced = int(cell.traffic["trace_steps"])
            named = [(env_mod, "step_packed", "step_packed"), (env, "step", "env_step")]
            if cuda:
                with harness.spans(run, named), harness.device_trace(run, device.index or 0):
                    for _ in range(n_traced):
                        pos = env.time_step
                        obs, reward, terminated, _, _ = env.step(actions[pos])
                        first_steps.append((0.0, pos, obs, reward))
                        if terminated:
                            env.reset()
            with harness.spans(run, named, sync):
                elapsed, steps, kpi_rows = _step_loop(env, actions, seconds)
        else:
            elapsed, steps, kpi_rows = _step_loop(env, actions, seconds)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        while kpi_rows is None:
            # a window shorter than the episode: its end is still due
            pos = env.time_step
            obs, reward, terminated, _, _ = env.step(actions[pos])
            first_steps.append((0.0, pos, obs, reward))
            if terminated:
                kpi_rows = env.evaluate_rows()
        names = [b.name for b in env.spec.buildings]
        del env
        times = [s[0] for s in steps]
        values = {"setup_s": setup_s, "env_steps_per_s": len(steps) / elapsed,
                  "env_step_p95_ms": 1e3 * float(np.percentile(times, 95))}
        d = district_model.load(schema)
        readings = compare(d, table, first_steps + steps, kpi_rows, names=names)
        return {"values": values, "readings": readings, "run": run, "peak": peak,
                "steps": len(steps), "elapsed": elapsed}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(cell, seed: int, seconds: float, trace: bool) -> int:
    out = run_env(cell, seed, seconds, trace, torch.device("cuda:0"))
    run = out["run"]
    dev = harness.device_info(cell.chips, out["peak"])
    if trace:
        dev["busy_s"] = run.busy_s()
        dev["window_s"] = run.trace_window[1] - run.trace_window[0]
    return harness.emit(cell, out["values"], run, trace, dev,
                        harness.checks(out["readings"], cell.traffic["limits"]), out["steps"], 0)
