"""The port's tracer (``citylearn_tpu_torch.tracing``) on the CPU.

- Off (the default) a span is the shared no-op: no clock read, no
  ``record_function``, nothing recorded.
- Tracing changes nothing that is computed: a ``BatchedSAC`` on the
  kernel-collect path (K2's plain version on the CPU) trains, and a
  ``CityLearnEnv`` steps, to bit-identical results with tracing on and off.
- Spans nest: parent and root ids, per thread; a recording inside another
  is the outer one.
- The span counts agree with the trainer's cadence and the env's steps.
- The spans' clock is the one ``torch.profiler`` places its events on.
- Inside ``utilities.Profiler`` the Chrome trace names the program's spans
  and K1's wrapper; a ``Profiler`` inside a recording leaves it every span.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from citylearn_tpu_torch import CityLearnEnv, tracing
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig
from citylearn_tpu_torch.utilities import Profiler

D, B, EPISODE, WARMUP = 128, 5, 48, 8          # 47 steps an episode
TRAIN = TrainConfig(n_districts=D, hidden=(16, 16), batch_size=32, replay_capacity=D * 64,
                    warmup_steps=WARMUP, collect="kernel")
ENV_STEPS = 60                                  # across the episode's end and a reset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=1)


def trainer(dataset):
    return BatchedSAC(dataset, TRAIN, seed=3, episode_time_steps=EPISODE, device="cpu")


def train_60(tr):
    """Two calls of 30 steps: collect chunks of 30, 17 (the episode's end)
    and 13."""
    return tr.train(60, chunk=30)


def step_env(dataset, n=ENV_STEPS):
    env = CityLearnEnv(dataset, device="cpu", episode_time_steps=EPISODE)
    rng = np.random.default_rng(5)
    out = [env.reset()[0]]
    for _ in range(n):
        actions = [rng.uniform(s.low, s.high).astype(np.float32) for s in env.action_space]
        obs, reward, terminated, _, _ = env.step(actions)
        out.append((obs, reward, terminated))
        if terminated:
            out.append(env.evaluate_rows())
            out.append(env.reset()[0])
    return out


def tensors(tree):
    """Every tensor of a nested state dict, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def test_off_records_nothing_and_returns_the_shared_no_op(monkeypatch):
    assert tracing.span("train.update") is tracing.span("env.step") is tracing._OFF

    def forbidden(*args, **kw):
        raise AssertionError("read with tracing off")

    @tracing.traced("kernel")
    def kernel(x, y=1):
        return x + y

    monkeypatch.setattr(time, "time_ns", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    with tracing.span("train.update") as s:
        assert kernel(1, y=2) == 3
    assert s is tracing._OFF
    assert kernel.__name__ == "kernel"
    monkeypatch.undo()
    with tracing.recording() as rec:
        pass
    assert rec.spans == []
    assert tracing._active is None


@pytest.mark.parametrize("path", ["trainer", "env"])
def test_tracing_changes_no_result(dataset, path):
    if path == "trainer":
        plain, traced = trainer(dataset), trainer(dataset)
        assert plain.use_kernel_collect
        history = train_60(plain)
        with tracing.recording() as rec:
            assert train_60(traced) == history
        assert len(rec.durations("train.update")) > 0
        ours, theirs = (list(tensors(t.state.nets.state_dict())) for t in (plain, traced))
        assert len(ours) == len(theirs) > 3 * 6 * 2        # three nets' leaves and Adam moments
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
        for name in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done",
                     "cur_obs"):
            assert torch.equal(getattr(plain.state, name), getattr(traced.state, name)), name
        assert torch.equal(plain.state.env_state.battery_soc, traced.state.env_state.battery_soc)
    else:
        plain = step_env(dataset)
        with tracing.recording() as rec:
            traced = step_env(dataset)
        assert len(rec.durations("env.step")) == ENV_STEPS
        assert repr(traced) == repr(plain)


def test_spans_nest_with_parent_and_root_ids():
    with tracing.recording() as rec:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        with tracing.span("e"):
            pass
        seen = []
        worker = threading.Thread(target=lambda: seen.append(tracing.span("f").__enter__()))
        with tracing.span("g"):
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
        with tracing.recording(annotate=True) as inner:
            assert inner is rec and rec.annotate
            with tracing.span("h"):
                pass
        assert not rec.annotate
        with tracing.span("i"):
            pass
    assert tracing._active is None
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["c", "b", "d", "a", "e", "g", "h", "i"]
    a, b, c, d = by["a"], by["b"], by["c"], by["d"]
    assert (a.parent, a.root) == (0, a.id)
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id)
    assert by["e"].parent == 0 and by["e"].root == by["e"].id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns \
        <= d.end_ns <= a.end_ns
    # the other thread's span began with none open on its thread; it has
    # not ended, so it is not recorded
    assert (seen[0].parent, seen[0].root) == (0, seen[0].id)
    # a recording inside another is the outer one, and keeps its spans
    assert (by["h"].parent, by["h"].root) == (0, by["h"].id)
    assert len({s.id for s in rec.spans}) == 8
    assert rec.durations("a") == [(a.end_ns - a.start_ns) * 1e-9]


def test_counts_agree_with_the_cadence_and_the_steps(dataset):
    tr = trainer(dataset)
    with tracing.recording() as rec:
        train_60(tr)
    names = [s.name for s in rec.spans]
    # an update for every step past the warm-up: each slot holds D >= the
    # batch's rows from the first step on
    assert names.count("train.update") == 60 - WARMUP
    for name in ("train.draws", "train.replay", "sac.target", "sac.critic", "sac.policy",
                 "sac.polyak"):
        assert names.count(name) == 60 - WARMUP, name
    assert names.count("train.chunk") == 3
    assert names.count("train.readback") == 3
    assert names.count("battery_collect_chunk") == 3
    assert names.count("train.call") == 1
    assert names.count("train.policy") == 3       # every chunk has steps past the warm-up
    call = next(s for s in rec.spans if s.name == "train.call")
    assert all(s.root == call.id for s in rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith("sac.") or s.name in ("train.draws", "train.replay"):
            assert by_id[s.parent].name == "train.update"
        if s.name == "train.update":
            assert by_id[s.parent].name == "train.chunk"

    with tracing.recording() as rec:
        step_env(dataset)
    names = [s.name for s in rec.spans]
    for name in ("env.step", "env.actions", "env.district_step", "env.readback",
                 "env.observe"):
        assert names.count(name) == ENV_STEPS, name
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name != "env.step":
            assert by_id[s.parent].name == "env.step" and by_id[s.root].name == "env.step"


def test_span_clock_is_the_profilers():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            tracing.recording() as rec:
        with tracing.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.randn(64, 64).sum()
    (outer,) = rec.spans
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    start, end = inner.start_ns(), inner.start_ns() + inner.duration_ns()
    assert outer.start_ns - 1_000_000 <= start <= end <= outer.end_ns + 1_000_000


def test_profiler_trace_names_the_program_spans(dataset, tmp_path):
    tr = trainer(dataset)
    rbc = ScriptedPolicy({"electrical_storage": np.where(np.arange(1, 25) < 9, 0.091, -0.08)
                          .astype(np.float32)}, hour_tables=True)
    with Profiler(str(tmp_path / "trace")) as prof:
        tr.train(WARMUP + 4, chunk=WARMUP + 4)
        evaluate_scripted(tr.env_cfg, tr.params, rbc, 24, device="cpu")
    assert tracing._active is None
    with open(prof.trace_path) as f:
        ranges = {e.get("name") for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    assert {"train.call", "train.update", "sac.critic", "battery_collect_chunk",
            "battery_episode"} <= ranges
    names = [s.name for s in prof.recording.spans]
    assert names.count("train.update") == 4 and names.count("battery_episode") == 1

    # a Profiler opened inside a recording annotates for its block, and
    # the recording keeps the block's spans
    with tracing.recording() as rec:
        tr.train(2, chunk=2)
        with Profiler(str(tmp_path / "inner")) as prof:
            tr.train(2, chunk=2)
        assert prof.recording is rec and not rec.annotate
        tr.train(2, chunk=2)
    assert [s.name for s in rec.spans].count("train.update") == 6
    with open(prof.trace_path) as f:
        ranges = [e.get("name") for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    assert ranges.count("train.update") == 2
