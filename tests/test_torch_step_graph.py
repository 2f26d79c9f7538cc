"""The district step's CUDA graph (``citylearn_tpu_torch.core.step_graph``).

Inside an owner's ``StepGraph.engaged()`` block ``district_step`` (and the
Gym env's ``step_packed``) is, on a CUDA card, a replay of one captured
graph, which must be bit-equal (``torch.equal``) to the same step run
eagerly: every state and output tensor, across t = 0, the LSTM's warm-up
and an episode's reset, at the per-step trainer's D=4096 on the LSTM
district and at the Gym env's D=1, ``step_packed``'s flat output included;
with one capture per key over two episodes, and a fresh capture after
each reset of a stochastic-outage env (which replaces its parameters); and
through the env and the trainer on the thermal, EV and neighborhood
districts. The key changes with the parameters' identity, the action
names and a shape, and not between a state fresh from a reset and a
stepped one. A caller that wraps the module globals
``citylearn_tpu_torch.train.district_step`` or
``citylearn_tpu_torch.envs.environment.step_packed`` (four arguments)
sees each step once, inside the owner's block. The graph's mechanism,
shared with ``sac_update``, and what it does alike for both (the CPU runs
eagerly, also with the physics checks on and in the float64 parity mode;
copies start without a graph) are tested in ``test_torch_graphs.py``.

This file imports no JAX: the ``gpu`` tests run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_step_graph.py``."""

import contextlib
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import citylearn_tpu_torch.train as train_mod
from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import debug
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import ACTION_KEYS, batched_initial_states
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.step_graph import StepGraph, engaged_graph, key_of
from citylearn_tpu_torch.core.types import flatten
from citylearn_tpu_torch.envs import environment
from citylearn_tpu_torch.envs.environment import CityLearnEnv
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_lstm_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

EPISODE = 24
#: the other families the trainer and the env step, at the other port tests' sizes
FAMILIES = {
    "thermal": lambda root: write_thermal_dataset(root, 4, 200, seed=3, heating=True),
    "ev_constrained": lambda root: write_ev_dataset(root, 4, 3, 4, 1, 300, constraints=True),
    "eulp": lambda root: write_neighborhood_dataset(root, 6, 300),
    "quebec": lambda root: write_neighborhood_dataset(root, 6, 300, quebec=True),
}


@pytest.fixture(scope="module")
def lstm_schema(tmp_path_factory):
    return write_lstm_dataset(str(tmp_path_factory.mktemp("lstm")), n_rows=200, seed=4)


@pytest.fixture(scope="module")
def battery_schema(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("battery")), 5, 200, seed=1)


@pytest.fixture(scope="module")
def outage_schema(tmp_path_factory):
    return write_lstm_dataset(str(tmp_path_factory.mktemp("outage")), n_rows=200, seed=5,
                              stochastic_outage=True)


class Eager:
    """An owner's graph stand-in whose block engages nothing."""

    def engaged(self):
        return contextlib.nullcontext()


def district(schema, device, **kw):
    return pack(compile_schema(schema, episode_time_steps=EPISODE, **kw), device=device)[:2]


def step_actions(cfg, D, gen, device):
    """Every building-level action the trainer hands the step, (D, B)
    each, uniform in [-1, 1] ([0, 1] for the partial-load device)."""
    B = cfg.n_buildings
    draw = lambda lo: lo + (1 - lo) * torch.rand((D, B), generator=gen, device=device)
    return {k: draw(0.0 if k.endswith("device") else -1.0) for k in ACTION_KEYS}


def same(a, b) -> bool:
    """``torch.equal``, with NaN (the occupant's unset overrides) equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def assert_trees_equal(ours, ref, what):
    a, b = flatten(ours), flatten(ref)
    assert a.keys() == b.keys(), what
    for k in a:
        assert same(a[k], b[k]), f"{what} {k}"


def spans(rec, *names):
    seen = [s.name for s in rec.spans]
    return tuple(seen.count(n) for n in names)


def trainer(schema, device, D, graph=True):
    cfg = TrainConfig(n_districts=D, hidden=(16, 16), batch_size=32, replay_capacity=D * 64,
                      warmup_steps=8, collect="scan")
    tr = BatchedSAC(schema, cfg, seed=3, episode_time_steps=EPISODE, device=device)
    if not graph:
        tr._step_graph = Eager()
    return tr


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's graph is a CUDA graph")


def eager_steps(mode, battery_schema, lstm_schema):
    """14 steps on the CPU (``mode``: plain, with the physics checks on or
    in the parity mode), each equal to eager ``district_step``'s; (their
    recording, the owner's graph) for
    ``test_torch_graphs.py::test_cpu_runs_eagerly``."""
    if mode == "parity":
        env = CityLearnEnv(battery_schema, device="cpu", parity_f64=True,
                           episode_time_steps=EPISODE)
        env.reset()
        cfg, params, state = env.cfg, env.params, env._state
        acts = lambda t: env._device_actions(env._parse_actions(
            [np.full(s.shape[0], np.sin(t), np.float32) for s in env.action_space]))
    else:
        cfg, params = district(lstm_schema, "cpu")
        state = batched_initial_states(cfg, params, 4, device="cpu")
        gen = torch.Generator().manual_seed(0)
        acts = lambda t: step_actions(cfg, 4, gen, "cpu")
    graph, ours = StepGraph(), state
    debug.enable_checks(mode == "checks")
    try:
        with tracing.recording() as rec:
            for t in range(14):
                a = acts(t)
                with graph.engaged():
                    ours, out = district_step(cfg, params, ours, a)
                state, ref = district_step(cfg, params, state, a)
                assert_trees_equal(ours, state, f"state {t}")
                assert_trees_equal(out, ref, f"output {t}")
    finally:
        debug.enable_checks(False)
    return rec, graph.graph


# --- the CPU ---------------------------------------------------------------------

def test_run_disengages_and_blocks_nest():
    a, b, seen = StepGraph(), StepGraph(), []
    assert engaged_graph() is None
    with a.engaged():
        with b.engaged():
            assert engaged_graph() is b
        assert engaged_graph() is a

        class Cfg:
            parity_f64 = False

        class State:
            t = torch.zeros(1)

        a.run(lambda *args: seen.append(engaged_graph()), Cfg, None, State, {})
        assert engaged_graph() is a
    assert engaged_graph() is None and seen == [None]


def _key_cases(cfg, params, state, acts):
    stepped, _ = district_step(cfg, params, state, acts)
    fewer = {k: v for k, v in acts.items() if k != "cooling_device"}
    wider = batched_initial_states(cfg, params, state.t.shape[0] + 1, device="cpu")
    return {
        "params": (cfg, dataclasses.replace(params), stepped, acts),
        "config": (dataclasses.replace(cfg), params, stepped, acts),
        "action_names": (cfg, params, stepped, fewer),
        "action_shape": (cfg, params, stepped, {**acts, "cooling_device": acts[
            "cooling_device"][:, :1]}),
        "state_shape": (cfg, params, wider, acts),
        "state_dtype": (cfg, params, dataclasses.replace(
            stepped, battery_soc=stepped.battery_soc.double()), acts),
    }


@pytest.mark.parametrize("change", ["params", "config", "action_names", "action_shape",
                                    "state_shape", "state_dtype"])
def test_key_changes_with_what_the_capture_reads(lstm_schema, change):
    cfg, params = district(lstm_schema, "cpu")
    state = batched_initial_states(cfg, params, 4, device="cpu")
    acts = step_actions(cfg, 4, torch.Generator().manual_seed(1), "cpu")
    stepped, _ = district_step(cfg, params, state, acts)
    key = key_of(district_step, cfg, params, stepped, acts)
    assert key_of(district_step, cfg, params, stepped, dict(acts)) == key
    assert key_of(district_step, *_key_cases(cfg, params, state, acts)[change]) != key


def test_reset_state_keys_as_a_stepped_one(lstm_schema, battery_schema):
    """The trainer's reset (``_broadcast_initial``) and the env's
    (``initial_state`` and ``unsqueeze``) map to their stepped state's key,
    so that one capture serves a whole run."""
    tr = trainer(lstm_schema, "cpu", 8)
    acts = tr._actions_dict(torch.zeros((8, tr.env_cfg.n_buildings, tr.act_dim)))
    reset = tr._broadcast_initial(torch.arange(8, dtype=torch.int32))
    stepped, _ = district_step(tr.env_cfg, tr.params, tr.state.env_state, acts)
    key = lambda st: key_of(district_step, tr.env_cfg, tr.params, st, acts)
    assert key(reset) == key(stepped) == key(tr.state.env_state)

    env = CityLearnEnv(battery_schema, device="cpu", episode_time_steps=EPISODE)
    env.reset()
    fresh = env._state
    acts = env._device_actions(env._parse_actions(
        [np.zeros(s.shape[0], np.float32) for s in env.action_space]))
    env.step([np.zeros(s.shape[0], np.float32) for s in env.action_space])
    key = lambda st: key_of(environment._packed_step, env.cfg, env.params, st, acts)
    assert key(fresh) == key(env._state)


def test_scan_step_calls_district_step_once_a_step(lstm_schema, monkeypatch):
    """The benchmark's recorders wrap ``train.district_step`` with four
    arguments: one call a step, inside the trainer's graph block, across
    the episode's end."""
    tr = trainer(lstm_schema, "cpu", 8)
    shipped, calls = train_mod.district_step, []

    def wrapped(cfg, params, state, actions):
        calls.append(engaged_graph() is tr._step_graph)
        return shipped(cfg, params, state, actions)

    monkeypatch.setattr(train_mod, "district_step", wrapped)
    tr.train(30, chunk=30)
    assert len(calls) == 30 and all(calls)
    assert int(tr.state.env_state.t[0]) == 30 - (EPISODE - 1)


def test_env_step_calls_step_packed_once_a_step(battery_schema, monkeypatch):
    env = CityLearnEnv(battery_schema, device="cpu", episode_time_steps=EPISODE)
    shipped, calls = environment.step_packed, []

    def wrapped(cfg, params, state, actions):
        calls.append(engaged_graph() is env._step_graph)
        return shipped(cfg, params, state, actions)

    monkeypatch.setattr(environment, "step_packed", wrapped)
    env.reset()
    zeros = [np.zeros(s.shape[0], np.float32) for s in env.action_space]
    for _ in range(30):
        if env.step(zeros)[2]:
            env.reset()
    assert len(calls) == 30 and all(calls)
    assert engaged_graph() is None


# --- the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_graph_is_bit_equal_to_eager_on_the_lstm_district_at_4096(lstm_schema):
    """35 steps at the per-step trainer's D=4096: t = 0 to 19 (the LSTM
    predicts from t = 12), a reset onto other windows, t = 0 to 14; the
    eager first, the capture, 33 replays."""
    needs_card()
    D = 4096
    cfg, params = district(lstm_schema, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    fresh = lambda: dataclasses.replace(
        batched_initial_states(cfg, params, D, device="cuda"),
        data_offset=torch.randint(0, 150, (D,), generator=gen, device="cuda",
                                  dtype=torch.int32))
    graph = StepGraph()
    ours = ref = fresh()
    with tracing.recording() as rec:
        for t in range(35):
            if t == 20:
                ours = ref = fresh()
            acts = step_actions(cfg, D, gen, "cuda")
            with graph.engaged():
                ours, out = district_step(cfg, params, ours, acts)
            ref, ref_out = district_step(cfg, params, ref, acts)
            assert_trees_equal(ours, ref, f"state {t}")
            assert_trees_equal(out, ref_out, f"output {t}")
    assert spans(rec, "step.graph", "step.capture") == (34, 1)
    # the eager step's spans: 35 of the reference, the graph's first and its capture
    assert spans(rec, "step.dynamics", "step.partial_load") == (37, 37)


def env_pair(schema, **kw):
    """(env with its graph, env stepping eagerly) on the card, and a
    recorder of every ``step_packed`` result, in call order."""
    ours = CityLearnEnv(schema, device="cuda", episode_time_steps=EPISODE, **kw)
    ref = CityLearnEnv(schema, device="cuda", episode_time_steps=EPISODE, **kw)
    ref._step_graph = Eager()
    return ours, ref


def step_pair(ours, ref, n, monkeypatch, seed):
    shipped, packed = environment.step_packed, []

    def recorded(cfg, params, state, actions):
        st, flat = shipped(cfg, params, state, actions)
        packed.append((flat.clone(), {k: v.clone() for k, v in flatten(st).items()}))
        return st, flat

    monkeypatch.setattr(environment, "step_packed", recorded)
    rng = np.random.RandomState(seed)
    ours.reset(), ref.reset()
    for t in range(n):
        acts = [rng.uniform(-1, 1, s.shape[0]).astype(np.float32) for s in ours.action_space]
        a, b = ours.step(acts), ref.step(acts)
        np.testing.assert_array_equal(np.concatenate([np.ravel(o) for o in a[0]]),
                                      np.concatenate([np.ravel(o) for o in b[0]]))
        assert a[1:3] == b[1:3], f"rewards, terminated {t}"
        (flat, st), (ref_flat, ref_st) = packed[-2:]
        assert same(flat, ref_flat), f"packed {t}"
        assert st.keys() == ref_st.keys()
        assert all(same(st[k], ref_st[k]) for k in st), f"state {t}"
        if a[2] and t < n - 1:
            ours.reset(), ref.reset()
    np.testing.assert_array_equal(ours._hist_buf, ref._hist_buf)


@pytest.mark.gpu
def test_graph_is_bit_equal_to_eager_through_the_env(battery_schema, monkeypatch):
    """Two 24-step episodes and more of the Gym env at D=1 on the battery
    district: one capture, every later step a replay."""
    needs_card()
    ours, ref = env_pair(battery_schema)
    with tracing.recording() as rec:
        step_pair(ours, ref, 2 * (EPISODE - 1) + 5, monkeypatch, seed=6)
    n = 2 * (EPISODE - 1) + 5
    assert spans(rec, "env.district_step", "step.graph", "step.capture") == (2 * n, n - 1, 1)


@pytest.mark.gpu
def test_stochastic_outage_env_recaptures_after_reset(outage_schema, monkeypatch):
    """Each reset of a stochastic-outage env bakes a new outage signal into
    new parameters: a new key, so each episode captures once."""
    needs_card()
    ours, ref = env_pair(outage_schema)
    with tracing.recording() as rec:
        step_pair(ours, ref, 2 * (EPISODE - 1), monkeypatch, seed=7)
    assert spans(rec, "step.capture") == (2,)
    assert ours._step_graph.graph._same[2] is ours.params


@pytest.mark.gpu
def test_trainer_captures_once_over_two_episodes(lstm_schema):
    """The per-step trainer on the LSTM district, graph against eager
    steps, over two episodes: the same replay, state and networks."""
    needs_card()
    ours, ref = trainer(lstm_schema, "cuda", 256), trainer(lstm_schema, "cuda", 256, graph=False)
    n = 2 * (EPISODE - 1) + 3
    with tracing.recording() as rec:
        ours.train(n, chunk=n)
    ref.train(n, chunk=n)
    assert spans(rec, "train.step", "step.graph", "step.capture") == (n, n - 1, 1)
    for name in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done",
                 "cur_obs"):
        assert torch.equal(getattr(ours.state, name), getattr(ref.state, name)), name
    assert_trees_equal(ours.state.env_state, ref.state.env_state, "state")
    for p, q in zip(ours.state.nets.policy.parameters(), ref.state.nets.policy.parameters()):
        assert torch.equal(p, q)


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_replays_bit_equal(family, tmp_path, monkeypatch):
    """The thermal, EV (with charging constraints) and neighborhood
    districts (EULP; quebec with occupants) through the Gym env and the
    per-step trainer: one capture each, bit-equal to eager steps."""
    needs_card()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the quebec district's absent trees
        schema = FAMILIES[family](str(tmp_path))
        ours, ref = env_pair(schema)
        with tracing.recording() as rec:
            step_pair(ours, ref, EPISODE + 5, monkeypatch, seed=8)
        assert spans(rec, "step.capture") == (1,)
        monkeypatch.undo()
        ours, ref = trainer(schema, "cuda", 128), trainer(schema, "cuda", 128, graph=False)
        with tracing.recording() as rec:
            ours.train(EPISODE + 3, chunk=EPISODE + 3)
        ref.train(EPISODE + 3, chunk=EPISODE + 3)
    assert spans(rec, "step.capture") == (1,)
    for name in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done"):
        assert same(getattr(ours.state, name), getattr(ref.state, name)), name
    assert_trees_equal(ours.state.env_state, ref.state.env_state, "state")
