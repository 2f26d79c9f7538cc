"""The port's debug-mode physics checks (``core/debug.py`` and the checks
in ``district_step``) against the JAX package's: with checks off the step
builds no condition and reads nothing back; with checks on valid
battery+PV and EV rollouts pass; corrupted states raise
``PhysicsCheckError`` naming the violated invariants, the same names in
the same order as the JAX step's callback on the same states.

No tolerance: the checks compare against the same eps (1e-3) on states
taken from the same seeded datasets, and the names must match exactly."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import debug as jax_debug
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import debug, rollout
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_thermal_dataset,
)

D, S = 2, 24


@pytest.fixture(scope="module")
def districts(tmp_path_factory):
    paths = {
        "battery": write_battery_pv_dataset(str(tmp_path_factory.mktemp("b")), 3, 100, seed=1),
        "thermal": write_thermal_dataset(str(tmp_path_factory.mktemp("t")), 4, 100, seed=1),
        "ev": write_ev_dataset(str(tmp_path_factory.mktemp("e")), 4, 3, 5, 1, 100, seed=1),
    }
    out = {}
    for name, path in paths.items():
        with open(path) as f:
            schema = json.load(f)
        schema["root_directory"] = os.path.dirname(path)
        kw = dict(episode_time_steps=S + 1)
        out[name] = (pack(compile_schema(schema, **kw), device="cpu")[:2],
                     jax_pack(jax_compile(schema, **kw))[:2])
    return out


@pytest.fixture()
def checks_on():
    debug.enable_checks(True)
    jax_debug.enable_checks(True)
    try:
        yield
    finally:
        debug.enable_checks(False)
        jax_debug.enable_checks(False)


def _actions(cfg, seed):
    rng = np.random.RandomState(seed)
    acts = {k: rng.uniform(-1.0, 1.0, (D, cfg.n_buildings)).astype(np.float32)
            for k in ("electrical_storage", "cooling_storage", "dhw_storage")}
    if cfg.has_evs:
        acts["electric_vehicle_storage"] = rng.uniform(
            -1.0, 1.0, (D, cfg.n_chargers)).astype(np.float32)
        acts["washing_machine"] = (rng.rand(D, cfg.n_washing_machines) < 0.5).astype(np.float32)
    return acts


def _run(cfg, params, n_steps, seed=0):
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    for s in range(n_steps):
        states, out = district_step(cfg, params, states, {
            k: torch.tensor(v) for k, v in _actions(cfg, seed + s).items()})
    return states, out


def test_checks_off_build_nothing_and_read_nothing_back(districts, monkeypatch):
    (cfg, params), _ = districts["ev"]
    assert not debug.checks_enabled()
    ref_state, ref_out = _run(cfg, params, 3)

    def never(*a, **k):
        raise AssertionError("a check ran with checks off")

    monkeypatch.setattr(debug, "runtime_check", never)
    reads = []
    for name in ("cpu", "item", "tolist", "__bool__"):
        shipped = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _f=shipped, _n=name, **k: (reads.append(_n),
                                                                         _f(self, *a, **k))[1])
    state, out = _run(cfg, params, 3)
    monkeypatch.undo()
    assert reads == []
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(ref_state, f.name)
        assert (a == b) if isinstance(a, tuple) else torch.equal(a, b), f.name
    assert torch.equal(out.net_electricity_consumption, ref_out.net_electricity_consumption)


@pytest.mark.parametrize("family", ["battery", "ev"])
def test_checks_pass_on_valid_rollout(districts, checks_on, family):
    (cfg, params), _ = districts[family]
    calls = []
    shipped = debug.runtime_check
    debug.runtime_check = lambda c: (calls.append(tuple(c)), shipped(c))[1]
    try:
        state, out = _run(cfg, params, S)
    finally:
        debug.runtime_check = shipped
    assert len(calls) == S
    names = ["soc_prev_in_[0,1]", "soc_new_in_[0,1]", "consumption_nonnegative",
             "output_at_most_demand", "net_finite"]
    assert list(calls[0]) == names + (["ev_soc_in_[0,1]"] if family == "ev" else [])
    assert torch.isfinite(out.net_electricity_consumption).all()
    # the checks change no output: the same steps with checks off
    debug.enable_checks(False)
    state_off, out_off = _run(cfg, params, S)
    assert torch.equal(out.net_electricity_consumption, out_off.net_electricity_consumption)
    assert torch.equal(state.battery_soc, state_off.battery_soc)


def _jax_violations(jcfg, jparams, jstate, acts):
    fn = jax.jit(jax.vmap(lambda st, a: jax_step(jcfg, jparams, st, a)))
    with pytest.raises(Exception) as exc:
        _, out = fn(jstate, {k: jnp.asarray(v) for k, v in acts.items()})
        jax.block_until_ready(out.net_electricity_consumption)
    found = re.search(r"physics invariant violated: ([^\n'\"]*)", str(exc.value))
    assert found, str(exc.value)
    return found.group(1).strip()


CORRUPTIONS = {         # family, field, value, steps taken before the corruption
    "battery-soc-high": ("battery", "battery_soc", 2.5, 0),
    "cooling-soc-negative": ("thermal", "cooling_storage_soc", -0.5, 0),
    "dhw-soc-high": ("thermal", "dhw_storage_soc", 1.5, 0),
    # the first steps force every EV's SOC from its schedule; by step 18
    # an EV carries its SOC and the corrupted one leaves [0, 1]
    "ev-soc-high": ("ev", "ev_soc", 1.7, 18),
    "battery-soc-nan": ("battery", "battery_soc", float("nan"), 0),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corrupted_state_raises_as_in_jax(districts, checks_on, case):
    family, field, value, warm = CORRUPTIONS[case]
    (cfg, params), (jcfg, jparams) = districts[family]
    acts = _actions(cfg, 3)
    idle = {k: np.zeros_like(v) for k, v in acts.items()}
    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D)
    jfn = jax.jit(jax.vmap(lambda st, a: jax_step(jcfg, jparams, st, a)))
    for _ in range(warm):
        states, _ = district_step(cfg, params, states,
                                  {k: torch.tensor(v) for k, v in idle.items()})
        jstates, _ = jfn(jstates, {k: jnp.asarray(v) for k, v in idle.items()})
    states = dataclasses.replace(states, **{field: torch.full_like(getattr(states, field),
                                                                   value)})
    jstates = jstates.replace(**{field: jnp.full_like(getattr(jstates, field), value)})
    with pytest.raises(debug.PhysicsCheckError) as exc:
        district_step(cfg, params, states, {k: torch.tensor(v) for k, v in acts.items()})
    message = str(exc.value)
    assert message.startswith("physics invariant violated: ")
    assert message == f"physics invariant violated: {_jax_violations(jcfg, jparams, jstates, acts)}"
    assert "soc" in message or "net_finite" in message


def test_runtime_check_names_in_order():
    debug.enable_checks(True)
    try:
        debug.runtime_check({"a": torch.ones(3, dtype=torch.bool),
                             "b": torch.ones(2, 2, dtype=torch.bool)})
        with pytest.raises(debug.PhysicsCheckError,
                           match=r"^physics invariant violated: c, a$"):
            debug.runtime_check({"c": torch.tensor([True, False]),
                                 "b": torch.ones(2, dtype=torch.bool),
                                 "a": torch.zeros((), dtype=torch.bool)})
    finally:
        debug.enable_checks(False)
    debug.runtime_check({"off": torch.zeros(1, dtype=torch.bool)})    # off: no-op
