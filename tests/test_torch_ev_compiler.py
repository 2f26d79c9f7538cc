"""The port's compiler and packer on the EV district against the JAX
package's, on the seeded synthetic EV dataset
(``citylearn_tpu_torch.synthetic.write_ev_dataset``) with and without
charging constraints: the SOC event tensors, the compiled spec field by
field, the observation and action surface and spaces, every packed leaf
and the initial state. All comparisons are exact: both sides run the same
numpy arithmetic on the same files, and the drift draws come from the same
seeded stream.

Also what the writer guarantees: files that do not change from call to
call, every charger state, EVs that move between chargers or never dock,
arrivals that force the SOC, and never one EV at two chargers in a row.
"""

import dataclasses
import hashlib
import os

import jax
import numpy as np
import pytest

from citylearn_tpu.compiler.events import resolve_ev_events as jax_resolve_ev_events
from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu_torch.compiler.events import resolve_ev_events
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.params import initial_state, pack, params_from_numpy
from citylearn_tpu_torch.core.types import flatten
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_thermal_dataset,
)

B, C, V, W, ROWS, T = 6, 4, 7, 1, 400, 169


def jax_leaves(tree):
    """{"field.subfield": numpy array} of a JAX pytree of dataclasses."""
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same(a, b, path="spec"):
    """Field-by-field equality of two specs (dataclasses of different
    modules), arrays compared by dtype, shape and value."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "constraints"])
def schema_path(request, tmp_path_factory):
    return write_ev_dataset(str(tmp_path_factory.mktemp("ds")), B, C, V, W, ROWS, seed=2,
                            constraints=request.param)


@pytest.fixture(scope="module", params=[False, True], ids=["decentral", "central"])
def compiled(request, schema_path):
    kw = dict(central_agent=request.param, episode_time_steps=T)
    return compile_schema(schema_path, **kw), jax_compile(schema_path, **kw)


def test_spec_equals_jax(compiled):
    ours, ref = compiled
    assert_same(ours, ref)
    assert len(ours.electric_vehicles) == V
    assert sum(len(b.chargers) for b in ours.buildings) == C
    assert sum(len(b.washing_machines) for b in ours.buildings) == W
    assert ours.observation_names() == ref.observation_names()
    assert ours.action_names() == ref.action_names()
    # per-charger and per-machine expansion of the surface
    names = ours.buildings[0].active_observations
    cid = ours.buildings[0].chargers[0].charger_id
    assert f"electric_vehicle_charger_{cid}_connected_state" in names
    assert f"electric_vehicle_storage_{cid}" in ours.buildings[0].active_actions
    assert "washing_machine_1" in ours.buildings[1].active_actions
    constrained = ours.buildings[0].charging_constraints is not None
    assert ("charging_constraint_violation_kwh" in names) == constrained
    assert ("charging_building_headroom_kw" in names) == constrained
    assert any(n.startswith("charging_phase_one_hot_") for n in names) == constrained


def test_events_equal_jax(compiled):
    ours, ref = compiled
    force, drift = resolve_ev_events(ours.buildings, V, T, drift_seed=ours.random_seed)
    jforce, jdrift = jax_resolve_ev_events(ref.buildings, V, T, drift_seed=ref.random_seed)
    np.testing.assert_array_equal(force, jforce)
    np.testing.assert_array_equal(drift, jdrift)
    assert force.shape == drift.shape == (T, V) and force.dtype == np.float32
    # arrivals force the SOC, undocked EVs drift, and no step does both
    assert np.isfinite(force).any() and np.isfinite(drift).any()
    assert not (np.isfinite(force) & np.isfinite(drift)).any()
    never_docked = np.isfinite(drift[1:-1]).all(axis=0)
    assert never_docked.any() and not never_docked.all()


def test_pack_equals_jax(compiled):
    ours, ref = compiled
    (cfg, params, layout), (jcfg, jparams, jlayout) = pack(ours, device="cpu"), jax_pack(ref)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.has_evs and cfg.has_washing_machines
    assert (cfg.n_chargers, cfg.n_evs, cfg.n_washing_machines) == (C, V, W)
    assert layout.union_names == jlayout.union_names
    assert layout.building_indices == jlayout.building_indices
    carried = flatten(params_from_numpy(jax_leaves(jparams), device="cpu"))
    mine = flatten(params)
    # 61 leaves of a battery+PV district plus 18 of the chargers, 13 of the
    # EVs (a battery's 11, force, drift) and 4 of the machines
    assert set(mine) == set(carried) and len(mine) == 61 + 18 + 13 + 4
    for k, v in mine.items():
        assert v.dtype == carried[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), carried[k].numpy(), err_msg=k)
    state = flatten(initial_state(cfg, params, 3))
    jstate = jax_leaves(jax_initial_state(jcfg, jparams, 3))
    assert len(state) == 18 and state["ev_soc"].shape == (V,)     # 6 zero-sized occupant leaves
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), jstate[k], err_msg=k)
    if cfg.has_charging_constraints:
        assert cfg.n_charging_phases == 2 and cfg.charging_penalty_coefficient == 2.0
        assert np.isfinite(params.chargers.cc_building_limit.numpy()).sum() == 2


def _charger_rows(root):
    """{charger file: (state, EV id) columns} of a written dataset."""
    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("charger_"):
            with open(os.path.join(root, name)) as f:
                rows = [line.rstrip("\n").split(",") for line in f][1:]
            out[name] = ([r[0] for r in rows], [r[1] for r in rows])
    return out


def test_writer_guarantees(schema_path):
    root = os.path.dirname(schema_path)
    chargers = _charger_rows(root)
    assert len(chargers) == C
    states = {s for col, _ in chargers.values() for s in col}
    assert states == {"1", "2", "3"}
    # never one EV at two chargers in a row
    for t in range(ROWS):
        docked = [ids[t] for col, ids in chargers.values() if col[t] == "1"]
        assert len(docked) == len(set(docked)), t
    # EVs move between chargers; some never dock
    seen = {name: {i for s, i in zip(*cols) if s == "1"} for name, cols in chargers.items()}
    assert all(len(ids) > 1 for ids in seen.values())
    everywhere = set().union(*seen.values())
    assert 0 < len(everywhere) < V
    spec = compile_schema(schema_path)
    per_building = [len(b.chargers) for b in spec.buildings]
    assert per_building[0] == 2 and per_building[1] == 0
    ch0, ch1 = spec.buildings[0].chargers
    assert len(set(ch0.charge_eff_y)) > 1                    # power-dependent efficiency
    assert ch1.min_charging_power > 0 and ch1.min_discharging_power > 0
    assert any(ch.max_discharging_power == 0 for b in spec.buildings for ch in b.chargers)


def _digest(root):
    h = hashlib.sha256()
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()


@pytest.mark.parametrize("writer,args", [
    (write_ev_dataset, (B, C, V, W, 200)),
    (write_battery_pv_dataset, (5, 200)),
    (write_thermal_dataset, (9, 200)),
], ids=["ev", "battery_pv", "thermal"])
def test_writers_are_deterministic(tmp_path, writer, args):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        d.mkdir()
        writer(str(d), *args, seed=3)
    assert _digest(str(a)) == _digest(str(b))
