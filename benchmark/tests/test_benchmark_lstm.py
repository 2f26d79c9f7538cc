"""The per-step LSTM cell (``challenge2023_phase1.sac_train``): found by
name from files alone; the reference agrees with the program at D=128 on
the CPU; the control (the reference with TF32 products in the program's
place) and every fault, planted in the program underneath a run or in the
reference in the program's place, make ``correct`` come out false; and a
run loads no JAX module. The chip's look-up is skipped: these drive the
rest of a run on the CPU."""

import json

import pytest
import torch

from benchmark import controls_scan, faults, faults_scan, harness
from benchmark.entries import sac_train_scan
from benchmark.reference.train_scan import FAULTS
from benchmark.tests.test_benchmark_isolation import _python

BENCH = harness.load_benchmark()
CELL = "challenge2023_phase1.sac_train"
SEED = 2 ** 31 + 17
CPU = torch.device("cpu")
NEW_METRICS = {"district_step_ms.scan", "dynamics_ms.scan", "step_launches.scan",
               "sac_update_ms.scan", "device_idle.scan"}


def small(n_districts: int = 128):
    """The cell at a small size, with a 40-step episode so that its end
    comes within a few calls."""
    cell = harness.find_cell(BENCH, CELL)
    cell.traffic.update(n_districts=n_districts, hidden=[32, 32], batch_size=64,
                        replay_slots=16, chunk=16, warmup_steps=8, episode_time_steps=40)
    cell.config.update(n_rows=300)
    return cell


def correct(readings, cell, where_read=False) -> bool:
    limits = cell.traffic["limits"]
    if where_read:
        limits = {k: v for k, v in limits.items() if k in readings}
        assert len(limits) >= 7
    return all(c.ok for c in harness.checks(readings, limits))


@pytest.fixture
def restore(monkeypatch):
    """Undo whatever a planted fault patches in the program's modules."""
    import citylearn_tpu_torch.core.step as step_mod
    import citylearn_tpu_torch.train as train_mod

    for mod, attr in ((train_mod, "sac_update"), (train_mod, "district_step"),
                      (train_mod.BatchedSAC, "_broadcast_initial"),
                      (step_mod, "dynamics_update")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))


def test_the_cell_is_found_by_name_from_files_alone():
    cell = harness.find_cell(BENCH, CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "sac_train_scan"
    assert cell.config["name"] == "challenge2023_phase1" and cell.config["lstm"] == {
        **cell.config["lstm"], "num_layers": 2, "hidden_size": 8, "lookback": 12}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "train_dsteps_per_s"}
    assert {m["name"] for m in cell.per_layer} == NEW_METRICS
    for name in NEW_METRICS:
        assert harness.load_reader(name)(harness.Run()) is None
    # the older cells report none of the new metrics
    for w in BENCH["workloads"]:
        if w["name"] != CELL:
            assert not NEW_METRICS & {m["name"] for m in harness.find_cell(BENCH, w["name"]).per_layer}


def test_the_program_agrees_with_the_reference():
    cell = small()
    readings = sac_train_scan.run_cell(cell, SEED, 0.5, False, CPU)["readings"]
    assert set(readings) == set(cell.traffic["limits"]) and readings["reset_gap"] == 0
    assert correct(readings, cell)


@pytest.mark.parametrize("fault", [faults.frozen_update, faults.half_batch, faults.stale_reset,
                                   faults_scan.altered_action, faults_scan.lstm_uncarried])
def test_program_faults_fail(fault, restore):
    cell = small()
    readings = sac_train_scan.run_cell(cell, SEED, 0.1, False, CPU, fault=fault)["readings"]
    assert not correct(readings, cell)
    if fault is faults.stale_reset:
        assert readings["reset_gap"] > 0


@pytest.mark.parametrize("what", ["tf32", *FAULTS])
def test_the_control_and_planted_reference_faults_fail(what):
    cell = small()
    assert not correct(controls_scan.readings(cell, SEED, what, CPU), cell, where_read=True)


def test_a_run_and_its_reference_load_no_jax():
    code = """
import json, torch
from benchmark import controls_scan, harness
from benchmark.entries import sac_train_scan
from benchmark.reference import lstm_district, train_scan
cell = harness.find_cell(harness.load_benchmark(), "challenge2023_phase1.sac_train")
cell.traffic.update(n_districts=16, hidden=[16, 16], batch_size=32, replay_slots=16, chunk=16,
                    episode_time_steps=30)
cell.config.update(n_rows=100)
sac_train_scan.run_cell(cell, 3, 0.2, False, torch.device("cpu"))
print(json.dumps(harness.forbidden_modules()))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
from benchmark.reference import lstm_district, train_scan
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0].startswith("citylearn")
                        or n.split(".")[0] in ("jax", "jaxlib", "flax"))))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
