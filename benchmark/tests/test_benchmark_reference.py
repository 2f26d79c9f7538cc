"""The reference agrees with the program at a small size on the CPU; the
control (the reference in the next lower precision in the program's place)
and every fault a cell can have, planted underneath a run, make ``correct``
come out false. The chip's look-up is skipped: these drive the rest of a
run on the CPU."""

import pytest
import torch

from benchmark import faults, harness
from benchmark.entries import gym, sac_train

BENCH = harness.load_benchmark()
TRAIN = "challenge2022_phase1.sac_train"
GYM = "challenge2022_phase1.gym_year"
SEED = 2 ** 31 + 17
CPU = torch.device("cpu")


def small(name: str, n_districts: int = 128):
    """The cell at a small size, with a 60-step episode so that its end
    comes within a few calls."""
    cell = harness.find_cell(BENCH, name)
    cell.traffic.update(n_districts=n_districts, hidden=[32, 32], batch_size=64,
                        replay_slots=16, chunk=16, warmup_steps=8, episode_time_steps=60)
    cell.config.update(n_rows=400)
    return cell


def correct(readings, cell) -> bool:
    return all(c.ok for c in harness.checks(readings, cell.traffic["limits"]))


def correct_where_read(readings, cell) -> bool:
    """The control's and the reference's planted faults give the first
    calls' numbers only: judged on those, at least one of which is there."""
    limits = {k: v for k, v in cell.traffic["limits"].items() if k in readings}
    assert len(limits) >= 6
    return all(c.ok for c in harness.checks(readings, limits))


def train_readings(cell, seconds=1.0):
    return sac_train.run_cell(cell, SEED, seconds, False, CPU)["readings"]


@pytest.fixture
def restore(monkeypatch):
    """Undo whatever a planted fault patches in the program's modules."""
    import citylearn_tpu_torch.train as train_mod
    from citylearn_tpu_torch.envs import environment as env_mod

    for mod, attr in ((train_mod, "sac_update"), (train_mod, "battery_collect_chunk"),
                      (train_mod.BatchedSAC, "_broadcast_initial"), (env_mod, "step_packed")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))


def test_training_agrees_with_the_reference():
    cell = small(TRAIN)
    readings = train_readings(cell)
    assert set(readings) == set(cell.traffic["limits"]) and readings["reset_gap"] == 0
    assert correct(readings, cell)


@pytest.mark.parametrize("fault", [faults.frozen_update, faults.half_batch, faults.altered_reward,
                                   faults.stale_reset])
def test_training_faults_fail(fault, restore):
    cell = small(TRAIN)
    readings = sac_train.run_cell(cell, SEED, 0.2, False, CPU, fault=fault)["readings"]
    assert not correct(readings, cell)
    if fault is faults.stale_reset:
        assert readings["reset_gap"] > 0


@pytest.mark.parametrize("what", ["tf32", "frozen_state", "half_batch", "altered_answer"])
def test_training_control_and_planted_reference_faults_fail(what):
    from benchmark import controls

    cell = small(TRAIN)
    assert not correct_where_read(controls.training_readings(cell, SEED, what, CPU), cell)


def gym_cell():
    cell = harness.find_cell(BENCH, GYM)
    cell.config.update(n_rows=300)
    cell.traffic.update(warmup_steps=8)
    return cell


def gym_correct(cell, readings) -> bool:
    return all(c.ok for c in harness.checks(readings, cell.traffic["limits"]))


def test_gym_agrees_with_the_reference():
    cell = gym_cell()
    out = gym.run_env(cell, SEED, 1.5, False, CPU)
    assert out["steps"] > 299 and gym_correct(cell, out["readings"])


@pytest.mark.parametrize("fault", [faults.frozen_env_step, faults.altered_env_reward])
def test_gym_faults_fail(fault, restore):
    cell = gym_cell()
    fault()
    assert not gym_correct(cell, gym.run_env(cell, SEED, 0.5, False, CPU)["readings"])


@pytest.mark.parametrize("what", ["bf16", "frozen_state", "altered_answer"])
def test_gym_control_and_planted_reference_faults_fail(what):
    from benchmark import controls

    cell = gym_cell()
    assert not gym_correct(cell, controls.gym_readings(cell, SEED, what))
