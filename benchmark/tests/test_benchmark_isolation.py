"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program; a run
without a card, or without the program beside it, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = str(harness.ROOT)


def _python(code: str, cwd: str = ROOT):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_whole_top_level_names(monkeypatch):
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    import types

    for name in ("citylearn_tpu_torch_probe.x", "jaxprobe", "flaxen.y"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = harness.forbidden_modules()
    assert not [n for n in before if "probe" in n or n.startswith("flaxen")]
    for name in ("citylearn_tpu.core", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"citylearn_tpu.core", "jax.numpy"} <= set(harness.forbidden_modules())


def test_a_run_and_its_reference_load_no_jax():
    code = """
import json, sys, torch
from benchmark import controls, harness
from benchmark.entries import gym, sac_train
from benchmark.reference import battery, district, env, sac, train
cell = harness.find_cell(harness.load_benchmark(), "challenge2022_phase1.sac_train")
cell.traffic.update(n_districts=128, hidden=[16, 16], batch_size=32, replay_slots=16, chunk=16,
                    episode_time_steps=40)
cell.config.update(n_rows=300)
out = sac_train.run_cell(cell, 3, 0.2, False, torch.device("cpu"))
g = harness.find_cell(harness.load_benchmark(), "challenge2022_phase1.gym_year")
g.config.update(n_rows=100)
gym.run_env(g, 3, 0.2, False, torch.device("cpu"))
print(json.dumps(harness.forbidden_modules()))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
from benchmark.reference import battery, district, env, sac, train
from benchmark.frozen import counts, synthetic
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0].startswith("citylearn"))))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_a_card():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "challenge2022_phase1.gym_year", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "challenge2022_phase1.sac_train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "challenge2022_phase1.gym_year", "--seed", "7", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"setup_s", "env_steps_per_s", "env_step_p95_ms"}
