"""The port's CLI (``citylearn_tpu_torch.cli``) against the JAX package's
on the seeded synthetic battery+PV, thermal and EV districts:
``Simulator.evaluate`` with and without ``fast`` (on the CPU the whole
episode runs through the kernels' plain versions), pivots and time series
against JAX's and against each other (``tests/_cli_parity.py``); class
resolution of ``citylearn.*`` and ``citylearn_tpu.*`` paths with neither
JAX nor the JAX package importable, ``cli.main`` end to end; the dataset
catalog, without network; ``--fast`` refusing a closed-loop agent; and
``train --save_agent`` followed by ``evaluate -fa``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _cli_parity as cp
import _env_parity as ep
from citylearn_tpu_torch import cli
from citylearn_tpu_torch.data import DataSet
from citylearn_tpu_torch.synthetic import write_thermal_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    # the thermal district without heating: the shape that K3 serves
    return ep.write_all(tmp_path_factory, {
        "battery": ep.WRITERS["battery"], "ev": ep.WRITERS["ev"],
        "thermal": lambda root: write_thermal_dataset(root, 4, 200, seed=3)})


@pytest.mark.parametrize("family,agent,rows", [
    ("battery", "citylearn.agents.rbc.BasicRBC", 168),
    ("thermal", "citylearn.agents.rbc.OptimizedRBC", 168),
    ("ev", "citylearn.agents.rbc.BasicElectricVehicleRBC_ReferenceController", 168),
])
def test_evaluate_matches_jax(schemas, tmp_path, family, agent, rows):
    cp.check_family(str(tmp_path), schemas[family], agent, rows)


def test_baseline_agent_evaluates_both_ways(schemas, tmp_path):
    runs = {fast: cp.evaluate(str(tmp_path), schemas["battery"],
                              "citylearn.agents.base.BaselineAgent", 48, fast)
            for fast in (True, False)}
    ref = cp.evaluate(str(tmp_path), schemas["battery"], "citylearn.agents.base.BaselineAgent",
                      48, False, port=False)
    cp.assert_pivots_close(runs[True]["kpis"], runs[False]["kpis"])
    cp.assert_pivots_close(runs[False]["kpis"], ref["kpis"])


def test_resolve_class_and_main_without_jax(schemas, tmp_path):
    """``citylearn.*``, ``citylearn_tpu.*`` and the port's own paths resolve
    to the port's classes, and ``cli.main`` runs ``simulate ... evaluate
    --fast`` and ``list_datasets`` end to end, with ``jax`` and
    ``citylearn_tpu`` unimportable."""
    root = tmp_path / "datasets"
    root.mkdir()
    os.symlink(os.path.dirname(schemas["battery"]), root / "battery_named")
    out = tmp_path / "out"
    code = (
        "import sys; sys.modules['jax'] = sys.modules['citylearn_tpu'] = None\n"
        "sys.modules['requests'] = None\n"
        "import json\n"
        "from citylearn_tpu_torch import cli\n"
        "paths = ['citylearn.agents.rbc.BasicRBC', 'citylearn_tpu.agents.rbc.BasicRBC',\n"
        "         'citylearn_tpu_torch.agents.rbc.BasicRBC', 'citylearn.agents.sac.SAC',\n"
        "         'citylearn_tpu.agents.marlisa.MARLISA', 'citylearn.wrappers.NormalizedSpaceWrapper',\n"
        "         'citylearn.citylearn.CityLearnEnv', 'citylearn_tpu.CityLearnEnv',\n"
        "         'citylearn_tpu.envs.environment.CityLearnEnv']\n"
        "print(' '.join(cli.resolve_class(p).__module__ for p in paths))\n"
        f"cli.main(['simulate', 'battery_named', 'evaluate', '--fast', '-a',\n"
        f"          'citylearn_tpu.agents.rbc.BasicRBC', '-k', json.dumps(dict(device='cpu',\n"
        f"          episode_time_steps=24)), '-d', {str(out)!r}, '-id', 'fast'])\n"
        "cli.main(['list_datasets'])\n"
        "try:\n    cli.DataSet().get_dataset('citylearn_challenge_2022_phase_1')\n"
        "except FileNotFoundError as e:\n    print('not found' if 'none of the roots' in str(e) else e)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'citylearn_tpu')))\n")
    env = dict(os.environ, CITYLEARN_DATA_ROOT=str(root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].split() == [
        "citylearn_tpu_torch.agents.rbc"] * 3 + ["citylearn_tpu_torch.agents.sac",
                                                  "citylearn_tpu_torch.agents.marlisa",
                                                  "citylearn_tpu_torch.wrappers"] + [
        "citylearn_tpu_torch.envs.environment"] * 3
    assert "battery_named" in lines[1:-2] and lines[-2] == "not found"
    assert lines[-1] == "['citylearn_tpu', 'jax']"         # the None entries only
    summary = json.load(open(out / "fast-evaluation.json"))
    assert summary["kpis"]["cost_total"]["District"] > 0
    assert len(summary["time_series"]["Building_1"]["net_electricity_consumption"]) == 24


def test_dataset_catalog(schemas, tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    for root, names in ((a, ("battery_x",)), (b, ("battery_x", "thermal_y"))):
        root.mkdir()
        for name in names:
            family = name.split("_")[0]
            os.symlink(os.path.dirname(schemas[family]), root / name)
    (b / "not_a_dataset").mkdir()
    cat = DataSet([str(a), str(b)])
    assert cat.get_dataset_names() == ["battery_x", "thermal_y"]
    assert cat.get_dataset("battery_x") == str(a / "battery_x")      # the first root wins
    assert cat.get_schema_path("thermal_y") == str(b / "thermal_y" / "schema.json")
    schema = cat.get_schema("thermal_y")
    assert schema["root_directory"] == str(b / "thermal_y") and "buildings" in schema
    with pytest.raises(FileNotFoundError, match="none of the roots") as err:
        cat.get_dataset("citylearn_challenge_2022_phase_1")
    assert str(a) in str(err.value) and str(b) in str(err.value)
    # the sizing files: none under an empty misc root
    monkeypatch.setenv("CITYLEARN_MISC_ROOT", str(a))
    with pytest.raises(FileNotFoundError, match="battery_choices"):
        cat.get_battery_sizing_data()
    assert len(cat.get_pv_sizing_data()["tilt_1"]) == 500         # the synthetic stand-in
    monkeypatch.setenv("CITYLEARN_DATA_ROOT", str(b))
    assert DataSet().roots[0] == str(b) and "thermal_y" in DataSet().get_dataset_names()
    monkeypatch.setattr(sys, "argv", ["citylearn-tpu-torch"])
    cli.main(["list_datasets"])


def test_fast_refuses_a_closed_loop_agent(schemas, tmp_path):
    with pytest.raises(ValueError, match="open-loop agent"):
        cp.evaluate(str(tmp_path), schemas["battery"], "citylearn.agents.sac.SAC", 24, True)


def test_train_save_agent_then_evaluate_from_file(schemas, tmp_path):
    out = str(tmp_path)
    kwargs = json.dumps({"device": "cpu", "episode_time_steps": 48})
    agent_kwargs = json.dumps({"hidden_dimension": [16, 16], "batch_size": 16,
                               "standardize_start_time_step": 24,
                               "end_exploration_time_step": 24})
    cli.main(["simulate", schemas["battery"], "train", "-a", "citylearn.agents.sac.SAC",
              "-k", kwargs, "-ak", agent_kwargs, "-d", out, "-id", "sac", "--save_agent",
              "-rs", "3"])
    train = json.load(open(os.path.join(out, "sac-train.json")))
    assert train["agent"] == "citylearn.agents.sac.SAC"
    assert np.isfinite(train["reward_summary"]["sum"]).all()
    cli.main(["simulate", schemas["battery"], "evaluate", "-fa",
              os.path.join(out, "sac-agent.pkl"), "-k", kwargs, "-d", out, "-id", "eval"])
    summary = json.load(open(os.path.join(out, "eval-evaluation.json")))
    values = [v for cols in summary["kpis"].values() for v in cols.values() if v is not None]
    assert len(values) > 20 and np.isfinite(values).all()
    import pickle
    with open(os.path.join(out, "sac-agent.pkl"), "rb") as f:
        agent = pickle.load(f)
    assert agent.time_step == 47 and all(agent.normalized)
    assert agent.random_seed == 3
