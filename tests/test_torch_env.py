"""The port's Gym env (``citylearn_tpu_torch.CityLearnEnv`` on the CPU)
against the JAX package's ``citylearn_tpu.CityLearnEnv`` on the seeded
synthetic battery+PV, thermal, EV (plain and with charging constraints)
and LSTM (plain and with a stochastic outage) districts (the neighborhood
districts and ``tests/golden/quebec_occ`` are in
``test_torch_env_neighborhood.py``):
reset and step observations, rewards, ``terminated``, ``episode_rewards``,
the history and the ``evaluate()`` table, decentral and central; the
spaces and ``get_metadata``; rolling and random episode splits over two
resets; and the env's table against the port's batched
``evaluate_districts`` (the JAX package's ``test_evaluate_batched``
pattern).

Tolerances: 1e-5 of each series' scale (``tests/_env_parity.py``), the
series and KPI tolerance of the port's other tests (XLA:CPU fuses
multiply-adds where the port rounds twice, and the LSTM's float32
products sum in another order); 2e-5 relative between the env's table and
``evaluate_districts``, as in the JAX package's
``tests/test_evaluate_batched.py:60``."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import _env_parity as ep
from citylearn_tpu_torch import CityLearnEnv
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.rollout import batched_initial_states, hour_rbc_policy

TOL = 1e-5
FAMILIES = list(ep.WRITERS)
#: episode rows, decentral and central (the same step function; the
#: central agent changes the observation merge, the action split and the
#: reward sum); whole days, as the stochastic outage model draws them
EPISODE = {False: 168, True: 48}


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    return ep.write_all(tmp_path_factory)


@pytest.mark.parametrize("central", [False, True], ids=["decentral", "central"])
@pytest.mark.parametrize("family", FAMILIES)
def test_episode_matches_jax(schemas, family, central):
    ep.check_episode(schemas[family], central, EPISODE[central], TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_spaces_and_metadata_match_jax(schemas, family):
    ep.check_spaces_and_metadata(schemas[family])


@pytest.mark.parametrize("split", ["rolling", "random"])
def test_episode_splits_match_jax(schemas, split):
    """Two resets of 24-step episodes over the 200-row district: the
    rolling split advances one step per episode, the random one draws its
    window from the seed (and never the last one, the reference's quirk);
    the stochastic outage is re-baked at each window."""
    kw = dict(episode_time_steps=24, random_seed=5,
              **{f"{split}_episode_split": True})
    for family in ("battery", "lstm_outage"):
        ours, ref = ep.pair(schemas[family], **kw)
        for _ in range(2):
            ep.run_episode(ours, ref, 30, seed=3, tol=TOL)
            assert (ours.episode_tracker.episode_start_time_step
                    == ref.episode_tracker.episode_start_time_step)
            assert ours.episode_tracker.episode == ref.episode_tracker.episode
            ep.assert_history_close(ours, ref, TOL)
            ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL)
        assert len(ours.episode_rewards) == 2


def _rbc_table():
    table = np.full(24, -0.08, np.float32)
    for h in list(range(22, 25)) + list(range(1, 9)):
        table[h - 1] = 0.091
    return table


@pytest.mark.parametrize("family", ["battery", "thermal"])
def test_env_table_matches_evaluate_districts(schemas, family):
    """The env stepping an hour-RBC plan against the port's batched
    ``evaluate_districts`` on the same district (district 0 of 4)."""
    env = CityLearnEnv(schemas[family], random_seed=0, episode_time_steps=169, device="cpu")
    table = _rbc_table()
    action = "electrical_storage" if family == "battery" else "cooling_storage"
    states = batched_initial_states(env.cfg, env.params, 4, device="cpu")
    out = evaluate_districts(env.cfg, env.params, states, hour_rbc_policy(table, action),
                             device="cpu")
    env.reset()
    while not env.terminated:
        hour = int(env.buildings[0].energy_simulation.hour[env.time_step])
        a = float(table[hour - 1])
        env.step([[a if name == action else 0.0 for name in b.active_actions]
                  for b in env.spec.buildings])
    rows = env.evaluate_rows()
    host = {f"{r['level']}|{r['cost_function']}|{r['name']}": r["value"] for r in rows}
    checked = 0
    for key, v in out.items():
        level, kpi = key.split("|")
        names = (["District"] if level == "district"
                 else [b.name for b in env.spec.buildings])
        got = v[0].reshape(-1).numpy()
        for i, name in enumerate(names):
            want = host[f"{level}|{kpi}|{name}"]
            if want is None or np.isnan(want):
                assert np.isnan(got[i]), key
                continue
            assert abs(float(got[i]) - want) <= 2e-5 * max(1.0, abs(want)), (key, name)
            checked += 1
    assert checked > 50


def test_named_dataset_and_load_agent_raise(schemas, tmp_path, monkeypatch):
    """A name in no root raises, listing the roots, and downloads nothing;
    a name under ``CITYLEARN_DATA_ROOT`` resolves to its schema; and
    ``load_agent`` builds the schema's agent, a named one or a class,
    with ``citylearn.*`` and ``citylearn_tpu.*`` paths on the port's
    agents."""
    monkeypatch.setenv("CITYLEARN_DATA_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="none of the roots"):
        CityLearnEnv("no_such_dataset", device="cpu")
    os.symlink(os.path.dirname(schemas["battery"]), tmp_path / "battery_named")
    env = CityLearnEnv("battery_named", episode_time_steps=5, device="cpu")
    assert env.spec.buildings[0].name == \
        CityLearnEnv(schemas["battery"], device="cpu").spec.buildings[0].name
    from citylearn_tpu_torch.agents import BaselineAgent, BasicRBC, OptimizedRBC
    assert type(env.load_agent("citylearn.agents.rbc.BasicRBC")) is BasicRBC
    assert type(env.load_agent("citylearn_tpu.agents.rbc.OptimizedRBC")) is OptimizedRBC
    assert type(env.load_agent(BasicRBC)) is BasicRBC
    # the synthetic schema names the reference's BaselineAgent
    assert env.spec.schema["agent"]["type"] == "citylearn.agents.base.BaselineAgent"
    agent = env.load_agent()
    assert type(agent) is BaselineAgent and agent.env is env


def test_default_device_raises_without_card(schemas):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CityLearnEnv(schemas["battery"])


def test_runs_without_gymnasium_and_pandas(schemas):
    """With gymnasium and pandas unimportable the env still resets, steps,
    scores and serves its spaces (the port's ``Box``, with the bounds
    gymnasium's would have); only the ``evaluate()`` frame needs pandas."""
    code = (
        "import sys; sys.modules['gymnasium'] = None; sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "from citylearn_tpu_torch import CityLearnEnv\n"
        "from citylearn_tpu_torch.spaces import Box\n"
        f"env = CityLearnEnv({schemas['ev']!r}, episode_time_steps=12, device='cpu')\n"
        "obs, _ = env.reset()\n"
        "acts = [[0.5] * len(b.active_actions) for b in env.spec.buildings]\n"
        "while not env.terminated: obs, r, *_ = env.step(acts)\n"
        "rows = env.evaluate_rows()\n"
        "spaces = env.observation_space + env.action_space + [env.buildings[0].action_space]\n"
        "print(all(type(s) is Box for s in spaces))\n"
        "np.save(sys.argv[1], np.concatenate([np.concatenate([s.low, s.high]) for s in spaces]))\n"
        "try:\n    env.evaluate()\nexcept ImportError:\n    print('no frame')\n"
        "print(len(rows), rows[0]['name'])\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bounds.npy")
        out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                             text=True, check=True,
                             cwd=os.path.dirname(os.path.dirname(__file__)))
        bounds = np.load(path)
    lines = out.stdout.split()
    assert lines[:3] == ["True", "no", "frame"]
    assert lines[-1] == "District" and int(lines[-2]) > 50
    env = CityLearnEnv(schemas["ev"], episode_time_steps=12, device="cpu")
    spaces = env.observation_space + env.action_space + [env.buildings[0].action_space]
    assert np.array_equal(bounds, np.concatenate([np.concatenate([s.low, s.high])
                                                  for s in spaces]))
