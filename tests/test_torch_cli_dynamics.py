"""The port's CLI against the JAX package's on the dynamics districts (the
seeded synthetic LSTM district and the EULP and quebec neighborhoods of
``tests/_env_parity.py``): ``Simulator.evaluate`` with and without
``fast`` (K5's, and K6's and P6's, plain versions on the CPU), pivots and
time series against JAX's and against each other (``tests/_cli_parity.py``;
the neighborhoods at 72 rows keep JAX's Pallas interpret mode quick); a
shifted evaluation window both ways; and ``--fast`` refusing a shifted
window of a stochastic-outage district, as JAX's does."""

import pytest

import _cli_parity as cp
import _env_parity as ep


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    writers = {k: ep.WRITERS[k] for k in ("battery", "lstm", "lstm_outage")}
    writers.update({k: ep.NEIGHBORHOOD_WRITERS[k] for k in ("eulp", "quebec")})
    return ep.write_all(tmp_path_factory, writers)


@pytest.mark.parametrize("family,agent,rows", [
    ("lstm", "citylearn.agents.rbc.BasicRBC", 168),
    ("eulp", "citylearn.agents.rbc.BasicRBC", 72),
    ("quebec", "citylearn.agents.rbc.OptimizedRBC", 72),
])
def test_evaluate_matches_jax(schemas, tmp_path, family, agent, rows):
    cp.check_family(str(tmp_path), schemas[family], agent, rows)


def test_shifted_window_both_ways(schemas, tmp_path):
    """``evaluation_episode_time_steps`` = (24, 95): the episode starts at
    the data's row 24, and the kernel path follows the offset."""
    out = str(tmp_path)
    runs = {}
    for port in (True, False):
        for fast in (True, False):
            sid = f"{port}-{fast}"
            cls = cp.Simulator if port else cp.JaxSimulator
            cls.evaluate(schema=schemas["battery"], agent_name="citylearn.agents.rbc.BasicRBC",
                         env_kwargs={"device": "cpu"} if port else {},
                         evaluation_episode_time_steps=(24, 95), simulation_id=sid,
                         output_directory=out, fast=fast)
            runs[port, fast] = cp.load(out, sid)
    for fast in (True, False):
        cp.assert_pivots_close(runs[True, fast]["kpis"], runs[False, fast]["kpis"])
        cp.assert_series_close(runs[True, fast]["time_series"],
                               runs[False, fast]["time_series"])
    cp.assert_pivots_close(runs[True, True]["kpis"], runs[True, False]["kpis"])
    assert len(runs[True, True]["time_series"]["Building_1"]["non_shiftable_load"]) == 72


def test_fast_refuses_a_shifted_stochastic_outage_window(schemas, tmp_path):
    for cls in (cp.Simulator, cp.JaxSimulator):
        with pytest.raises(ValueError, match="stochastic-outage"):
            cls.evaluate(schema=schemas["lstm_outage"], agent_name="citylearn.agents.rbc.BasicRBC",
                         env_kwargs={"device": "cpu"} if cls is cp.Simulator else {},
                         evaluation_episode_time_steps=(24, 71), output_directory=str(tmp_path),
                         fast=True)
