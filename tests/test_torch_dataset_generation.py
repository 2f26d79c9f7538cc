"""The port's dataset generation (``citylearn_tpu_torch.end_use_load_profiles``)
against the JAX package's on the CPU: the stage primitives, the numpy
KMeans against scikit-learn, the elbow clustering and the weighted
sampling, the LSTM trainer from the JAX package's initial weights, the
whole ``build`` on the synthetic RC backend, the generated dataset's
response to the ``cooling_device`` action in the port's env, and the
EnergyPlus adapter on the JAX test's fake SQLite output and IDF.

Tolerances. The primitives, the sampled ids and labels, the CSVs' text
and their float32 values read back, the schema and the normalization
bounds are equal to the bit (the same numpy). KMeans: labels equal, inertia within 1e-9 relative (the sums
run in another order than scikit-learn's Cython; measured within 3e-16).
The LSTM: XLA and PyTorch round float32 matmuls and their gradients in
another order, so the losses of every step are held to 1e-5 relative and
the weights after training to 1e-5 of their scale (measured: losses
within 1.7e-6 relative, weights within 4.2e-7 of scale).
The smoke run's KPI rows from those weights: 1e-5 of each value's scale."""

import json
import os
import sqlite3
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_energyplus_adapter as jax_ep_test  # noqa: E402
from citylearn_tpu.end_use_load_profiles import build as jb  # noqa: E402
from citylearn_tpu.end_use_load_profiles import energyplus as jep  # noqa: E402
from citylearn_tpu.end_use_load_profiles import lstm as jlstm  # noqa: E402
from citylearn_tpu.end_use_load_profiles.neighborhood import (  # noqa: E402
    Neighborhood as JaxNeighborhood,
)
from citylearn_tpu_torch import CityLearnEnv  # noqa: E402
from citylearn_tpu_torch.compiler.schema import read_csv_columns  # noqa: E402
from citylearn_tpu_torch.end_use_load_profiles import Neighborhood  # noqa: E402
from citylearn_tpu_torch.end_use_load_profiles import build as pb  # noqa: E402
from citylearn_tpu_torch.end_use_load_profiles import energyplus as pep  # noqa: E402
from citylearn_tpu_torch.end_use_load_profiles import lstm as plstm  # noqa: E402
from citylearn_tpu_torch.end_use_load_profiles.clustering import KMeans  # noqa: E402

TOL_LSTM = 1e-5


def assert_table_equals_frame(table, frame, where):
    assert list(table) == list(frame.columns), where
    for k in frame.columns:
        np.testing.assert_array_equal(np.asarray(table[k]), frame[k].to_numpy(),
                                      err_msg=f"{where}.{k}")
        assert np.asarray(table[k]).dtype == frame[k].dtype, (where, k)


def test_stage_primitives_equal_jax():
    f = np.random.RandomState(0).rand(50, 5)
    t = np.random.RandomState(1).rand(50)
    for a, b in zip(plstm.make_windows(f, t, 7), jlstm.make_windows(f, t, 7)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32
    for seed in (0, 3, 17):
        np.testing.assert_array_equal(pb.get_multipliers(500, seed), jb.get_multipliers(500, seed))
    c, h = np.random.RandomState(2).rand(2, 100)
    for a, b in zip(pb.single_load_per_time_step(c, h), jb.single_load_per_time_step(c, h)):
        np.testing.assert_array_equal(a, b)
    for seed in (0, 4):
        ours, ref = pb.RCSimulator(seed), jb.RCSimulator(seed)
        assert_table_equals_frame(ours.weather(100), ref.weather(100), "weather")
        assert_table_equals_frame(pb.expand_weather(ours.weather(100), random_seed=seed),
                                  jb.expand_weather(ref.weather(100), random_seed=seed),
                                  "expand_weather")
        for bldg in (0, 5):
            ideal = ours.simulate_ideal(bldg, 120)
            assert_table_equals_frame(ideal, ref.simulate_ideal(bldg, 120), "ideal")
            cool = ideal["cooling_demand"] * pb.get_multipliers(120, bldg)
            heat = np.zeros(120)
            assert_table_equals_frame(ours.simulate_partial(bldg, cool, heat),
                                      ref.simulate_partial(bldg, cool, heat), "partial")
            np.testing.assert_array_equal(
                pb._lstm_features(ideal, ours.weather(120)),
                jb._lstm_features(ref.simulate_ideal(bldg, 120), ref.weather(120)))


def blobs(seed):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-5, 5, (4, 6))
    return np.concatenate([c + rs.normal(0, 0.8, (rs.randint(8, 20), 6)) for c in centers])


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_equals_scikit_learn(seed):
    from sklearn.cluster import KMeans as SkKMeans

    X = blobs(seed)
    for k in range(2, 7):
        ours = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(X)
        ref = SkKMeans(n_clusters=k, random_state=seed, n_init=10).fit(X)
        np.testing.assert_array_equal(ours.labels_, ref.labels_)
        assert abs(ours.inertia_ - ref.inertia_) <= 1e-9 * ref.inertia_
        np.testing.assert_allclose(ours.cluster_centers_, ref.cluster_centers_, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(
            KMeans(n_clusters=k, random_state=seed).fit_predict(X), ref.labels_)
    assert list(Neighborhood().cluster_buildings(X, 3, seed)) == list(
        JaxNeighborhood().cluster_buildings(X, 3, seed))


@pytest.mark.parametrize("cluster,seed", [(True, 0), (True, 5), (False, 2)])
def test_clustering_and_sampling_equal_jax(cluster, seed):
    rs = np.random.RandomState(seed)
    profiles = np.concatenate([rs.normal(0, 0.1, (5, 24)), rs.normal(5, 0.1, (4, 24)),
                               rs.normal(-3, 0.3, (3, 24))])
    ids = [10 + i for i in range(len(profiles))]
    k, scores, labels = pb.optimal_clusters(profiles, random_seed=seed)
    jk, jscores, jlabels = jb.optimal_clusters(profiles, random_seed=seed)
    assert k == jk
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(scores["clusters"], jscores["clusters"].to_numpy())
    np.testing.assert_allclose(scores["sum_of_square_error"],
                               jscores["sum_of_square_error"].to_numpy(), rtol=1e-9)
    got = pb.sample_buildings(profiles, ids, sample_count=20, cluster=cluster,
                              random_seed=seed)
    ref = jb.sample_buildings(profiles, ids, sample_count=20, cluster=cluster,
                              random_seed=seed)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert all(type(x) is int for x in got[1])
    assert len(set(got[0])) > 1


def jax_training(features, target, lookback, hidden, layers, epochs, batch, lr, seed):
    """The JAX package's ``train_lstm`` loop, keeping every step's loss."""
    X, y = jlstm.make_windows(features, target, lookback)
    params = jlstm._init_lstm(jax.random.PRNGKey(seed), X.shape[-1], hidden, layers)
    init = {k: np.asarray(v) for k, v in params.items()}
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        loss = lambda p: jnp.mean((jlstm._forward(p, xb, layers, hidden) - yb) ** 2)
        l, g = jax.value_and_grad(loss)(params)
        u, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, u), opt_state, l

    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(epochs):
        order = rng.permutation(len(X))
        for i in range(0, len(X) - batch + 1, batch):
            sel = order[i:i + batch]
            params, opt_state, l = step(params, opt_state, jnp.asarray(X[sel]),
                                        jnp.asarray(y[sel]))
            losses.append(float(l))
    return init, {k: np.asarray(v) for k, v in params.items()}, np.asarray(losses)


def test_train_lstm_from_jax_weights_equals_jax():
    rs = np.random.RandomState(3)
    features = rs.rand(204, 13).astype(np.float32)
    target = (0.6 * features[:, 12] + 0.2 * features[:, 5]
              + 0.05 * rs.rand(204)).astype(np.float32)
    init, ref, ref_losses = jax_training(features, target, 4, 4, 2, 1, 32, 0.008, 7)
    assert len(ref_losses) == 200 // 32
    state, losses = plstm.fit_lstm(features, target, lookback=4, hidden=4, num_layers=2,
                                   epochs=1, batch_size=32, lr=0.008, seed=7, device="cpu",
                                   initial_state=init)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=TOL_LSTM)
    assert set(state) == set(ref)
    for k, v in ref.items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(state[k].numpy(), v, rtol=0, atol=TOL_LSTM * scale, err_msg=k)
        assert not np.array_equal(v, init[k]), k        # training moved every tensor
    # train_lstm is fit_lstm's state as numpy arrays; a seeded start of its own
    trained = plstm.train_lstm(features, target, 4, 4, 2, 1, 32, 0.008, 7, device="cpu",
                               initial_state=init)
    assert all(np.array_equal(trained[k], state[k].numpy()) for k in ref)
    own = plstm.train_lstm(features, target, 4, 4, 2, 0, 32, 0.008, 7, device="cpu")
    assert all(own[k].shape == init[k].shape and own[k].dtype == np.float32 for k in init)
    bound = 1 / np.sqrt(4)
    assert all(np.abs(v).max() <= bound for v in own.values())
    assert not np.array_equal(own["l_linear.weight"], init["l_linear.weight"])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """``build`` of both packages at sample_count=2, 96 steps, 2 epochs,
    the port's LSTMs started from the JAX package's initial weights."""
    ours_dir, ref_dir = tmp_path_factory.mktemp("ours"), tmp_path_factory.mktemp("ref")
    kw = dict(sample_count=2, n_time_steps=96, partial_loads_simulations=2,
              lstm_kwargs=dict(epochs=2, batch_size=32), random_seed=0)
    ref = JaxNeighborhood().build(str(ref_dir), **kw)
    shipped = plstm._init_lstm
    plstm._init_lstm = lambda gen, n_in, hidden, layers: {
        k: torch.tensor(np.asarray(v)) for k, v in
        jlstm._init_lstm(jax.random.PRNGKey(0), n_in, hidden, layers).items()}
    try:
        ours = Neighborhood().build(str(ours_dir), device="cpu", **kw)
    finally:
        plstm._init_lstm = shipped
    return ours, ref


def test_build_equals_jax(built):
    ours, ref = built
    assert ours.bldg_ids == ref.bldg_ids and ours.sample_cluster_labels == ref.sample_cluster_labels
    root, ref_root = (os.path.dirname(r.schema_filepath) for r in (ours, ref))
    files = sorted(f for f in os.listdir(ref_root) if f.endswith(".csv"))
    assert files == sorted(f for f in os.listdir(root) if f.endswith(".csv"))
    for name in files:
        # the same text as pandas' to_csv, and the same float32 values as
        # each compiler reads them (csv and pandas parse the text apart)
        with open(os.path.join(root, name)) as f, open(os.path.join(ref_root, name)) as g:
            assert f.read() == g.read(), name
        a = read_csv_columns(os.path.join(root, name))
        b = pd.read_csv(os.path.join(ref_root, name))
        assert list(a) == list(b.columns), name
        for k in b.columns:
            np.testing.assert_array_equal(a[k].astype(np.float32),
                                          b[k].to_numpy(dtype=np.float32), err_msg=k)
    with open(ours.schema_filepath) as f:
        schema = json.load(f)
    with open(ref.schema_filepath) as f:
        ref_schema = json.load(f)
    assert schema.pop("root_directory") == root and ref_schema.pop("root_directory") == ref_root
    assert schema == ref_schema         # the normalization bounds among the rest
    for i, (state, ref_state) in enumerate(zip(ours.lstm_models, ref.lstm_models)):
        saved = torch.load(os.path.join(root, f"Building_{i + 1}.pth"))
        assert set(saved) == set(ref_state)
        for k, v in ref_state.items():
            assert saved[k].device.type == "cpu" and saved[k].dtype == torch.float32
            np.testing.assert_array_equal(saved[k].numpy(), state[k])
            scale = max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(state[k], v, rtol=0, atol=TOL_LSTM * scale, err_msg=k)
    rows = ours.citylearn_simulation_test_evaluation
    frame = ref.citylearn_simulation_test_evaluation
    assert len(rows) == len(frame)
    for row, (_, r) in zip(rows, frame.iterrows()):
        assert (row["cost_function"], row["name"], row["level"]) == (
            r.cost_function, r["name"], r.level)
        x, y = row["value"], float(r.value)
        if np.isnan(y):
            assert x is None or np.isnan(x), (r.cost_function, r["name"])
        else:
            assert abs(x - y) <= TOL_LSTM * max(1.0, abs(y)), (r.cost_function, x, y)


def test_generated_dynamics_respond_to_partial_load(built):
    """The JAX test's check (``tests/test_build_pipeline.py``) on the port's
    env: different ``cooling_device`` actions, different temperatures."""
    ours, _ = built

    def run(action):
        env = CityLearnEnv(ours.schema_filepath, episode_time_steps=48, random_seed=0,
                           device="cpu")
        env.reset()
        while not env.terminated:
            env.step([[action if n == "cooling_device" else 0.0 for n in names]
                      for names in env.action_names])
        return np.asarray(env.buildings[0].energy_simulation
                          .indoor_dry_bulb_temperature[-24:], float)

    t_off, t_full = run(0.0), run(1.0)
    assert np.isfinite(t_off).all() and np.isfinite(t_full).all()
    assert np.abs(t_off - t_full).max() > 1e-3


def _adapters(tmp_path):
    """The port's and the JAX package's ``EnergyPlusSimulator`` on the JAX
    test's fake runner (its SQLite output) and IDF, each capturing the
    IDF text it was handed."""
    epw = tmp_path / "weather.epw"
    epw.write_text("\n".join(["LOCATION,x,x,x,x,x,40.0,-105.0,-7.0,1650"] + [
        ",".join(["1970", "1", "1", str(h % 24 + 1), "0", "x", "15.0", "0", "0", "0", "0",
                  "0", "0", "400", "600", "150", "0", "0", "0", "0", "0", "3.0"])
        for h in range(jax_ep_test.N)]))
    out = []
    for module, tag in ((pep, "ours"), (jep, "ref")):
        captured = {}

        def runner(idf_path, epw_path, out_dir, captured=captured):
            with open(idf_path) as f:
                captured[os.path.basename(out_dir)] = f.read()
            sql = os.path.join(out_dir, "eplusout.sql")
            if os.path.exists(sql):
                os.remove(sql)
            jax_ep_test._make_sqlite(sql, with_other_equipment="partial" in out_dir)
            return sql

        sim = module.EnergyPlusSimulator(
            model_provider=lambda bldg_id: {"idf": jax_ep_test.IDF, "epw": str(epw)},
            run_energyplus=runner, output_directory=str(tmp_path / tag))
        sim._captured = captured
        out.append(sim)
    return out


def test_energyplus_adapter_equals_jax(tmp_path):
    ours, ref = _adapters(tmp_path)
    n = jax_ep_test.N
    assert_table_equals_frame(ours.weather(n), ref.weather(n), "weather")
    ideal = ours.simulate_ideal(7, n)
    assert_table_equals_frame(ideal, ref.simulate_ideal(7, n), "ideal")
    assert abs(ideal["indoor_dry_bulb_temperature"][0] - (0.75 * 20.0 + 0.25 * 30.0)) < 1e-9
    cooling, heating = np.linspace(0, 2, n), np.linspace(1, 0, n)
    assert_table_equals_frame(ours.simulate_partial(7, cooling, heating),
                              ref.simulate_partial(7, cooling, heating), "partial")
    # the same IDF text, apart from the loads file's directory
    assert set(ours._captured) == set(ref._captured) == {"7_ideal", "7_partial"}
    for k, idf in ref._captured.items():
        assert (ours._captured[k].replace(str(tmp_path / "ours"), "<out>")
                == idf.replace(str(tmp_path / "ref"), "<out>")), k
    assert "IdealLoadsAirSystem" not in ours._captured["7_partial"]
    for tag in ("ours", "ref"):
        assert os.path.exists(tmp_path / tag / "7_partial" / "partial_load.csv")
    with open(tmp_path / "ours" / "7_partial" / "partial_load.csv") as a, \
            open(tmp_path / "ref" / "7_partial" / "partial_load.csv") as b:
        assert a.read() == b.read()
    sql = str(tmp_path / "ours" / "7_ideal" / "eplusout.sql")
    loads, ref_loads = pep.extract_ideal_loads(sql), jep.extract_ideal_loads(sql)
    assert list(loads) == list(ref_loads.columns)
    for k in ref_loads.columns:
        np.testing.assert_array_equal(loads[k], ref_loads[k].to_numpy(), err_msg=k)
    assert pep._zone_weights(sql) == dict(
        jep._zone_weights(sql).set_index("ZoneName")["weight"])
    idf = pep.add_other_equipment(pep.remove_ideal_loads_air_system(jax_ep_test.IDF),
                                  ["LIVING", "ATTIC"], "loads.csv", n, 15)
    assert idf == jep.add_other_equipment(jep.remove_ideal_loads_air_system(jax_ep_test.IDF),
                                          ["LIVING", "ATTIC"], "loads.csv", n, 15)


def test_energyplus_extraction_with_nulls_and_gaps(tmp_path):
    """A NULL key, a NaN value and a time index that only one variable
    reports: the port's frame equals the JAX package's."""
    sql = str(tmp_path / "gaps.sql")
    jax_ep_test._make_sqlite(sql, with_other_equipment=True)
    with sqlite3.connect(sql) as con:
        con.execute("INSERT INTO ReportDataDictionary VALUES (99, 'Zone People Occupant Count', "
                    "NULL)")
        con.execute("INSERT INTO ReportData VALUES (3, 99, 1.5)")
        con.execute("INSERT INTO ReportData VALUES (200, 99, 4.0)")
        con.execute("INSERT INTO ReportData VALUES (5, 1, NULL)")
    assert_table_equals_frame(pep.extract_energy_simulation(sql),
                              jep.extract_energy_simulation(sql), "energy_simulation")
