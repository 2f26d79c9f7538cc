"""The port's host-loop learning agents against the JAX package's, on the
seeded synthetic battery+PV district: ``SAC`` (exploration actions, replay
buffers, normalization statistics, one step of updates from carried
weights), ``SACRBC``, ``TabularQLearning`` and ``MARLISA`` with its numpy
``PCA`` and ``LinearRegression``.

Both agents of a pair see the same transitions, taken from the port's env,
so that what they compute from them can be held exactly: exploration
actions and replay sampling come from ``np.random.RandomState(random_seed)``
in both packages, so the actions, the buffers and the normalization
statistics are equal to the bit. Through each package's own env
(``learn``) the observations differ by the envs' float32 rounding, and the
buffers agree within 1e-6 of their scale.

The SAC updates run on weights carried from the JAX agent
(``nets_from_numpy``) with the JAX agent's key splits replayed into the
port's ``PolicyNoise``; weights, targets and Adam moments within 1e-6
absolute and actions within 1e-5 of scale, the tolerances of
``tests/test_torch_sac.py``.

The numpy PCA and regression: within 1e-6 of scale of scikit-learn's, the
components with the same signs."""

import jax
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA as SkPCA
from sklearn.linear_model import LinearRegression as SkLinearRegression

import _env_parity as ep
import citylearn_tpu
from citylearn_tpu.agents import marlisa as jax_marlisa
from citylearn_tpu.agents import q_learning as jax_q_learning
from citylearn_tpu.agents import sac as jax_sac
from citylearn_tpu.wrappers import TabularQLearningWrapper as JaxTabularQLearningWrapper
from citylearn_tpu_torch import CityLearnEnv
from citylearn_tpu_torch.agents import marlisa, q_learning, sac
from citylearn_tpu_torch.wrappers import TabularQLearningWrapper

ROWS = 49
SAC_KW = dict(hidden_dimension=[16, 16], batch_size=16, standardize_start_time_step=20,
              end_exploration_time_step=10_000)
MARLISA_KW = dict(hidden_dimension=[16, 16], batch_size=32, start_regression_time_step=4,
                  standardize_start_time_step=32, end_exploration_time_step=10_000)


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return ep.write_all(tmp_path_factory, {"battery": ep.WRITERS["battery"]})["battery"]


def envs(schema, rows=ROWS, **kw):
    return (CityLearnEnv(schema, device="cpu", episode_time_steps=rows, **kw),
            citylearn_tpu.CityLearnEnv(schema, episode_time_steps=rows, **kw))


def rel_close(ours, ref, tol, name):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    err = float(np.max(np.abs(ours - ref), initial=0.0))
    assert ours.shape == ref.shape and err <= tol * scale, f"{name}: {err} over {scale}"


def as_arrays(buffer):
    return [np.stack([np.asarray(t[k], np.float64) for t in buffer.buffer]) for k in range(5)]


def buffers_equal(ours, ref, tol=0.0):
    for i, (a, b) in enumerate(zip(ours.replay_buffer, ref.replay_buffer)):
        assert len(a) == len(b) and a.position == b.position
        for k, (x, y) in enumerate(zip(as_arrays(a), as_arrays(b))):
            if tol:
                rel_close(x, y, tol, f"agent {i} buffer field {k}")
            else:
                assert np.array_equal(x, y), f"agent {i} buffer field {k}"


def stats_equal(ours, ref, tol=0.0):
    for name in ("norm_mean", "norm_std", "r_norm_mean", "r_norm_std"):
        for i, (x, y) in enumerate(zip(getattr(ours, name), getattr(ref, name))):
            assert (x is None) == (y is None), name
            if x is not None:
                if tol:
                    rel_close(x, y, tol, f"{name} {i}")
                else:
                    assert np.array_equal(x, y), f"{name} {i}"


def drive_on(env, agents):
    """One step of the port's env from its current observations with
    ``agents[0]``'s actions, every agent fed the same transition; each
    agent's own actions must be equal."""
    obs = env.observations
    actions = [agent.predict(obs) for agent in agents]
    for a in actions[1:]:
        assert np.array_equal(np.asarray(a, np.float64), np.asarray(actions[0], np.float64))
    nxt, reward, term, trunc, _ = env.step(actions[0])
    for agent, a in zip(agents, actions):
        agent.update(obs, a, reward, nxt, terminated=term, truncated=trunc)


def drive(env, agents, steps):
    """Reset the port's env, then ``steps`` steps of :func:`drive_on`."""
    env.reset()
    for _ in range(steps):
        drive_on(env, agents)


class JaxKeyNoise:
    """The JAX agent's policy noise: its key split as ``_policy_act`` and
    ``_sac_update`` split it, the draws handed to the port."""

    def __init__(self, key):
        self.key = key

    def act(self, act_dim):
        self.key, k = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.normal(k, (1, act_dim))))[None]

    def update(self, batch_size, act_dim):
        self.key, k = jax.random.split(self.key)
        k1, k2 = jax.random.split(k)
        return tuple(torch.tensor(np.asarray(jax.random.normal(kk, (batch_size, act_dim))))[None]
                     for kk in (k1, k2))


def carry_nets(ours, ref):
    """The JAX agent's networks and Adam states into the port's agent,
    each with the leading agent axis of one."""
    for i, nets in enumerate(ref.nets):
        tree = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], nets)
        ours.nets[i] = sac.nets_from_numpy(tree, lr=ours.lr, device="cpu")
    ours.noise = JaxKeyNoise(ref._key)


def at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def nets_close(ours, ref, name):
    """Weights, targets and Adam moments of every agent within 1e-6."""
    for i, (a, b) in enumerate(zip(ours.nets, ref.nets)):
        for net in sac.AgentNets.NETS:
            for path, p in getattr(a, net).jax_paths():
                np.testing.assert_allclose(p.detach().numpy()[0], at(getattr(b, net), path),
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{name}: agent {i} {net} {path}")
        for net in ("q1", "q2", "policy"):
            adam = getattr(b, f"{net}_opt")[0]
            opt = getattr(a, f"{net}_opt")
            for path, p in getattr(a, net).jax_paths():
                state = opt.state.get(p)
                if state is None:
                    assert int(np.asarray(adam.count)) == 0
                    continue
                assert float(state["step"]) == float(np.asarray(adam.count))
                for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                    np.testing.assert_allclose(state[key].numpy()[0], at(moments, path),
                                               rtol=0, atol=1e-6,
                                               err_msg=f"{name}: agent {i} {net} {key} {path}")


def test_sac_exploration_replay_and_normalization_match_jax(schema):
    ours_env, ref_env = envs(schema)
    ours = sac.SAC(ours_env, **SAC_KW)
    ref = jax_sac.SAC(ref_env, **SAC_KW)
    assert ours.observation_dimension == ref.observation_dimension
    assert [e.__class__.__name__ for e in ours.encoders[0]] == \
        [e.__class__.__name__ for e in ref.encoders[0]]
    drive(ours_env, [ours, ref], ROWS - 1)
    assert all(ours.normalized) and all(ref.normalized)
    buffers_equal(ours, ref)
    stats_equal(ours, ref)
    for a, b in zip(ours.action_scale, ref.action_scale):
        assert np.array_equal(a.numpy()[0], np.asarray(b))


def test_sac_learn_on_each_env_matches_jax(schema):
    """The same agents through ``learn`` on each package's own env."""
    ours_env, ref_env = envs(schema)
    ours = sac.SAC(ours_env, **SAC_KW)
    ref = jax_sac.SAC(ref_env, **SAC_KW)
    ours.learn(episodes=1)
    ref.learn(episodes=1)
    assert ours.time_step == ref.time_step == ROWS - 1
    buffers_equal(ours, ref, tol=1e-6)
    stats_equal(ours, ref, tol=1e-6)


def test_sac_update_from_carried_weights_matches_jax(schema):
    """The first step of updates (``update_per_time_step`` 2 on each of 5
    agents) from weights carried from the JAX agent, with its noise; then
    post-exploration actions, deterministic and sampled."""
    start = SAC_KW["standardize_start_time_step"]
    kw = dict(SAC_KW, end_exploration_time_step=start)
    ours_env, ref_env = envs(schema)
    ours = sac.SAC(ours_env, **kw)
    ref = jax_sac.SAC(ref_env, **kw)
    carry_nets(ours, ref)
    nets_close(ours, ref, "carried")
    drive(ours_env, [ours, ref], start)
    assert not any(ours.normalized) and not any(ref.normalized)
    # step `start`: both explore once more, normalize and update twice
    drive_on(ours_env, [ours, ref])
    assert all(ours.normalized) and all(ref.normalized)
    assert ours.nets[0].q1_opt.state[ours.nets[0].q1.w[0]]["step"] == 2
    nets_close(ours, ref, f"after step {start}")
    obs = ours_env.observations
    for deterministic in (True, False):
        a = ours.predict(obs, deterministic=deterministic)
        b = ref.predict(obs, deterministic=deterministic)
        rel_close(np.concatenate(a), np.concatenate(b), 1e-5, f"actions {deterministic}")


def test_sacrbc_explores_with_its_rbc(schema):
    ours_env, ref_env = envs(schema, rows=25)
    ours = sac.SACRBC(ours_env, **SAC_KW)
    ref = jax_sac.SACRBC(ref_env, **SAC_KW)
    obs, _ = ours_env.reset()
    for _ in range(24):
        a, b = ours.predict(obs), ref.predict(obs)
        assert a == b == ours.rbc.predict(obs)
        obs, *_ = ours_env.step(a)


def test_tabular_q_learning_matches_jax(schema):
    """``_exploit`` and ``update`` on the same discretized transitions
    (exploration samples spaces rebuilt at each access, so its draws
    cannot match: the agents act greedily)."""
    kw = dict(episode_time_steps=ROWS, active_observations=["hour"],
              active_actions=["electrical_storage"])
    bins = dict(default_observation_bin_size=6, default_action_bin_size=5)
    ours_env = TabularQLearningWrapper(CityLearnEnv(schema, device="cpu", **kw), **bins)
    ref_env = JaxTabularQLearningWrapper(citylearn_tpu.CityLearnEnv(schema, **kw), **bins)
    assert [s.n for s in ours_env.observation_space] == [s.n for s in ref_env.observation_space]
    assert [s.n for s in ours_env.action_space] == [s.n for s in ref_env.action_space]
    ours = q_learning.TabularQLearning(ours_env, q_init_value=0.0)
    ref = jax_q_learning.TabularQLearning(ref_env, q_init_value=0.0)
    obs, _ = ours_env.reset()
    assert obs == ref_env.reset()[0]
    for t in range(ROWS - 1):
        a, b = ours.predict(obs, deterministic=True), ref.predict(obs, deterministic=True)
        assert a == b == ours._exploit(obs)
        # every third step a fixed action, so that more than one entry learns
        a = [[t % 5] for _ in a] if t % 3 == 0 else a
        nxt, reward, term, trunc, _ = ours_env.step(a)
        ours.update(obs, a, reward, nxt, terminated=term, truncated=trunc)
        ref.update(obs, a, reward, nxt, terminated=term, truncated=trunc)
        obs = nxt
    for x, y in zip(ours.q + ours.q_exploitation, ref.q + ref.q_exploitation):
        assert np.array_equal(x, y, equal_nan=True)
    assert any(np.count_nonzero(q) > 1 for q in ours.q)
    assert ours.epsilon == ref.epsilon


@pytest.mark.parametrize("shape", [(40, 29), (400, 12), (90, 31)],
                         ids=["full", "covariance_eigh", "full-wide"])
def test_numpy_pca_matches_sklearn(shape):
    rng = np.random.RandomState(shape[0])
    X = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
    X[:, 3] = 0.25                          # a constant feature, as a short episode has
    for k in (shape[1], shape[1] // 2):
        ours, ref = marlisa.PCA(k).fit(X), SkPCA(n_components=k).fit(X)
        solver = "covariance_eigh" if shape[0] >= 10 * shape[1] else "full"
        assert ref._fit_svd_solver == solver
        rel_close(ours.mean_, ref.mean_, 1e-6, "mean")
        # the signs: each component's largest loading, and every loading
        # above the noise
        big = np.abs(ref.components_) > 1e-6
        assert np.array_equal(np.sign(ours.components_)[big], np.sign(ref.components_)[big])
        rel_close(ours.components_[:k - 1], ref.components_[:k - 1], 1e-6, "components")
        Y = rng.normal(size=(7, shape[1])) * 2
        rel_close(ours.transform(Y)[:, :k - 1], ref.transform(Y)[:, :k - 1], 1e-6, "transform")
        rel_close(ours.explained_variance_, ref.explained_variance_, 1e-6, "variance")
    with pytest.raises(ValueError, match="n_components"):
        marlisa.PCA(shape[0] + shape[1]).fit(X)


def test_numpy_linear_regression_matches_sklearn():
    rng = np.random.RandomState(0)
    for n, k in ((40, 6), (25, 30)):            # over- and under-determined
        X = rng.normal(size=(n, k))
        X[:, 1] = 3.0                           # a constant column: rank deficient
        y = X @ rng.normal(size=k) + rng.normal(size=n) * 0.1 + 2.0
        ours, ref = marlisa.LinearRegression().fit(X, y), SkLinearRegression().fit(X, y)
        rel_close(ours.coef_, ref.coef_, 1e-6, "coef")
        rel_close(ours.intercept_, ref.intercept_, 1e-6, "intercept")
        Z = rng.normal(size=(9, k))
        rel_close(ours.predict(Z), ref.predict(Z), 1e-6, "predict")
    with pytest.raises(ValueError, match="not fitted"):
        marlisa.LinearRegression().predict(Z)


def test_marlisa_matches_jax(schema):
    """MARLISA on the same transitions: the regression from step 4, the
    coordination variables from its predictions, the PCA fitted at the
    first update (step 36, the 32nd replay row); its regressions, PCA,
    buffers and statistics against the JAX agent's sklearn ones."""
    ours_env, ref_env = envs(schema)
    ours = marlisa.MARLISA(ours_env, **MARLISA_KW)
    ref = jax_marlisa.MARLISA(ref_env, **MARLISA_KW)
    assert ours.energy_size_coefficient == ref.energy_size_coefficient
    drive(ours_env, [ours, ref], ROWS - 1)
    assert all(ours.pca_flag) and all(ref.pca_flag)
    for i in range(len(ours.action_space)):
        assert np.array_equal(np.asarray(ours.regression_buffer[i].x),
                              np.asarray(ref.regression_buffer[i].x))
        est, want = ours.state_estimator[i], ref.state_estimator[i]
        rel_close(est.coef_, want.coef_, 1e-6, f"coef {i}")
        rel_close(est.intercept_, want.intercept_, 1e-6, f"intercept {i}")
        rel_close(ours.pca[i].components_, ref.pca[i].components_, 1e-6, f"pca {i}")
        rel_close(ours.pca[i].mean_, ref.pca[i].mean_, 1e-6, f"pca mean {i}")
        obs = ours_env.observations[i]
        for act in ([0.3], [-0.7]):
            rel_close(ours.predict_demand(i, obs, act), ref.predict_demand(i, obs, act),
                      1e-6, f"demand {i}")
    rel_close(np.asarray(ours.coordination_variables_history),
              np.asarray(ref.coordination_variables_history), 1e-6, "coordination")
    buffers_equal(ours, ref, tol=1e-6)
    stats_equal(ours, ref, tol=1e-6)
