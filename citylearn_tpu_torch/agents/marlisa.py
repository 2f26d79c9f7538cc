"""MARLISA: multi-agent SAC with information sharing
(reference ``citylearn/agents/marlisa.py``).

Per-agent linear regression predicts next net electricity consumption;
agents coordinate sequentially by passing (scaled total demand, capacity
dispatched) coordination variables; observations are PCA-compressed.
Shipped quirks preserved: the post-exploration coordination loop samples
``policy_net[iteration]`` — the *iteration* index, not the agent index
(``marlisa.py:316``).

The reference fits scikit-learn's ``PCA`` and ``LinearRegression``; the
machine with the card has no scikit-learn, so :class:`PCA` and
:class:`LinearRegression` here are numpy versions of the two that follow
scikit-learn 1.9's solvers, sign rule and cut-off.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Tuple, Union

import numpy as np

from citylearn_tpu_torch.agents.rbc import RBC, BasicRBC
from citylearn_tpu_torch.agents.sac import SAC
from citylearn_tpu_torch.preprocessing import (
    NoNormalization,
    PeriodicNormalization,
    RemoveFeature,
    encode,
)


class PCA:
    """``sklearn.decomposition.PCA(n_components)`` with its default
    ``svd_solver="auto"``, in numpy (``PCA._fit`` / ``_fit_full``).

    The automatic choice: the eigendecomposition of the covariance matrix
    for tall data (at most 1000 features and at least 10 samples per
    feature), else the full SVD of the centered data. Where scikit-learn
    would take its randomized solver (over 500 rows or columns, and fewer
    than 0.8 x min(shape) components), whose result depends on an unseeded
    draw, this takes the full SVD that it approximates. The sign of each
    component makes its largest-magnitude loading positive
    (``svd_flip(..., u_based_decision=False)``)."""

    def __init__(self, n_components: int):
        self.n_components = n_components

    def fit(self, X) -> "PCA":
        X = np.asarray(X, np.float64)
        n_samples, n_features = X.shape
        k = int(self.n_components)
        if not 0 <= k <= min(n_samples, n_features):
            raise ValueError(f"n_components={k} must be between 0 and "
                             f"min(n_samples, n_features)={min(n_samples, n_features)}")
        self.mean_ = X.mean(axis=0)
        if n_features <= 1000 and n_samples >= 10 * n_features:
            C = X.T @ X
            C -= n_samples * self.mean_[:, None] * self.mean_[None, :]
            C /= n_samples - 1
            eigenvals, eigenvecs = np.linalg.eigh(C)
            eigenvals, eigenvecs = eigenvals[::-1].copy(), eigenvecs[:, ::-1]
            eigenvals[eigenvals < 0.0] = 0.0
            explained = eigenvals
            Vt = eigenvecs.T.copy()
        else:
            _, S, Vt = np.linalg.svd(X - self.mean_, full_matrices=False)
            explained = S ** 2 / (n_samples - 1)
        rows = np.arange(Vt.shape[0])
        Vt *= np.sign(Vt[rows, np.argmax(np.abs(Vt), axis=1)])[:, None]
        self.n_components_ = k
        self.components_ = Vt[:k].copy()
        self.explained_variance_ = explained[:k].copy()
        self.explained_variance_ratio_ = explained[:k] / explained.sum()
        return self

    def transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64)
        return X @ self.components_.T - self.mean_[None, :] @ self.components_.T


class LinearRegression:
    """``sklearn.linear_model.LinearRegression()`` in numpy: least squares
    with an intercept on centered data, singular values below 1e-6 of the
    largest cut off (its ``tol``), the LAPACK ``gelsd`` solver of both."""

    tol = 1e-6

    def fit(self, X, y) -> "LinearRegression":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        x_offset, y_offset = X.mean(axis=0), y.mean(axis=0)
        self.coef_, _, self.rank_, self.singular_ = np.linalg.lstsq(
            X - x_offset, y - y_offset, rcond=self.tol)
        self.intercept_ = y_offset - x_offset @ self.coef_
        return self

    def predict(self, X) -> np.ndarray:
        if not hasattr(self, "coef_"):
            raise ValueError("this LinearRegression is not fitted yet; call fit first")
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


COORD_VARS = 2

REGRESSION_REMOVE = [
    f"{base}{suffix}"
    for base in ("outdoor_dry_bulb_temperature", "outdoor_relative_humidity",
                 "diffuse_solar_irradiance", "direct_solar_irradiance")
    for suffix in ("", "_predicted_1", "_predicted_2", "_predicted_3")
]


class RegressionBuffer:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.x: list = []
        self.y: list = []
        self.position = 0

    def push(self, variables, target):
        if len(self.x) < self.capacity and len(self.x) == len(self.y):
            self.x.append(None)
            self.y.append(None)
        self.x[self.position] = variables
        self.y[self.position] = target
        self.position = (self.position + 1) % self.capacity


class MARLISA(SAC):
    def __init__(self, env, regression_buffer_capacity: int = None,
                 start_regression_time_step: int = None,
                 regression_frequency: int = None,
                 information_sharing: bool = None,
                 pca_compression: float = None, iterations: int = None,
                 **kwargs: Any):
        self.information_sharing = (True if information_sharing is None
                                    else information_sharing)
        kwargs.setdefault("hidden_dimension", [400, 300])
        kwargs.setdefault("batch_size", 100)
        super().__init__(env, **kwargs)
        self.regression_buffer_capacity = int(regression_buffer_capacity or 3e4)
        self.start_regression_time_step = (2 if start_regression_time_step is None
                                           else int(start_regression_time_step))
        self.regression_frequency = int(regression_frequency or 2500)
        self.pca_compression = 1.0 if pca_compression is None else pca_compression
        self.iterations = 2 if iterations is None else int(iterations)

        n = len(self.action_space)
        self.regression_buffer = [RegressionBuffer(self.regression_buffer_capacity)
                                  for _ in range(n)]
        self.state_estimator = [LinearRegression() for _ in range(n)]
        self.pca = [None] * n
        self.pca_flag = [False] * n
        self.regression_flag = [0] * n
        self.regression_encoders = self.set_regression_encoders()
        self.set_energy_coefficients()
        self.set_pca()
        self.coordination_variables_history = [
            [[0.0] * COORD_VARS for _ in range(n)] for _ in range(2)]

    # -- network sizing includes coordination variables -----------------
    def set_networks(self, internal_observation_count: int = None):
        count = COORD_VARS if self.information_sharing else 0
        super().set_networks(internal_observation_count=count)

    def set_regression_encoders(self):
        """Reference ``marlisa.py:420-460``."""
        encoders = []
        for names, space in zip(self.observation_names, self.observation_space):
            e = []
            for i, n in enumerate(names):
                if n in ("month", "hour"):
                    e.append(PeriodicNormalization(space.high[i]))
                elif n in REGRESSION_REMOVE:
                    e.append(RemoveFeature())
                else:
                    e.append(NoNormalization())
            encoders.append(e)
        return encoders

    def set_energy_coefficients(self):
        """Reference ``marlisa.py:404-418``."""
        metadata = self.env.get_metadata()["buildings"]
        self.energy_size_coefficient = []
        self.total_coefficient = 0.0
        for b in metadata:
            coef = (b["annual_dhw_demand_estimate"] / 0.9
                    + b["annual_cooling_demand_estimate"] / 3.5
                    + b["annual_heating_demand_estimate"] / 3.5
                    + b["annual_non_shiftable_load_estimate"]
                    - b["annual_solar_generation_estimate"] / 6.0)
            coef = max(0.3 * (coef + b["annual_solar_generation_estimate"] / 6.0),
                       coef) / 8760
            self.energy_size_coefficient.append(coef)
            self.total_coefficient += coef
        self.energy_size_coefficient = [c / self.total_coefficient
                                        for c in self.energy_size_coefficient]

    def set_pca(self):
        addition = COORD_VARS if self.information_sharing else 0
        for i, dim in enumerate(self.observation_dimension):
            self.pca[i] = PCA(n_components=int(self.pca_compression * (addition + dim)))

    # -- regression helpers --------------------------------------------
    def _regression_variables(self, i, observations, actions):
        names = self.observation_names[i]
        ix = names.index("net_electricity_consumption")
        o = list(observations)
        del o[ix]
        e = list(self.regression_encoders[i])
        del e[ix]
        return np.concatenate([encode(e, o), np.asarray(actions, float)])

    def _regression_target(self, i, observations):
        ix = self.observation_names[i].index("net_electricity_consumption")
        return float(observations[ix])

    def predict_demand(self, i, observations, actions) -> float:
        v = self._regression_variables(i, observations, actions)
        return float(self.state_estimator[i].predict(v.reshape(1, -1))[0])

    # -- update (marlisa.py:118-274) ------------------------------------
    def update(self, observations, actions, reward, next_observations,
               terminated: bool, truncated: bool):
        c_hist0, c_hist1 = self.coordination_variables_history
        for i, (o, a, r, n) in enumerate(zip(observations, actions, reward,
                                             next_observations)):
            c0, c1 = c_hist0[i], c_hist1[i]
            if self.information_sharing:
                self.regression_buffer[i].push(
                    self._regression_variables(i, o, a),
                    self._regression_target(i, n))

            if self.regression_flag[i] > 1:
                eo = encode(self.encoders[i], o)
                en = encode(self.encoders[i], n)
                rr = r
                if self.information_sharing:
                    eo = np.concatenate([eo, np.asarray(c0, float)])
                    en = np.concatenate([en, np.asarray(c1, float)])
                if self.pca_flag[i]:
                    eo = self.pca[i].transform(
                        self._norm_obs(i, eo).reshape(1, -1))[0]
                    en = self.pca[i].transform(
                        self._norm_obs(i, en).reshape(1, -1))[0]
                    rr = self._norm_reward(i, rr)
                self.replay_buffer[i].push(eo, np.asarray(a, float), rr, en,
                                           float(terminated))

            if self.time_step >= self.start_regression_time_step and (
                    self.regression_flag[i] < 2
                    or self.time_step % self.regression_frequency == 0):
                if self.information_sharing:
                    self.state_estimator[i].fit(self.regression_buffer[i].x,
                                                self.regression_buffer[i].y)
                if self.regression_flag[i] < 2:
                    self.regression_flag[i] += 1

            if self.time_step >= self.standardize_start_time_step \
                    and self.batch_size <= len(self.replay_buffer[i]):
                if not self.pca_flag[i]:
                    buf = self.replay_buffer[i].buffer
                    X = np.array([j[0] for j in buf], dtype=float)
                    self.norm_mean[i] = np.nanmean(X, axis=0)
                    self.norm_std[i] = np.nanstd(X, axis=0) + 1e-5
                    self.pca[i].fit(self._norm_obs(i, X))
                    R = np.array([j[2] for j in buf], dtype=float)
                    self.r_norm_mean[i] = float(np.nanmean(R))
                    self.r_norm_std[i] = float(np.nanstd(R)) / self.reward_scaling + 1e-5
                    self.replay_buffer[i].buffer = [
                        (self.pca[i].transform(self._norm_obs(i, o_).reshape(1, -1))[0],
                         a_, self._norm_reward(i, r_),
                         self.pca[i].transform(self._norm_obs(i, n_).reshape(1, -1))[0],
                         d_)
                        for o_, a_, r_, n_, d_ in self.replay_buffer[i].buffer]
                    self.pca_flag[i] = True
                    self.normalized[i] = True

                self._train_agent(i)
        self.time_step += 1

    # -- prediction (marlisa.py:276-373) --------------------------------
    def get_post_exploration_prediction(self, observations, deterministic):
        if self.information_sharing:
            actions, cv = self._post_with_sharing(observations, deterministic)
        else:
            actions, cv = self._post_without_sharing(observations, deterministic)
        self.coordination_variables_history[0] = deepcopy(
            self.coordination_variables_history[1])
        self.coordination_variables_history[1] = cv[0:]
        return actions

    def get_exploration_prediction(self, observations):
        if self.information_sharing:
            actions, cv = self._explore_with_sharing(observations)
        else:
            actions, cv = self._explore_without_sharing(observations)
        self.coordination_variables_history[0] = deepcopy(
            self.coordination_variables_history[1])
        self.coordination_variables_history[1] = cv[0:]
        return actions

    def _post_with_sharing(self, observations, deterministic) -> Tuple[list, list]:
        agent_count = len(self.action_space)
        actions = [None] * agent_count
        action_order = list(range(agent_count))
        next_ixs = [sorted(action_order)[action_order[(i + 1) % agent_count]]
                    for i in range(agent_count)]
        cv = [[0.0, 0.0] for _ in range(agent_count)]
        expected = [0.0] * agent_count
        total_demand = 0.0

        for it in range(self.iterations):
            capacity_dispatched = 0.0
            for c, nxt, o in zip(action_order, next_ixs, observations):
                eo = encode(self.encoders[c], o)
                eo = np.concatenate([eo, np.asarray(cv[c], float)])
                eo = self._norm_obs(c, eo)
                eo = self.pca[c].transform(eo.reshape(1, -1))[0]
                # quirk: nets indexed by the *iteration* (marlisa.py:316)
                actions[c] = self._sample_policy(it, c, eo, deterministic)
                expected[c] = self.predict_demand(c, o, actions[c])
                if not (it == self.iterations - 1 and c == action_order[-1]):
                    total_demand += expected[c] - expected[nxt]
                    cv[nxt][0] = total_demand / self.total_coefficient
                cv[c][1] = capacity_dispatched
                capacity_dispatched += self.energy_size_coefficient[c]
        return actions, cv

    def _post_without_sharing(self, observations, deterministic):
        actions = []
        for i, o in enumerate(observations):
            eo = encode(self.encoders[i], o)
            eo = self._norm_obs(i, eo)
            eo = self.pca[i].transform(eo.reshape(1, -1))[0]
            actions.append(self._sample_policy(i, i, eo, deterministic))
        return actions, [[0.0, 0.0] for _ in observations]

    def _explore_with_sharing(self, observations):
        actions, cv = self._explore_without_sharing(observations)
        if self.time_step > self.start_regression_time_step:
            agent_count = len(self.action_space)
            order = list(range(agent_count))
            nprs = np.random.RandomState(int(self.random_seed + self.time_step))
            nprs.shuffle(order)
            expected = [self.predict_demand(i, o, a)
                        for i, (o, a) in enumerate(zip(observations, actions))]
            cv = [[(sum(expected) - expected[i]) / self.total_coefficient,
                   sum(self.energy_size_coefficient[j]
                       for j in order[:order.index(i)])]
                  for i in range(agent_count)]
        return actions, cv

    def _explore_without_sharing(self, observations):
        actions = SAC.get_exploration_prediction(self, observations)
        return actions, [[0.0, 0.0] for _ in observations]

    def reset(self):
        super().reset()
        if hasattr(self, "action_space") and hasattr(self, "coordination_variables_history"):
            n = len(self.action_space)
            self.coordination_variables_history = [
                [[0.0] * COORD_VARS for _ in range(n)] for _ in range(2)]


class MARLISARBC(MARLISA):
    """RBC-guided exploration (reference ``marlisa.py:472-494``)."""

    def __init__(self, env, rbc: Union[RBC, type] = None, **kwargs: Any):
        super().__init__(env, **kwargs)
        if rbc is None:
            rbc = BasicRBC(env)
        elif isinstance(rbc, type):
            rbc = rbc(env)
        self.rbc = rbc

    def _explore_without_sharing(self, observations):
        actions = self.rbc.predict(observations)
        return actions, [[0.0, 0.0] for _ in observations]
