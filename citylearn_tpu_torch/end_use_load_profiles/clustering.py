"""KMeans in numpy (reference ``end_use_load_profiles/clustering.py``,
which runs scikit-learn's ``KMeans``).

The algorithm and its random draws follow scikit-learn 1.9's dense
``KMeans(init="k-means++", algorithm="lloyd")``: the data centred on its
column means; k-means++ with ``2 + floor(ln k)`` local trials, drawing
from the one ``RandomState`` in scikit-learn's order (the first centre
by ``choice``, then ``uniform`` trials searched in the cumulative
potential); Lloyd iterations until the labels repeat or the squared
centre shift falls to ``tol`` times the mean feature variance, empty
clusters taking the points farthest from their centres, and one last
assignment when the labels did not settle; the best of ``n_init`` runs
by inertia, where a run that only relabels the best one's clusters does
not replace it. Sums run in another order than scikit-learn's threaded
Cython, so an inertia may differ in its last bits.
"""

from __future__ import annotations

import numpy as np

MAX_ITER = 300      # scikit-learn's defaults
TOL = 1e-4


def _row_norms(X: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", X, X)


def _squared_distances(A: np.ndarray, X: np.ndarray, x_norms: np.ndarray) -> np.ndarray:
    """scikit-learn's ``_euclidean_distances(A, X, squared=True)`` for
    float64: ``-2 A X^T + |A|^2 + |X|^2``, clipped at 0."""
    d = -2 * (A @ X.T)
    d += _row_norms(A)[:, None]
    d += x_norms[None, :]
    return np.maximum(d, 0, out=d)


def kmeans_plusplus(X: np.ndarray, n_clusters: int, x_norms: np.ndarray,
                    rs: np.random.RandomState) -> np.ndarray:
    """Initial centres by greedy k-means++ (unit sample weights)."""
    n = X.shape[0]
    weight = np.ones(n)
    n_trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, X.shape[1]), X.dtype)
    centers[0] = X[rs.choice(n, p=weight / weight.sum())]
    closest = _squared_distances(centers[:1], X, x_norms)
    pot = closest @ weight
    for c in range(1, n_clusters):
        rand_vals = rs.uniform(size=n_trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        to_candidates = _squared_distances(X[ids], X, x_norms)
        np.minimum(closest, to_candidates, out=to_candidates)
        cand_pot = to_candidates @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = to_candidates[best]
        centers[c] = X[ids[best]]
    return centers


def _assign(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest centre by ``|c|^2 - 2 x.c`` (the first on a tie)."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2.0 * (X @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(X, centers, labels):
    """New centres from ``labels``: weighted sums, empty clusters moved to
    the points farthest from their centres, then the means."""
    k = centers.shape[0]
    sums = np.zeros_like(centers)
    np.add.at(sums, labels, X)
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        for new, i in zip(empty, far):
            old = labels[i]
            sums[old] -= X[i]
            sums[new] = X[i]
            weight[new] = 1.0
            weight[old] -= 1.0
    nonzero = weight > 0
    sums[nonzero] *= (1.0 / weight[nonzero])[:, None]
    return sums


def kmeans_single_lloyd(X: np.ndarray, centers: np.ndarray, tol: float):
    """One Lloyd run from ``centers``: ``(labels, inertia, centers)``."""
    labels_old = np.full(X.shape[0], -1, np.int32)
    strict = False
    for _ in range(MAX_ITER):
        labels = _assign(X, centers)
        new = _lloyd_step(X, centers, labels)
        shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(labels1: np.ndarray, labels2: np.ndarray, n_clusters: int) -> bool:
    """Whether the two labellings differ only by a permutation."""
    mapping = np.full(n_clusters, -1, np.int64)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


class KMeans:
    """``KMeans(n_clusters, random_state, n_init=10)`` with ``fit``,
    ``fit_predict``, ``labels_``, ``inertia_`` and ``cluster_centers_``."""

    def __init__(self, n_clusters: int = 8, random_state: int = None, n_init: int = 10):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.n_init = n_init

    def fit(self, X, y=None) -> "KMeans":
        X = np.array(X, dtype=np.float64, order="C")
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        tol = float(np.mean(np.var(X, axis=0)) * TOL)
        rs = np.random.RandomState(self.random_state)
        mean = X.mean(axis=0)
        X -= mean
        x_norms = _row_norms(X)
        best = None
        for _ in range(self.n_init):
            init = kmeans_plusplus(X, self.n_clusters, x_norms, rs)
            labels, inertia, centers = kmeans_single_lloyd(X, init, tol)
            if best is None or (inertia < best[1]
                                and not _same_clustering(labels, best[0], self.n_clusters)):
                best = (labels, inertia, centers)
        self.labels_, self.inertia_, centers = best
        self.cluster_centers_ = centers + mean
        return self

    def fit_predict(self, X, y=None) -> np.ndarray:
        return self.fit(X).labels_
