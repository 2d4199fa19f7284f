"""K-means clustering (cf. `vbmc_tpu/utils/kmeans.py`, `utils/fastkmeans.m`),
used to thin an oversized starting cache in the initial design
(`initdesign_vbmc.m:30-45`). The cache is host data of a few hundred rows,
so this is NumPy: greedy k-means++-style seeding from
``np.random.default_rng(seed)``, then Lloyd iterations."""

from __future__ import annotations

import numpy as np


def _sq_dist(X, centers):
    return ((X * X).sum(1)[:, None] + (centers * centers).sum(1)[None, :]
            - 2.0 * X @ centers.T)


def kmeans(X: np.ndarray, k: int, n_iter: int = 25, seed: int = 0):
    """Returns (centers (k, D), assignments (n,))."""
    X = np.asarray(X, float)
    rng = np.random.default_rng(seed)
    idx = [rng.integers(X.shape[0])]
    for _ in range(k - 1):
        d2 = np.min(((X[:, None, :] - X[idx][None, :, :]) ** 2).sum(-1),
                    axis=1)
        idx.append(rng.choice(X.shape[0], p=d2 / max(d2.sum(), 1e-300)))
    centers = X[np.asarray(idx)]
    for _ in range(n_iter):
        one_hot = np.eye(k)[np.argmin(_sq_dist(X, centers), axis=1)]
        counts = one_hot.sum(0)
        # an empty cluster stays where it was
        centers = np.where((counts > 0)[:, None],
                           (one_hot.T @ X) / np.maximum(counts, 1.0)[:, None],
                           centers)
    return centers, np.argmin(_sq_dist(X, centers), axis=1)
