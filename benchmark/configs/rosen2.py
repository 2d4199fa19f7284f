"""Deployment ``rosen2``: the Rosenbrock-like 2-D target of VBMC's first
example, in this repository's variant: log p(x) = -(x1^2 - x2)^2 / 2 -
(x1^2 + x2^2) / 2, unnormalised and without bounds. The truth (lnZ, mean
and covariance) comes from a trapezoid rule on a square grid, which the
target's Gaussian tails make exact to far below any gate."""

from __future__ import annotations

import numpy as np


def log_density(x):
    """The target at rows x (..., 2)."""
    x = np.asarray(x, float)
    return (-0.5 * (x[..., 0] ** 2 - x[..., 1]) ** 2
            - 0.5 * (x[..., 0] ** 2 + x[..., 1] ** 2))


def make_target(cfg):
    def rosen(x):
        return float(log_density(np.atleast_1d(x)))
    return rosen


def truth(cfg):
    q = cfg["oracle"]
    t = np.linspace(-q["half_width"], q["half_width"], q["nodes"])
    h = t[1] - t[0]
    X = np.stack(np.meshgrid(t, t, indexing="ij"), -1)
    lp = log_density(X)
    top = lp.max()
    w = np.exp(lp - top) * h * h
    Z = w.sum()
    mean = np.einsum("ij,ijk->k", w, X) / Z
    d = X - mean
    cov = np.einsum("ij,ijk,ijl->kl", w, d, d) / Z
    return dict(lnz=float(top + np.log(Z)), mean=mean, cov=cov)
