"""The one generator of traffic: a traffic file's parameters and a
configuration give the starting points and the options of a run, the same
for the same seed.

Parameters of a traffic file:

- ``n_start``: starting points drawn from the seed (0: the configuration's
  own ``x0``), of which ``n_uniform`` uniform in the plausible box and the
  rest from a normal with the posterior's mean and ``cov_scale`` times its
  covariance (the configuration's truth), clipped inside the hard bounds;
- ``options``: VBMC options laid over the configuration's published ones;
- ``window_opens``: ``first_iteration`` (the default) or ``warmup_over``,
  the end of the first iteration that reports warm-up over;
- ``answer``: whether the run's answer is held to the truth.
"""

from __future__ import annotations

import numpy as np

# VBMC moves starting points that lie within 1e-3 of a bounded width of a
# hard bound (`boundscheck_vbmc.m`); the draws keep twice that clear.
BOUND_MARGIN = 2e-3


def bounds(cfg):
    """(lb, ub, plb, pub) as float arrays; null bounds are infinite."""
    D = cfg["D"]
    lb = np.full(D, -np.inf) if cfg["lb"] is None else np.array(cfg["lb"],
                                                                 float)
    ub = np.full(D, np.inf) if cfg["ub"] is None else np.array(cfg["ub"],
                                                               float)
    return lb, ub, np.array(cfg["plb"], float), np.array(cfg["pub"], float)


def starting_points(cfg, truth, traffic, seed):
    n = int(traffic["n_start"])
    if n == 0:
        return np.array(cfg["x0"], float)[None, :]
    lb, ub, plb, pub = bounds(cfg)
    rng = np.random.default_rng([seed, 1])
    nu = int(traffic["n_uniform"])
    X_u = plb + (pub - plb) * rng.random((nu, cfg["D"]))
    cov = float(traffic["cov_scale"]) * np.asarray(truth["cov"], float)
    X_n = rng.multivariate_normal(np.asarray(truth["mean"], float), cov,
                                  size=n - nu, method="cholesky")
    width = np.where(np.isfinite(ub - lb), ub - lb, 0.0)
    X_n = np.clip(X_n, lb + BOUND_MARGIN * width, ub - BOUND_MARGIN * width)
    return np.concatenate([X_u, X_n])


def plausible_box(cfg, x0):
    """The plausible box a run uses: VBMC widens the given one to hold
    every starting point (`boundscheck_vbmc.m`)."""
    _, _, plb, pub = bounds(cfg)
    return np.minimum(plb, x0.min(0)), np.maximum(pub, x0.max(0))


def options(cfg, traffic):
    return {**cfg["options"], **traffic["options"]}
