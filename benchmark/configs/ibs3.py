"""Deployment ``ibs3``: example 6 of `vbmc_examples.m` (VBMC v1.0.12), the
psychometric simulator with a lapse rate, its log-likelihood estimated by
inverse binomial sampling (van Opheusden, Acerbi & Ma 2020).

Frozen copies, so that a later change to the program does not change the
traffic or the truth: the simulator (`utils/psycho_gen.m`), the IBS
estimator as the port ships it (its variance sums trigamma(K) where
psi'(1) - psi'(K) is meant; kept as it is, and listed under ``assumed`` in
``ibs3.json``), the target of the example (one RNG per point, seeded from
the point itself, so that a point always gets the same estimate), and the
quadrature oracle: lnZ, mean and covariance of the exact posterior (flat
on the hard bounds) by Gauss-Legendre panels over a box of Laplace SDs
around the mode.
"""

from __future__ import annotations

from math import erf

import numpy as np


def psycho_gen(params, stimuli, rng):
    """Binary responses of the psychometric model: probit link with
    location mu and log width, lapses at rate lambda."""
    mu, log_sigma, lapse = params[0], params[1], params[2]
    sigma = np.exp(log_sigma)
    p_right = np.array([0.5 * (1 + erf((s - mu) / (np.sqrt(2) * sigma)))
                        for s in np.atleast_1d(stimuli)])
    p_right = lapse / 2 + (1 - lapse) * p_right
    return (rng.random(p_right.shape) < p_right).astype(int)


def ibs_loglike(simulator, params, responses, stimuli, n_reps, rng,
                max_samples=10 ** 4):
    """IBS estimate of sum_i log p(response_i | stimulus_i, params) and the
    variance estimate, as the port ships them."""
    n_trials = responses.shape[0]

    def trigamma(n):
        return np.pi ** 2 / 6 - np.sum(1.0 / np.arange(1, n) ** 2)

    estimates = np.zeros((n_reps, n_trials))
    variances = np.zeros((n_reps, n_trials))
    for r in range(n_reps):
        active = np.ones(n_trials, dtype=bool)
        harmonic = np.zeros(n_trials)
        k = np.ones(n_trials, dtype=int)
        for _ in range(max_samples):
            if not active.any():
                break
            sim = np.asarray(simulator(params, stimuli[active], rng))
            hit = sim == responses[active]
            idx = np.where(active)[0]
            active[idx[hit]] = False
            cont = idx[~hit]
            harmonic[cont] += 1.0 / k[cont]
            k[cont] += 1
        estimates[r] = -harmonic
        variances[r] = np.array([trigamma(int(kk)) for kk in k])
    ll = float(np.mean(np.sum(estimates, axis=1)))
    var = float(np.sum(np.mean(variances, axis=0)) / n_reps)
    return ll, var


def data(cfg):
    """Stimuli and responses: ``default_rng(data_seed)``, stimuli uniform
    on the stimulus range, responses simulated at the true parameters."""
    rng = np.random.default_rng(cfg["data_seed"])
    lo, hi = cfg["stimulus_range"]
    stimuli = rng.uniform(lo, hi, cfg["n_trials"])
    responses = psycho_gen(np.array(cfg["true_params"], float), stimuli, rng)
    return stimuli, responses


def make_target(cfg):
    """The noisy log-likelihood (value, SD) at original-space parameters."""
    stimuli, responses = data(cfg)
    reps = cfg["ibs_repeats"]

    def noisy_ll(params):
        rng = np.random.default_rng(
            abs(hash(tuple(np.round(params, 8)))) % 2 ** 31)
        ll, var = ibs_loglike(psycho_gen, params, responses, stimuli, reps,
                              rng)
        return ll, float(np.sqrt(max(var, 1e-12)))
    return noisy_ll


def _q(mu, log_sigma, s, r):
    """Probability of each observed response without lapses."""
    from scipy import special

    return special.ndtr(np.where(r == 1, 1.0, -1.0) * (s - mu)
                        / np.exp(log_sigma))


def exact_loglike(theta, s, r):
    theta = np.asarray(theta, float)
    mu, ls, lam = (theta[..., i, None] for i in range(3))
    return np.log(lam / 2 + (1 - lam) * _q(mu, ls, s, r)).sum(-1)


def _gl_axis(lo, hi, panels, nodes):
    t, w = np.polynomial.legendre.leggauss(nodes)
    edges = np.linspace(lo, hi, panels + 1)[:, None]
    half = (edges[1:] - edges[:-1]) / 2
    return (edges[:-1] + half + half * t).ravel(), (half * w).ravel()


def truth(cfg):
    """lnZ, mean and covariance of the posterior (flat prior on the hard
    bounds) by quadrature. Raises if more than ``edge_mass`` of the mass
    lies within a grid step of a box edge that is not a hard bound."""
    from scipy import optimize

    q = cfg["oracle"]
    s, r = data(cfg)
    lb, ub = np.array(cfg["lb"], float), np.array(cfg["ub"], float)
    opt = optimize.minimize(lambda t: -exact_loglike(t, s, r),
                            np.array(cfg["true_params"], float),
                            method="L-BFGS-B", bounds=list(zip(lb, ub)))
    x, h = opt.x, 1e-4 * (ub - lb)
    H = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            d = [np.eye(3)[i] * h[i] * a + np.eye(3)[j] * h[j] * b
                 for a, b in ((1, 1), (1, -1), (-1, 1), (-1, -1))]
            f = exact_loglike(x + np.array(d), s, r)
            H[i, j] = -(f[0] - f[1] - f[2] + f[3]) / (4 * h[i] * h[j])
    sd = np.sqrt(np.diag(np.linalg.inv(H)))
    lo = np.maximum(x - q["box_sds"] * sd, lb)
    hi = np.minimum(x + q["box_sds"] * sd, ub)
    top = -opt.fun
    axes = [_gl_axis(lo[i], hi[i], p_, q["nodes"])
            for i, p_ in enumerate(q["panels"])]
    M, LS = np.meshgrid(axes[0][0], axes[1][0], indexing="ij")
    qq = _q(M[..., None], LS[..., None], s, r)
    w2 = axes[0][1][:, None] * axes[1][1][None, :]
    dens = np.empty([len(a[0]) for a in axes])
    for k, (lam, wl) in enumerate(zip(*axes[2])):
        ll = np.log(lam / 2 + (1 - lam) * qq).sum(-1)
        dens[:, :, k] = np.exp(ll - top) * w2 * wl
    Z = dens.sum()
    P = dens / Z
    grids = np.meshgrid(*[a[0] for a in axes], indexing="ij")
    mean = np.array([(P * g).sum() for g in grids])
    cov = np.array([[(P * (gi - mean[i]) * (gj - mean[j])).sum()
                     for j, gj in enumerate(grids)]
                    for i, gi in enumerate(grids)])
    edge = 0.0
    for i, (xs, _) in enumerate(axes):
        marg = P.sum(tuple(j for j in range(3) if j != i))
        step = (xs[-1] - xs[0]) / (len(xs) - 1)
        for near, is_bound in ((xs < xs[0] + step, lo[i] == lb[i]),
                               (xs > xs[-1] - step, hi[i] == ub[i])):
            if not is_bound:
                edge = max(edge, float(marg[near].sum()))
    if edge > q["edge_mass"]:
        raise AssertionError(f"ibs3 oracle: {edge:.3g} of the mass lies "
                             f"within a grid step of a cut edge")
    return dict(lnz=float(np.log(Z) + top), mean=mean, cov=cov)
