"""Inverse binomial sampling (IBS): unbiased estimator of the log-likelihood
of simulator-based models (cf. `utils/ibslike.m`; van Opheusden, Acerbi &
Ma 2020). Companion tool for noisy-target inference: returns an unbiased
noisy log-likelihood plus its variance estimate, suitable for
`specify_target_noise=True` targets.

The port's own copy of `vbmc_tpu/utils/ibs.py` (NumPy only, the same
estimator).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def ibs_loglike(simulator: Callable, params, responses: np.ndarray,
                stimuli: Optional[np.ndarray] = None, n_reps: int = 1,
                max_samples: int = 10 ** 4, rng=None):
    """Estimate sum_i log p(response_i | stimulus_i, params).

    simulator(params, stimuli, rng) -> simulated responses (matching the
    shape of ``responses``). Each trial draws simulations until one matches
    the observed response; the trial's log-likelihood estimate is
    -sum_{k=1}^{K-1} 1/k where K is the number of draws.

    Returns (loglike_estimate, variance_estimate).
    """
    if rng is None:
        rng = np.random.default_rng()
    responses = np.asarray(responses)
    n_trials = responses.shape[0]
    if stimuli is None:
        stimuli = np.arange(n_trials)

    # Precomputed harmonic tails for the variance estimate:
    # Var[-H_{K-1}] = psi'(1) - psi'(K) (trigamma).
    def trigamma(n):
        # psi'(n) for integer n: pi^2/6 - sum_{j=1}^{n-1} 1/j^2
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
            # Trials that matched retire; the rest accumulate 1/k.
            done = idx[hit]
            cont = idx[~hit]
            active[done] = False
            harmonic[cont] += 1.0 / k[cont]
            k[cont] += 1
        # Any still-active trial is censored at max_samples (rare).
        estimates[r] = -harmonic
        variances[r] = np.array([trigamma(int(kk)) for kk in k])

    ll = float(np.mean(np.sum(estimates, axis=1)))
    var = float(np.sum(np.mean(variances, axis=0)) / n_reps)
    return ll, var


def ibs_loglike_and_sd(simulator, params, responses, stimuli=None,
                       n_reps: int = 1, rng=None):
    """Convenience wrapper returning (loglike, SD) for VBMC noisy targets."""
    ll, var = ibs_loglike(simulator, params, responses, stimuli,
                          n_reps=n_reps, rng=rng)
    return ll, float(np.sqrt(max(var, 1e-12)))
