"""Sampling from the GP surrogate (cf. `vbmc_tpu/gp/sample.py`,
`gplite/gplite_sample.m`, `misc/gpsample_vbmc.m`): MCMC draws from the
density proportional to exp(posterior mean), joint function draws
(`gplite/gplite_rnd.m`), the optimum of the posterior mean
(`gplite/gplite_fmin.m`) and predictive quantiles (`gplite/gplite_qpred.m`).

Every query runs on the device of the GP it is given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import get_hpd
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.means import mean_function
from vbmc_tpu_torch.gp.predict import gp_predict, gp_predict_full
from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_sample
from vbmc_tpu_torch.utils.math import to_np


def _generator(gp: GP, gen: Optional[torch.Generator]) -> torch.Generator:
    if gen is None:
        gen = torch.Generator(device=gp.X.device).manual_seed(0)
    return gen


def _t(gp: GP, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=gp.X.device,
                           dtype=gp.X.dtype)


def _training_points(gp: GP):
    mask = to_np(gp.mask).astype(bool)
    return to_np(gp.X)[mask], to_np(gp.y)[mask]


def gp_sample(cfg: GPConfig, gp: GP, n_samples: int,
              gen: Optional[torch.Generator] = None,
              x0: Optional[np.ndarray] = None, beta: float = 0.0,
              bounds=None) -> torch.Tensor:
    """About ``n_samples`` points (n_samples, D) from exp(GP posterior mean
    + beta * SD) by ensemble slice sampling, the walkers started at the HPD
    training points with a jitter from ``np.random.default_rng(0)``
    (`gplite_sample.m:52-103`); the first five sweeps are burn-in."""
    gen = _generator(gp, gen)
    D = gp.D
    X, y = _training_points(gp)
    W = 2 * (D + 1)
    X_hpd, _ = get_hpd(X, y, 0.25)
    idx = np.resize(np.arange(X_hpd.shape[0]), W)
    x0s = X_hpd[idx] + 1e-3 * np.random.default_rng(0).standard_normal((W, D))
    if x0 is not None:
        x0s[0] = x0
    if bounds is None:
        span = X.max(0) - X.min(0)
        lb, ub = X.min(0) - 0.5 * span, X.max(0) + 0.5 * span
    else:
        lb, ub = bounds
    m = gp.hyp_mask.to(gp.X.dtype)[:, None]
    ns = m.sum().clamp_min(1.0)

    def logpdf(x):
        fmu, fs2 = gp_predict_full(cfg, gp, x)                     # (S, B)
        fbar = (fmu * m).sum(0) / ns
        sbar = torch.sqrt(((fs2 * m).sum(0) / ns).clamp_min(0.0))
        return fbar + beta * sbar

    n_steps = int(np.ceil(n_samples / W)) + 5
    with torch.no_grad():
        walkers, _ = ensemble_slice_sample(gen, logpdf, _t(gp, x0s),
                                           _t(gp, lb), _t(gp, ub), n_steps)
    return walkers[5:].reshape(-1, D)[:n_samples]


def gp_rnd(cfg: GPConfig, gp: GP, Xstar, gen: Optional[torch.Generator] = None,
           n_draws: int = 1, posterior: bool = True) -> torch.Tensor:
    """Joint function draws (n_draws, M) at Xstar (M, D) from the GP prior
    or posterior (`gplite/gplite_rnd.m`). As in the reference, the draws use
    the first hyperparameter sample only (`vbmc_tpu/gp/sample.py:90`;
    ROADMAP Queue 3 d)."""
    gen = _generator(gp, gen)
    Xs = torch.as_tensor(Xstar, device=gp.X.device, dtype=gp.X.dtype)
    hyp = gp.hyp[:1]
    M = Xs.shape[0]
    with torch.no_grad():
        Kss = kernel_cross(cfg, hyp, Xs, Xs)[0]
        m = mean_function(cfg, hyp[:, cfg.sl_mean], Xs)[0]
        if posterior:
            ks = (kernel_cross(cfg, hyp, gp.X, Xs)[0]
                  * gp.mask.to(gp.X.dtype)[:, None])
            fmu = m + ks.T @ gp.alpha[0]
            V = torch.linalg.solve_triangular(gp.L[0], ks, upper=False)
            cov = Kss - V.T @ V
        else:
            fmu, cov = m, Kss
        eye = torch.eye(M, device=Xs.device, dtype=Xs.dtype)
        L = torch.linalg.cholesky(cov + 1e-10 * eye * Kss.diagonal().max())
        eps = torch.randn((n_draws, M), generator=gen, device=Xs.device,
                          dtype=Xs.dtype)
        return fmu[None, :] + eps @ L.T


def gp_fmin(cfg: GPConfig, gp: GP, maximize: bool = False,
            n_starts: int = 8):
    """Optimum of the GP posterior mean by L-BFGS from the ``n_starts`` best
    training points at once, inside the training box widened by half its
    span (`gplite/gplite_fmin.m`). Returns (x_opt (D,), f_opt)."""
    from vbmc_tpu_torch.optim import minimize_lbfgs_bounded

    X, y = _training_points(gp)
    sign = -1.0 if maximize else 1.0
    order = np.argsort(sign * y)[:n_starts]
    span = X.max(0) - X.min(0)

    def obj(x):
        return sign * gp_predict(cfg, gp, x)[0]

    xs, fs = minimize_lbfgs_bounded(obj, _t(gp, X[order]),
                                    _t(gp, X.min(0) - 0.5 * span),
                                    _t(gp, X.max(0) + 0.5 * span), maxiter=60)
    best = int(fs.argmin())
    return xs[best], float(sign * fs[best])


# Bound on S * M * grid elements of one chunk of `gp_quantile_pred`.
_QPRED_CHUNK_ELEMS = 2 ** 23


def gp_quantile_pred(cfg: GPConfig, gp: GP, Xstar,
                     quantiles=(0.025, 0.5, 0.975)) -> torch.Tensor:
    """Quantiles (len(quantiles), M) of the predictive mixture over the
    hyperparameter samples at Xstar (`gplite/gplite_qpred.m`): the mixture
    CDF on a 2001-point grid per point, inverted by linear interpolation as
    `np.interp` does."""
    n_grid = 2001
    Xs = torch.as_tensor(Xstar, device=gp.X.device, dtype=gp.X.dtype)
    with torch.no_grad():
        fmu, fs2 = gp_predict_full(cfg, gp, Xs)
        fmu, fs2 = fmu[gp.hyp_mask], fs2[gp.hyp_mask]               # (S, M)
        fsd = torch.sqrt(fs2.clamp_min(1e-24))
        pad = 2 * fsd.amax(0)
        lo = (fmu - 3 * fsd).amin(0) - pad
        hi = (fmu + 3 * fsd).amax(0) + pad
        steps = torch.arange(n_grid, device=Xs.device, dtype=Xs.dtype)
        grid = lo[:, None] + ((hi - lo) / (n_grid - 1))[:, None] * steps
        q = torch.as_tensor(np.asarray(quantiles, np.float64),
                            device=Xs.device, dtype=Xs.dtype)
        out = []
        chunk = max(1, _QPRED_CHUNK_ELEMS // (n_grid * fmu.shape[0]))
        for c in range(0, Xs.shape[0], chunk):
            g = grid[c:c + chunk]                                    # (m, G)
            z = ((g[None] - fmu[:, c:c + chunk, None])
                 / fsd[:, c:c + chunk, None])
            cdf = torch.special.ndtr(z).mean(0)                      # (m, G)
            qq = q[None, :].expand(g.shape[0], -1).contiguous()
            j = torch.searchsorted(cdf, qq, right=True).clamp(1, n_grid - 1)
            i = j - 1
            c0, c1 = cdf.gather(1, i), cdf.gather(1, j)
            g0, g1 = g.gather(1, i), g.gather(1, j)
            val = g0 + (qq - c0) * (g1 - g0) / (c1 - c0)
            val = torch.where(qq < cdf[:, :1], g[:, :1], val)
            val = torch.where(qq >= cdf[:, -1:], g[:, -1:], val)
            out.append(val.T)
        return torch.cat(out, 1)
