"""Variational posterior: a mixture of K axis-rescaled Gaussians in padded,
masked tensors, and the public posterior queries (cf. `vbmc_tpu/vp.py`,
`vbmc_rnd.m`, `vbmc_pdf.m`, `vbmc_moments.m`, `vbmc_mode.m`,
`vbmc_kldiv.m`, `vbmc_mtv.m`, `vbmc_power.m`).

In transformed space q(x) = sum_k w_k N(x; mu_k, sigma_k^2 diag(lambda^2)).
Components beyond the active count have w = 0 and a false ``kmask``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.transforms import (Trinfo, direct, inverse,
                                       log_abs_det_jacobian)
from vbmc_tpu_torch.utils.math import mvn_kl, to_np

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass
class VariationalPosterior:
    w: torch.Tensor       # (K_max,) mixture weights; 0 on padded slots
    eta: torch.Tensor     # (K_max,) unnormalised log weights
    mu: torch.Tensor      # (K_max, D) component means (transformed space)
    sigma: torch.Tensor   # (K_max,) per-component scale
    lam: torch.Tensor     # (D,) common axis scales (||lam||^2 = D)
    kmask: torch.Tensor   # (K_max,) bool: active components
    trinfo: Trinfo

    @property
    def k_max(self) -> int:
        return self.w.shape[0]

    @property
    def D(self) -> int:
        return self.mu.shape[1]

    def replace(self, **kw) -> "VariationalPosterior":
        return dataclasses.replace(self, **kw)


def make_vp(trinfo: Trinfo, mu: np.ndarray, sigma, lam, w=None,
            k_max: Optional[int] = None) -> VariationalPosterior:
    """Host-side constructor on the trinfo's device and dtype; pads K to
    ``k_max``."""
    mu = np.atleast_2d(np.asarray(mu, float))
    K, D = mu.shape
    k_max = K if k_max is None else k_max
    sigma = np.broadcast_to(np.asarray(sigma, float).ravel(), (K,))
    lam = np.asarray(lam, float).ravel()
    w = np.full(K, 1.0 / K) if w is None else np.asarray(w, float).ravel()
    w = w / w.sum()
    mu_p = np.zeros((k_max, D))
    mu_p[:K] = mu
    sg_p = np.ones(k_max)
    sg_p[:K] = sigma
    w_p = np.zeros(k_max)
    w_p[:K] = w
    eta_p = np.full(k_max, -40.0)
    eta_p[:K] = np.log(np.maximum(w, 1e-30))
    return vp_from_np(trinfo, w_p, eta_p, mu_p, sg_p, lam,
                      np.arange(k_max) < K)


def vp_from_np(trinfo: Trinfo, w, eta, mu, sigma, lam, kmask):
    dev, dt = trinfo.mu.device, trinfo.mu.dtype

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), device=dev, dtype=dt)

    return VariationalPosterior(
        w=t(w), eta=t(eta), mu=t(mu), sigma=t(sigma), lam=t(lam),
        kmask=torch.as_tensor(np.array(kmask, bool), device=dev),
        trinfo=trinfo)


def masked_softmax(eta: torch.Tensor, kmask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to active components."""
    e = torch.where(kmask, eta, torch.finfo(eta.dtype).min)
    e = e - e.max(-1, keepdim=True).values
    ex = torch.exp(e) * kmask.to(eta.dtype)
    return ex / ex.sum(-1, keepdim=True)


def _logw(vp: VariationalPosterior):
    tiny = torch.finfo(vp.mu.dtype).tiny
    return torch.where(vp.kmask, torch.log(vp.w.clamp_min(tiny)), -math.inf)


def vp_log_pdf_trans(vp: VariationalPosterior, X: torch.Tensor,
                     df: float = 0.0) -> torch.Tensor:
    """Log mixture density at transformed-space points X (M, D); df > 0
    gives the multivariate-t variant (`vbmc_pdf.m:52-104`)."""
    D = vp.D
    scale = vp.sigma[:, None] * vp.lam[None, :]                  # (K, D)
    z2 = (((X[None, :, :] - vp.mu[:, None, :])
           / scale[:, None, :]) ** 2).sum(-1)                    # (K, M)
    log_norm = -torch.log(scale).sum(-1)                         # (K,)
    if df and df > 0:
        lognf = (math.lgamma(0.5 * (df + D)) - math.lgamma(0.5 * df)
                 - 0.5 * D * math.log(df * math.pi))
        comp = lognf + log_norm[:, None] - 0.5 * (df + D) * torch.log1p(z2 / df)
    else:
        comp = -0.5 * D * _LOG2PI + log_norm[:, None] - 0.5 * z2
    return torch.logsumexp(comp + _logw(vp)[:, None], dim=0)


def _chi2(gen: torch.Generator, df: float, shape, like: torch.Tensor):
    """Chi-square draws from ``gen`` for any df > 0: a sum of df squared
    normals where df is an integer, else twice a Gamma(df / 2) draw (the
    reference draws the gamma for every df, `vbmc_tpu/vp.py:153-156`; the
    sums keep the stream of the integer df the search sets use, until the
    card-against-CPU rule that the new stream trips is set from readings:
    ROADMAP Queue 3 z)."""
    k = int(df)
    if k == df and k >= 1:
        z = torch.randn((k,) + tuple(shape), generator=gen,
                        device=like.device, dtype=like.dtype)
        return (z * z).sum(0)
    return 2.0 * _gamma(gen, df / 2.0, shape, like)


def _gamma(gen: torch.Generator, a: float, shape, like: torch.Tensor):
    """Gamma(a, 1) draws for any a > 0 from ``gen``: Marsaglia and Tsang's
    rejection method, for a < 1 at shape a + 1 times U^(1/a)."""
    if not a > 0:
        raise ValueError(f"the gamma shape must be positive (got {a})")
    dev, dt = like.device, like.dtype
    d = (a + 1.0 if a < 1.0 else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=dev, dtype=dt).flatten()
    todo = torch.arange(out.numel(), device=dev)
    while todo.numel():
        n = todo.numel()
        x = torch.randn(n, generator=gen, device=dev, dtype=dt)
        u = torch.rand(n, generator=gen, device=dev, dtype=dt)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(torch.finfo(dt).tiny)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    if a < 1.0:
        u = torch.rand(out.shape, generator=gen, device=dev, dtype=dt)
        out = out * u ** (1.0 / a)
    return out.reshape(shape)


def vp_rnd(vp: VariationalPosterior, gen: torch.Generator, N: int,
           orig_flag: bool = True, balance_flag: bool = False,
           df: float = 0.0) -> torch.Tensor:
    """Draw N samples (`vbmc_rnd.m`). Balanced mode assigns floor(w_k N)
    samples to each component and the remainder by categorical draws."""
    dev = vp.mu.device
    w = vp.w * vp.kmask.to(vp.w.dtype)
    if balance_flag:
        counts = np.floor(to_np(w) * N).astype(np.int64)
        base = torch.repeat_interleave(
            torch.arange(vp.k_max, device=dev),
            torch.as_tensor(counts, device=dev))[:N]
        n_extra = N - base.shape[0]
        extra = torch.multinomial(w, n_extra, replacement=True,
                                  generator=gen) if n_extra > 0 else base[:0]
        idx = torch.cat([base, extra])
    else:
        idx = torch.multinomial(w, N, replacement=True, generator=gen)
    eps = torch.randn((N, vp.D), generator=gen, device=dev, dtype=vp.mu.dtype)
    if df and df > 0:
        eps = eps * torch.sqrt(df / _chi2(gen, df, (N, 1), eps))
    X = vp.mu[idx] + vp.sigma[idx][:, None] * vp.lam[None, :] * eps
    return inverse(vp.trinfo, X) if orig_flag else X


def vp_pdf(vp: VariationalPosterior, X, orig_flag: bool = True,
           log_flag: bool = False, df: float = 0.0) -> torch.Tensor:
    """Density at points X (M, D) on the VP's device; with ``orig_flag`` X is
    in original space and the Jacobian correction applies
    (`vbmc_pdf.m:113-124`)."""
    if not isinstance(X, torch.Tensor):
        X = np.array(X, np.float64)
    X = torch.atleast_2d(torch.as_tensor(X, device=vp.mu.device,
                                         dtype=vp.mu.dtype))
    if orig_flag:
        U = direct(vp.trinfo, X)
        lp = vp_log_pdf_trans(vp, U, df=df) - log_abs_det_jacobian(vp.trinfo, U)
    else:
        lp = vp_log_pdf_trans(vp, X, df=df)
    return lp if log_flag else torch.exp(lp)


def vp_moments(vp: VariationalPosterior, orig_flag: bool = True,
               n_samples: int = 10 ** 6,
               gen: Optional[torch.Generator] = None):
    """Mean and covariance (`vbmc_moments.m`): analytic in transformed
    space, Monte Carlo through the inverse transform in original space."""
    if not orig_flag:
        w = vp.w
        mean = (w[:, None] * vp.mu).sum(0)
        dmu = vp.mu - mean
        cov = (dmu * w[:, None]).T @ dmu
        return mean, cov + torch.diag((w * vp.sigma ** 2).sum() * vp.lam ** 2)
    if gen is None:
        gen = torch.Generator(device=vp.mu.device).manual_seed(0)
    X = vp_rnd(vp, gen, n_samples, orig_flag=True, balance_flag=True)
    mean = X.mean(0)
    Xc = X - mean
    return mean, (Xc.T @ Xc) / (X.shape[0] - 1)


def vp_kldiv(vp1: VariationalPosterior, vp2: VariationalPosterior,
             n_samples: int = 10 ** 5, gauss_flag: bool = True,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Symmetrised KL components (KL(1||2), KL(2||1)) (`vbmc_kldiv.m`)."""
    if gen is None:
        gen = torch.Generator(device=vp1.mu.device).manual_seed(0)
    if gauss_flag:
        m1, c1 = vp_moments(vp1, True, n_samples, gen)
        m2, c2 = vp_moments(vp2, True, n_samples, gen)
        return torch.stack(mvn_kl(m1, c1, m2, c2))
    X1 = vp_rnd(vp1, gen, n_samples, orig_flag=False)
    X2 = vp_rnd(vp2, gen, n_samples, orig_flag=False)
    kl1 = (vp_log_pdf_trans(vp1, X1) - vp_log_pdf_trans(vp2, X1)).mean()
    kl2 = (vp_log_pdf_trans(vp2, X2) - vp_log_pdf_trans(vp1, X2)).mean()
    return torch.stack([kl1.clamp_min(0.0), kl2.clamp_min(0.0)])


def vp_mode(vp: VariationalPosterior, orig_flag: bool = True) -> torch.Tensor:
    """Posterior mode (`vbmc_mode.m`): L-BFGS from every component mean at
    once (with infinite bounds the optimiser works on x itself), the best
    active start kept. With ``orig_flag`` the original-space density is
    maximised, parameterised in transformed coordinates."""
    from vbmc_tpu_torch.optim import minimize_lbfgs_bounded

    def nlp(x):
        lp = vp_log_pdf_trans(vp, x)
        if orig_flag:
            lp = lp - log_abs_det_jacobian(vp.trinfo, x)
        return -lp

    inf = torch.full((vp.D,), math.inf, device=vp.mu.device,
                     dtype=vp.mu.dtype)
    xs, fs = minimize_lbfgs_bounded(nlp, vp.mu.detach(), -inf, inf,
                                    maxiter=60)
    x_best = xs[torch.where(vp.kmask, fs, math.inf).argmin()]
    return inverse(vp.trinfo, x_best[None, :])[0] if orig_flag else x_best


def vp_mtv(vp1: VariationalPosterior, vp2: VariationalPosterior,
           n_samples: int = 10 ** 5,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Marginal total variation per dimension (`vbmc_mtv.m`): 1-D KDEs of
    draws from both VPs on a 2^13-point mesh, trapezoidal integration of
    |p1 - p2| / 2. The draws come from the first VP's device; the KDEs run
    on the host."""
    from vbmc_tpu_torch.utils.kde import kde1d

    if gen is None:
        gen = torch.Generator(device=vp1.mu.device).manual_seed(0)
    X1 = to_np(vp_rnd(vp1, gen, n_samples, orig_flag=True))
    X2 = to_np(vp_rnd(vp2, gen, n_samples, orig_flag=True))
    mtv = np.zeros(X1.shape[1])
    nkde = 2 ** 13
    for d in range(X1.shape[1]):
        lo1, hi1 = X1[:, d].min(), X1[:, d].max()
        lo2, hi2 = X2[:, d].min(), X2[:, d].max()
        lo = min(lo1, lo2) - 0.1 * (max(hi1, hi2) - min(lo1, lo2))
        hi = max(hi1, hi2) + 0.1 * (max(hi1, hi2) - min(lo1, lo2))
        f1, grid = kde1d(X1[:, d], nkde, lo, hi)
        f2, _ = kde1d(X2[:, d], nkde, lo, hi)
        f1 = f1 / np.trapezoid(f1, grid)
        f2 = f2 / np.trapezoid(f2, grid)
        mtv[d] = 0.5 * np.trapezoid(np.abs(f1 - f2), grid)
    return torch.as_tensor(mtv, device=vp1.mu.device, dtype=vp1.mu.dtype)


def vp_train2real(vp: VariationalPosterior, temperature,
                  elbo: float, elbo_sd: float):
    """A tempered training posterior to the real one (`misc/vptrain2real.m`):
    vp_real = vp^T with elbo_real = T elbo + lnZ_pow."""
    if temperature is None or temperature == 1:
        return vp, elbo, elbo_sd
    vp_real, lnz_pow = vp_power(vp, n=temperature, return_lnz=True)
    return vp_real, temperature * elbo + lnz_pow, temperature * elbo_sd


def vp_power(vp: VariationalPosterior, n: int = 2, cutoff: float = 1e-6,
             return_lnz: bool = False):
    """The power posterior vp^n for n = 2 (`vbmc_power.m`): the square of a
    Gaussian mixture is a K^2-component mixture, normalised by lnZ_pow;
    pairs whose weight falls below ``cutoff`` times the largest are dropped.
    Host arithmetic on the first K (active) components; the result lives on
    the VP's device."""
    if n == 1:
        return vp
    if n != 2:
        raise NotImplementedError("only n in {1, 2} supported")
    K = int(to_np(vp.kmask).sum())
    w, mu, sigma = to_np(vp.w)[:K], to_np(vp.mu)[:K], to_np(vp.sigma)[:K]
    lam = to_np(vp.lam)
    D = lam.shape[0]
    s2 = sigma ** 2
    sj, sk = s2[:, None], s2[None, :]                         # (K, K)
    ssum = sj + sk
    pairs_mu = ((mu[:, None, :] * sk[..., None] + mu[None, :, :] * sj[..., None])
                / ssum[..., None]).reshape(K * K, D)
    pairs_sigma = np.sqrt(sj * sk / ssum).ravel()
    d2 = (((mu[:, None, :] - mu[None, :, :]) / lam) ** 2).sum(-1) / ssum
    logz = (-0.5 * D * np.log(2 * np.pi) - 0.5 * D * np.log(ssum)
            - np.sum(np.log(lam)) - 0.5 * d2)
    pw = (w[:, None] * w[None, :] * np.exp(logz)).ravel()
    lnz_pow = float(np.log(max(pw.sum(), 1e-300)))
    pw = pw / pw.sum()
    keep = pw > cutoff * pw.max()
    out = make_vp(vp.trinfo, pairs_mu[keep], pairs_sigma[keep], lam,
                  w=pw[keep] / pw[keep].sum())
    return (out, lnz_pow) if return_lnz else out


def is_valid_vp(obj) -> bool:
    """Whether ``obj`` is a variational posterior (`vbmc_isavp.m`)."""
    return isinstance(obj, VariationalPosterior)
