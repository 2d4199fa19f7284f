"""Bayesian quadrature of the GP against Gaussian smoothing kernels
(cf. `vbmc_tpu/gp/quad.py`, `gplite/gplite_quad.m`): E[f] and Var[f] under
N(x*, diag(delta^2)) in closed form, for the SE-ard kernel with every mean
family and the integrated mean. The acquisitions use it when
``options.bandwidth > 0``.

A smoothing kernel at x* is one mixture component with mean x* and
covariance diag(delta^2), so the closed forms are those of the variational
quadrature in `elbo.py` (`_z_matrix`, `_mean_nu`, `_intmean_r`) with the
candidates as the components."""

from __future__ import annotations

import torch

from vbmc_tpu_torch.elbo import _intmean_r, _mean_nu, _z_matrix
from vbmc_tpu_torch.gp.config import GPConfig, COV_SEARD
from vbmc_tpu_torch.gp.gp import GP


def gp_quad(cfg: GPConfig, gp: GP, Xstar: torch.Tensor, delta: torch.Tensor,
            compute_var: bool = True):
    """Quadrature mean and variance per hyperparameter sample at smoothing
    kernels centred on the rows of Xstar (M, D), with SD ``delta`` (D,) per
    dimension. Returns (fmu (S, M), fs2 (S, M) or None)."""
    if cfg.covfun != COV_SEARD:
        raise ValueError(
            "gp_quad closed forms require the SE-ard kernel (covfun=1), "
            "as in the reference (`gplite_quad.m:37-40`)")
    D = cfg.D
    # one batch of M components: mu = x*, sigma = 1, lam = delta
    mu, lam = Xstar[None], delta[None]
    sigma = Xstar.new_ones(1, Xstar.shape[0])
    z, _, _ = _z_matrix(cfg, gp, mu, sigma, lam)       # (1, S, M, N)
    fmu = (torch.einsum("bsmn,sn->bsm", z, gp.alpha)
           + _mean_nu(cfg, gp.hyp[:, cfg.sl_mean], mu, sigma, lam))[0]
    r_int = None
    if cfg.nint > 0:
        r_int = _intmean_r(cfg, gp, mu, sigma, lam, z)[0]      # (S, M, Nb)
        fmu = fmu + torch.einsum("smb,sb->sm", r_int, gp.betabar)
    if not compute_var:
        return fmu, None

    # nf_kk - z B^-1 z with tau_kk^2 = 2 delta^2 + ell^2
    log_ell = gp.hyp[:, :D]
    tau2_kk = 2.0 * (delta ** 2)[None, :] + torch.exp(2.0 * log_ell)
    lnnf_kk = (2.0 * gp.hyp[:, D] + log_ell.sum(-1)
               - 0.5 * torch.log(tau2_kk).sum(-1))
    z = z[0]
    fs2 = torch.exp(lnnf_kk)[:, None] - ((z @ gp.Binv) * z).sum(-1)
    if r_int is not None:
        fs2 = fs2 + ((r_int @ gp.Ainv) * r_int).sum(-1)
    return fmu, fs2.clamp_min(torch.finfo(fs2.dtype).eps)
