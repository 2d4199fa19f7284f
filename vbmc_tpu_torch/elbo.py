"""The Bayesian-quadrature ELBO (cf. `vbmc_tpu/elbo.py`,
`misc/gplogjoint.m`, `ent/entlb_vbmc.m`, `ent/entmc_vbmc.m`,
`misc/negelcbo_vbmc.m`), for the SE-ard covariance with every mean family
and the integrated mean.

Every function is batched over a leading axis B of variational parameter
sets (the reference vmaps over candidates and starts): mu (B, K, D),
sigma (B, K), lam (B, D), w (B, K), a shared kmask (K,). The GP's sample
axis S comes next. Gradients come from autograd through the packed
parameter vector theta (B, P).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import (
    GPConfig, COV_SEARD, MEAN_ZERO, MEAN_CONST, MEAN_NEGQUAD, MEAN_SE,
    MEAN_NEGQUADSE, MEAN_NEGQUADONLY, MEAN_NEGQUADLINONLY,
    MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX,
    MEAN_NEGQUADFIXONLY, MEAN_NEGQUADMIX, INTMEAN_LINEAR, INTMEAN_QUAD,
    INTMEAN_FULLQUAD)
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.gp.means import _center
from vbmc_tpu_torch.utils.math import to_np
from vbmc_tpu_torch.vp import masked_softmax

_LOG2PI = 1.8378770664093453


class VPFlags(NamedTuple):
    """Which variational parameter blocks are optimised."""
    opt_mu: bool = True
    opt_sigma: bool = True
    opt_lambda: bool = True
    opt_weights: bool = False


def theta_size(flags: VPFlags, K: int, D: int) -> int:
    """Length P of the packed parameter vector theta."""
    return (K * D * flags.opt_mu + K * flags.opt_sigma + D * flags.opt_lambda
            + K * flags.opt_weights)


def pack_theta(flags: VPFlags, mu, sigma, lam, eta):
    """theta (B, P) from mu (B, K, D), sigma (B, K), lam (B, D), eta (B, K)."""
    parts = []
    if flags.opt_mu:
        parts.append(mu.reshape(mu.shape[0], -1))
    if flags.opt_sigma:
        parts.append(torch.log(sigma))
    if flags.opt_lambda:
        parts.append(torch.log(lam))
    if flags.opt_weights:
        parts.append(eta)
    return torch.cat(parts, dim=-1)


def unpack_theta(flags: VPFlags, theta, K: int, D: int, mu0, sigma0, lam0,
                 w0, kmask):
    """(mu, sigma, lam, w) from theta (B, P); lambda is renormalised to
    ||lam||^2 = D with sigma compensating (`misc/rescale_params.m`) and the
    weights are a masked softmax of eta."""
    B = theta.shape[0]
    i = 0
    if flags.opt_mu:
        mu = theta[:, :K * D].reshape(B, K, D)
        i = K * D
    else:
        mu = mu0.expand(B, K, D)
    if flags.opt_sigma:
        sigma = torch.exp(theta[:, i:i + K])
        i += K
    else:
        sigma = sigma0.expand(B, K)
    if flags.opt_lambda:
        lam = torch.exp(theta[:, i:i + D])
        i += D
    else:
        lam = lam0.expand(B, D)
    nl = torch.sqrt((lam ** 2).sum(-1, keepdim=True) / D)
    lam = lam / nl
    sigma = sigma * nl
    if flags.opt_weights:
        w = masked_softmax(theta[:, i:i + K], kmask)
    else:
        w = w0.expand(B, K)
    return mu, sigma, lam, w


# ----------------------------------------------------------------------
# Expected log joint under the GP (Bayesian quadrature)
# ----------------------------------------------------------------------

def _s2lam2(sigma, lam):
    """The components' diagonal covariances sigma_k^2 lam_d^2: (B, K, D)."""
    return (sigma[:, :, None] ** 2) * (lam[:, None, :] ** 2)


def _negquad_nu_at(xm, omega2, mu, sigma, lam):
    """E_q[-1/2 sum ((x - xm)/omega)^2] per (B, S, K), in closed form
    (`gplogjoint.m:171-174`). xm, omega2: (S, D)."""
    xm = xm[None, :, None, :]                                   # (1,S,1,D)
    m = mu[:, None]
    quad = (m ** 2 + _s2lam2(sigma, lam)[:, None] - 2.0 * m * xm
            + xm ** 2) / omega2[None, :, None, :]
    return -0.5 * quad.sum(-1)


def _se_bump_nu(xm, omega2, h, mu, sigma, lam):
    """E_q[h exp(-1/2 sum ((x - xm)/omega)^2)] per (B, S, K)
    (`gplogjoint.m:175-179`). xm, omega2: (S, D); h: (S,)."""
    o2 = omega2[None, :, None, :]
    tau2 = _s2lam2(sigma, lam)[:, None] + o2                    # (B,S,K,D)
    s2 = (mu[:, None] - xm[None, :, None, :]) ** 2 / tau2
    lognf = 0.5 * (torch.log(o2) - torch.log(tau2)).sum(-1)
    return h[None, :, None] * torch.exp(lognf - 0.5 * s2.sum(-1))


def _negquadmix_nu(hyp_mean, D, mu, sigma, lam):
    """E_q of the quadratic mixture less its constant m0 + hm
    (`gplogjoint.m:181-195`): the window term needs the first and second
    moments of q_k tilted by the Gaussian window. (B, S, K)"""
    xm = hyp_mean[:, 1:D + 1]
    omega2 = torch.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])
    hm = hyp_mean[:, 2 * D + 1][None, :, None]
    rho2 = torch.exp(2.0 * hyp_mean[:, 2 * D + 2])
    beta2 = torch.exp(2.0 * hyp_mean[:, 2 * D + 3])[None, :, None]
    s2lam2 = _s2lam2(sigma, lam)[:, None]                       # (B,1,K,D)
    nu1 = _negquad_nu_at(xm, omega2, mu, sigma, lam) / beta2
    # E[window] = prod_d sqrt(rho2 w_d^2 / t2_d) exp(-(mu - xm)^2 / (2 t2))
    ro2 = (rho2[:, None] * omega2)[None, :, None, :]            # (1,S,1,D)
    xm_, o2_ = xm[None, :, None, :], omega2[None, :, None, :]
    t2 = s2lam2 + ro2
    dmu = mu[:, None] - xm_
    atil = torch.exp(0.5 * (torch.log(ro2) - torch.log(t2)).sum(-1)
                     - 0.5 * (dmu ** 2 / t2).sum(-1))
    # q_k times the window is Gaussian with variance s2lam2 rho2 w^2 / t2
    # and mean (xm s2lam2 + mu rho2 w^2) / t2
    mutil = (xm_ * s2lam2 + mu[:, None] * ro2) / t2
    vartil = s2lam2 * ro2 / t2
    qtil = ((vartil + (mutil - xm_) ** 2) / o2_).sum(-1)
    return nu1 - hm * atil - 0.5 * (1.0 - 1.0 / beta2) * atil * qtil


def _mean_nu(cfg: GPConfig, hyp_mean, mu, sigma, lam):
    """E_{q_k}[m(x)] for every mean family: (B, S, K), or 0.0 for the zero
    mean."""
    D = cfg.D
    mf = cfg.meanfun
    if mf == MEAN_ZERO:
        return 0.0
    m0 = hyp_mean[:, 0][None, :, None]
    if mf == MEAN_CONST:
        return m0
    if mf in (MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE):
        xm = hyp_mean[:, 1:D + 1]
        omega2 = torch.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])
        if mf == MEAN_SE:
            return m0 + _se_bump_nu(xm, omega2,
                                    torch.exp(hyp_mean[:, 2 * D + 1]),
                                    mu, sigma, lam)
        nu = m0 + _negquad_nu_at(xm, omega2, mu, sigma, lam)
        if mf == MEAN_NEGQUADSE:      # the bump's height is raw
            nu = nu + _se_bump_nu(
                hyp_mean[:, 2 * D + 1:3 * D + 1],
                torch.exp(2.0 * hyp_mean[:, 3 * D + 1:4 * D + 1]),
                hyp_mean[:, 4 * D + 1], mu, sigma, lam)
        return nu
    if mf == MEAN_NEGQUADONLY:
        omega2 = torch.exp(2.0 * hyp_mean[:, :D])
        return _negquad_nu_at(torch.zeros_like(omega2), omega2, mu, sigma,
                              lam)
    if mf == MEAN_NEGQUADLINONLY:
        return _negquad_nu_at(hyp_mean[:, :D],
                              torch.exp(2.0 * hyp_mean[:, D:2 * D]), mu,
                              sigma, lam)
    if mf in (MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX,
              MEAN_NEGQUADFIXONLY):
        # the centre is the fit's constant cfg.fix_center
        # (`gplogjoint.m:112-121,134-138`)
        S = hyp_mean.shape[0]
        xm = _center(cfg, mu).expand(S, D)
        if mf == MEAN_NEGQUADFIXONLY:
            return _negquad_nu_at(xm, torch.exp(2.0 * hyp_mean[:, :D]), mu,
                                  sigma, lam)
        if mf == MEAN_NEGQUADFIXISO:
            omega2 = torch.exp(2.0 * hyp_mean[:, 1:2]).expand(S, D)
        else:
            omega2 = torch.exp(2.0 * hyp_mean[:, 1:D + 1])
        nu = m0 + _negquad_nu_at(xm, omega2, mu, sigma, lam)
        if mf == MEAN_NEGQUADSEFIX:
            # the constrained bump: omega_se = alpha omega, and the offset
            # -h_se folded into m0 (`gplogjoint.m:134-138`)
            alpha2 = torch.exp(2.0 * hyp_mean[:, D + 1:D + 2])
            h_se = torch.exp(hyp_mean[:, D + 2])
            nu = (nu - h_se[None, :, None]
                  + _se_bump_nu(xm, alpha2 * omega2, h_se, mu, sigma, lam))
        return nu
    if mf == MEAN_NEGQUADMIX:
        return (m0 + hyp_mean[:, 2 * D + 1][None, :, None]
                + _negquadmix_nu(hyp_mean, D, mu, sigma, lam))
    raise ValueError("gplogjoint supports zero/const/negquad/se/"
                     "negquadse/negquad(fix/fixiso/sefix/fixonly)/"
                     "negquadonly/negquadlinonly/negquadmix means")


def _z_matrix(cfg: GPConfig, gp: GP, mu, sigma, lam):
    """z_{b,s,k,n} = E_{q_k}[k(x, X_n)] for SE-ard (`gplogjoint.m:164-168`),
    masked over padded rows. Returns (z, lnnf (B, S, K), tau2 (B, S, K, D))."""
    if cfg.covfun != COV_SEARD:
        raise ValueError(
            "the Bayesian-quadrature ELBO requires the SE-ard kernel "
            "(covfun=1); seiso/Matérn are gplite-library families only, "
            "as in the reference (`gplogjoint.m` hard-codes SE-ard)")
    D = cfg.D
    log_ell = gp.hyp[:, :D]                                    # (S, D)
    ell2 = torch.exp(2.0 * log_ell)
    ln_sf2 = 2.0 * gp.hyp[:, D]
    sum_lnell = log_ell.sum(-1)
    tau2 = _s2lam2(sigma, lam)[:, None] + ell2[None, :, None, :]  # (B,S,K,D)
    lnnf = (ln_sf2 + sum_lnell)[None, :, None] - 0.5 * torch.log(tau2).sum(-1)
    inv_tau2 = 1.0 / tau2
    X = gp.X
    mu2_term = (mu[:, None] ** 2 * inv_tau2).sum(-1)            # (B, S, K)
    cross = torch.einsum("bskd,nd->bskn", mu[:, None] * inv_tau2, X)
    x2 = torch.einsum("bskd,nd->bskn", inv_tau2, X * X)
    quad = mu2_term[..., None] - 2.0 * cross + x2
    z = torch.exp(lnnf[..., None] - 0.5 * quad)
    return z * gp.mask.to(z.dtype), lnnf, tau2


def _int_basis_expect(cfg: GPConfig, mu, sigma, lam):
    """E_{q_k}[h(x)] for the integrated mean's polynomial basis under each
    component N(mu_k, sigma_k^2 Lambda^2), in closed form because the
    component's covariance is diagonal: (B, K, Nb). (`misc/gplogjoint.m`
    has no integrated mean; this follows the JAX package.)"""
    cols = [mu.new_ones(mu.shape[:2] + (1,))]
    if cfg.intmean >= INTMEAN_LINEAR:
        cols.append(mu)
    if cfg.intmean >= INTMEAN_QUAD:
        cols.append(mu * mu + _s2lam2(sigma, lam))
    if cfg.intmean >= INTMEAN_FULLQUAD:
        iu, ju = torch.triu_indices(cfg.D, cfg.D, 1, device=mu.device)
        cols.append(mu.index_select(-1, iu) * mu.index_select(-1, ju))
    return torch.cat(cols, dim=-1)


def _intmean_r(cfg: GPConfig, gp: GP, mu, sigma, lam, z):
    """The quadrature's residual basis r_sk = E_k[h] - H B^-1 E_k[k(., X)],
    the R(x) of `gplite_pred.m:89-94` under the component's expectation:
    (B, S, K, Nb)."""
    hbar = _int_basis_expect(cfg, mu, sigma, lam)               # (B, K, Nb)
    return hbar[:, None] - torch.einsum("sbn,cskn->cskb", gp.HBinv, z)


def gplogjoint_I(cfg: GPConfig, gp: GP, mu, sigma, lam, z=None):
    """Per-sample, per-component expected log joint I (B, S, K)."""
    if z is None:
        z = _z_matrix(cfg, gp, mu, sigma, lam)[0]
    I = (torch.einsum("bskn,sn->bsk", z, gp.alpha)
         + _mean_nu(cfg, gp.hyp[:, cfg.sl_mean], mu, sigma, lam))
    if cfg.nint > 0:
        r = _intmean_r(cfg, gp, mu, sigma, lam, z)
        I = I + torch.einsum("bskc,sc->bsk", r, gp.betabar)
    return I


def gplogjoint_J(cfg: GPConfig, gp: GP, mu, sigma, lam, kmask, z=None):
    """Posterior covariance of the quadrature integral per sample,
    J (B, S, K, K) (`gplogjoint.m:306-339`)."""
    D = cfg.D
    if z is None:
        z = _z_matrix(cfg, gp, mu, sigma, lam)[0]
    log_ell = gp.hyp[:, :D]
    ell2 = torch.exp(2.0 * log_ell)
    ln_sf2 = 2.0 * gp.hyp[:, D]
    sum_lnell = log_ell.sum(-1)
    ss2 = sigma[:, :, None] ** 2 + sigma[:, None, :] ** 2       # (B, K, K)
    logdet = 0.0
    quad = 0.0
    for d in range(D):  # avoids a (B, S, K, K, D) temporary
        tau2_d = (ss2[:, None] * (lam[:, d] ** 2)[:, None, None, None]
                  + ell2[:, d][None, :, None, None])          # (B, S, K, K)
        logdet = logdet + torch.log(tau2_d)
        dmu = (mu[:, :, d, None] - mu[:, None, :, d]) ** 2      # (B, K, K)
        quad = quad + dmu[:, None] / tau2_d
    lnnf_jk = (ln_sf2 + sum_lnell)[None, :, None, None] - 0.5 * logdet
    prior_term = torch.exp(lnnf_jk - 0.5 * quad)
    # Data correction z_j^T B^{-1} z_k through the Cholesky factor, not the
    # explicit inverse (J is a small difference of large terms).
    Lb = gp.L.expand(z.shape[0], *gp.L.shape)
    U = torch.cholesky_solve(z.transpose(-1, -2), Lb)           # (B,S,N,K)
    J = prior_term - z @ U
    if cfg.nint > 0:
        # + r_j^T A^-1 r_k: the bilinear form factorises through the double
        # integral, so the correction is exact
        r = _intmean_r(cfg, gp, mu, sigma, lam, z)              # (B,S,K,Nb)
        J = J + torch.einsum("bsjc,scd,bskd->bsjk", r, gp.Ainv, r)
    mK = kmask.to(J.dtype)
    return J * mK[:, None] * mK[None, :]


def _sample_stats(x, hyp_mask):
    """Masked mean / variance over the sample axis (axis 1)."""
    m = hyp_mask.to(x.dtype)
    ns = m.sum().clamp_min(1.0)
    mw = m.reshape((1, -1) + (1,) * (x.ndim - 2))
    mean = (x * mw).sum(1) / ns
    var = (((x - mean.unsqueeze(1)) ** 2) * mw).sum(1) / \
        (ns - 1.0).clamp_min(1.0)
    return mean, torch.where(ns > 1, var, torch.zeros_like(var))


def gplogjoint(cfg: GPConfig, gp: GP, mu, sigma, lam, w, kmask,
               compute_var: int = 0):
    """Expected log joint G (B,), averaged over hyperparameter samples.
    compute_var: 0 none, 1 full K x K covariance, 2 diagonal only.
    Returns (G, varG, varss, I, J)."""
    z = _z_matrix(cfg, gp, mu, sigma, lam)[0]
    I = gplogjoint_I(cfg, gp, mu, sigma, lam, z=z)
    wk = w * kmask.to(w.dtype)
    F_s = torch.einsum("bsk,bk->bs", I, wk)
    G, varF_ss = _sample_stats(F_s, gp.hyp_mask)
    if compute_var == 0:
        return G, torch.zeros_like(G), varF_ss, I, None
    J = gplogjoint_J(cfg, gp, mu, sigma, lam, kmask, z=z)
    eps = torch.finfo(J.dtype).eps
    dJ = torch.diagonal(J, dim1=-2, dim2=-1)
    diag = dJ.clamp_min(eps)
    if compute_var == 2:
        varF_s = ((wk ** 2)[:, None, :] * diag).sum(-1)
    else:
        J_sym = J - torch.diag_embed(dJ) + torch.diag_embed(diag)
        varF_s = torch.einsum("bj,bsjk,bk->bs", wk, J_sym, wk)
    varF_s = varF_s.clamp_min(eps)
    varF_mean, varF_var = _sample_stats(varF_s, gp.hyp_mask)
    return G, varF_mean + varF_ss, varF_ss + torch.sqrt(varF_var), I, J


# ----------------------------------------------------------------------
# Entropy estimators
# ----------------------------------------------------------------------

def entropy_lower_bound(mu, sigma, lam, w, kmask):
    """Deterministic entropy lower bound (`ent/entlb_vbmc.m:66-127`) with
    the exact-entropy correction for a single active component. (B,)"""
    D = mu.shape[-1]
    m = kmask.to(mu.dtype)
    ss2 = sigma[:, :, None] ** 2 + sigma[:, None, :] ** 2
    d2 = (((mu[:, :, None, :] - mu[:, None, :, :]) / lam[:, None, None, :])
          ** 2).sum(-1) / ss2
    log_nconst = -0.5 * D * _LOG2PI - torch.log(lam).sum(-1)
    log_gamma = log_nconst[:, None, None] - 0.5 * D * torch.log(ss2) - 0.5 * d2
    wk = w * m
    gamma_max = torch.where(m[None, None, :] > 0, log_gamma,
                            -torch.inf).amax(-1, keepdim=True)
    gsum = (wk[:, None, :] * torch.exp(log_gamma - gamma_max)).sum(-1)
    log_gsum = torch.log(gsum.clamp_min(torch.finfo(gsum.dtype).tiny)) \
        + gamma_max[..., 0]
    H = -torch.where(kmask, w * log_gsum, 0.0).sum(-1)
    return H + torch.where(m.sum() == 1, 0.5 * D * (1.0 - math.log(2.0)), 0.0)


def entropy_upper_bound(mu, sigma, lam, w, kmask):
    """Gaussian moment-matching upper bound on the mixture entropy
    (`ent/entub_vbmc.m`): the entropy of the Gaussian with the mixture's
    covariance. (B,)"""
    D = mu.shape[-1]
    wk = w * kmask.to(w.dtype)
    mean = (wk[..., None] * mu).sum(-2, keepdim=True)            # (B, 1, D)
    dmu = mu - mean
    cov = (dmu * wk[..., None]).transpose(-1, -2) @ dmu          # (B, D, D)
    cov = cov + torch.diag_embed((wk * sigma ** 2).sum(-1, keepdim=True)
                                 * lam ** 2)
    return 0.5 * D * (1.0 + _LOG2PI) + 0.5 * torch.linalg.slogdet(cov)[1]


def entropy_mc(mu, sigma, lam, w, kmask, eps_half):
    """Monte Carlo entropy with antithetic samples (`ent/entmc_vbmc.m`),
    differentiable by the reparameterisation trick. eps_half:
    (B, K, n/2, D) standard normals. (B,)"""
    D = mu.shape[-1]
    dt = mu.dtype
    eps = torch.cat([eps_half, -eps_half], dim=2)               # (B,K,n,D)
    scale = sigma[:, :, None] * lam[:, None, :]                 # (B, K, D)
    xi = mu[:, :, None, :] + scale[:, :, None, :] * eps
    z2 = 0.0
    for d in range(D):  # (B, Kj, n, Kk) without a D axis
        z2 = z2 + ((xi[:, :, :, None, d] - mu[:, None, None, :, d])
                   / scale[:, None, None, :, d]) ** 2
    log_norm = -0.5 * D * _LOG2PI - torch.log(scale).sum(-1)    # (B, K)
    comp = log_norm[:, None, None, :] - 0.5 * z2
    logw = torch.where(kmask, torch.log(w.clamp_min(torch.finfo(dt).tiny)),
                       torch.finfo(dt).min)
    logq = torch.logsumexp(comp + logw[:, None, None, :], dim=-1)
    return -torch.where(kmask, w * logq.mean(-1), 0.0).sum(-1)


# ----------------------------------------------------------------------
# Soft bounds on variational parameters
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ThetaBounds:
    """Soft-bound data (`misc/vpbounds.m`): per-dim mu and log-scale
    (sigma * lambda) bounds plus the weight-penalty constants."""
    mu_lb: torch.Tensor
    mu_ub: torch.Tensor
    lnscale_lb: torch.Tensor
    lnscale_ub: torch.Tensor
    tol_con: float
    weight_threshold: float
    weight_penalty: float


def compute_vp_bounds(gp: GP, options, K: int) -> ThetaBounds:
    """Soft bounds from the training-point hull (`vpbounds.m:17-30`)."""
    X = to_np(gp.X)
    m = to_np(gp.mask).astype(bool)
    Xa = X[m] if m.any() else X
    Xmin, Xmax = Xa.min(axis=0), Xa.max(axis=0)
    lnrange = np.log(np.maximum(Xmax - Xmin, 1e-10))

    def t(v):
        return torch.as_tensor(v, device=gp.X.device, dtype=gp.X.dtype)

    return ThetaBounds(
        mu_lb=t(Xmin), mu_ub=t(Xmax),
        lnscale_lb=t(lnrange + np.log(options.tol_length)),
        lnscale_ub=t(lnrange), tol_con=options.tol_con_loss,
        weight_threshold=max(1.0 / (4 * K), options.tol_weight),
        weight_penalty=options.weight_penalty)


def vp_bound_loss(flags: VPFlags, bnd: ThetaBounds, mu, sigma, lam, w,
                  kmask):
    """Soft-bound hinge loss + small-weight penalty (`misc/vpbndloss.m`,
    `negelcbo_vbmc.m:136-163`). (B,)"""
    m = kmask.to(mu.dtype)
    L = torch.zeros(mu.shape[0], dtype=mu.dtype, device=mu.device)
    if flags.opt_mu:
        ell = (bnd.mu_ub - bnd.mu_lb) * bnd.tol_con
        lo = (bnd.mu_lb - mu).clamp_min(0.0) / ell
        hi = (mu - bnd.mu_ub).clamp_min(0.0) / ell
        L = L + 0.5 * (m[:, None] * (lo ** 2 + hi ** 2)).sum((-1, -2))
    if flags.opt_sigma or flags.opt_lambda:
        lnscale = torch.log(sigma)[:, :, None] + torch.log(lam)[:, None, :]
        ell = (bnd.lnscale_ub - bnd.lnscale_lb) * bnd.tol_con
        lo = (bnd.lnscale_lb - lnscale).clamp_min(0.0) / ell
        hi = (lnscale - bnd.lnscale_ub).clamp_min(0.0) / ell
        L = L + 0.5 * (m[:, None] * (lo ** 2 + hi ** 2)).sum((-1, -2))
    if flags.opt_weights:
        wclip = torch.where(w < bnd.weight_threshold, w, bnd.weight_threshold)
        L = L + (m * wclip).sum(-1) * bnd.weight_penalty
    return L


# ----------------------------------------------------------------------
# Negative EL(C)BO objective
# ----------------------------------------------------------------------

def draw_entropy_eps(gen: torch.Generator, B: int, K: int, n_per_k: int,
                     like: torch.Tensor):
    """Standard normals (B, K, n_per_k/2, D) for `entropy_mc`."""
    half = max(n_per_k // 2, 1)
    return torch.randn((B, K, half, like.shape[-1]), generator=gen,
                       device=like.device, dtype=like.dtype)


def _entropy(mu, sigma, lam, w, kmask, n_ent_per_k, gen, eps_half):
    if n_ent_per_k > 0:
        if eps_half is None:
            eps_half = draw_entropy_eps(gen, mu.shape[0], mu.shape[1],
                                        n_ent_per_k, mu)
        return entropy_mc(mu, sigma, lam, w, kmask, eps_half)
    return entropy_lower_bound(mu, sigma, lam, w, kmask)


def negelcbo(cfg: GPConfig, theta, gp: GP, mu0, sigma0, lam0, w0, kmask,
             flags: VPFlags, beta: float, n_ent_per_k: int, compute_var: int,
             gen: Optional[torch.Generator] = None,
             bnd: Optional[ThetaBounds] = None, use_bounds: bool = False,
             eps_half=None):
    """Negative ELCBO F = -(G + H) + beta * sqrt(varF) (+ soft-bound loss)
    for theta (B, P). Returns (F (B,), (G, H, varF, varss))."""
    K, D = mu0.shape
    mu, sigma, lam, w = unpack_theta(flags, theta, K, D, mu0, sigma0, lam0,
                                     w0, kmask)
    G, varG, varss, _, _ = gplogjoint(cfg, gp, mu, sigma, lam, w, kmask,
                                      compute_var=compute_var)
    H = _entropy(mu, sigma, lam, w, kmask, n_ent_per_k, gen, eps_half)
    F = -G - H
    if beta != 0:
        F = F + beta * torch.sqrt(varG.clamp_min(1e-30))
    if use_bounds and bnd is not None:
        F = F + vp_bound_loss(flags, bnd, mu, sigma, lam, w, kmask)
    return F, (G, H, varG, varss)


def elbo_stats(cfg: GPConfig, theta, gp: GP, mu0, sigma0, lam0, w0, kmask,
               flags: VPFlags, n_ent_per_k: int, compute_var: int,
               gen: Optional[torch.Generator] = None, eps_half=None):
    """Precise EL(C)BO with full variance and per-component quadrature
    stats (`vpoptimize_vbmc.m:257-304`), for theta (B, P). Returns a dict
    of batched tensors."""
    K, D = mu0.shape
    mu, sigma, lam, w = unpack_theta(flags, theta, K, D, mu0, sigma0, lam0,
                                     w0, kmask)
    G, varG, varss, I, J = gplogjoint(cfg, gp, mu, sigma, lam, w, kmask,
                                      compute_var=compute_var)
    H = _entropy(mu, sigma, lam, w, kmask, n_ent_per_k, gen, eps_half)
    return dict(elbo=G + H, G=G, H=H, varF=varG, varss=varss, I_sk=I,
                J_sjk=J if J is not None else torch.zeros_like(G),
                mu=mu, sigma=sigma, lam=lam, w=w)
