"""Masked GP core math (cf. `vbmc_tpu/gp/core.py`): posterior
factorisation, marginal likelihood and hyperpriors.

The training set lives in padded buffers with a boolean mask; padded rows
become identity rows of the system matrix and drop out exactly. Every
function is batched over a leading axis of hyperparameter vectors (the
reference's `vmap`). Gradients come from autograd through the Cholesky.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.means import mean_function, int_mean_basis
from vbmc_tpu_torch.gp.noise import noise_variance
from vbmc_tpu_torch.gp.outwarp import (outwarp_direct, outwarp_deriv,
                                       outwarp_inverse)

_LOG2PI = 1.8378770664093453


class Posterior(NamedTuple):
    """The factorisation `build_posterior` returns, by name, batched over
    the S hyperparameter samples (`Posterior.of` takes that tuple)."""
    alpha: torch.Tensor      # (S, N) B^-1 (y - m), zero on padded rows
    L: torch.Tensor          # (S, N, N) lower Cholesky factor of B
    Binv: torch.Tensor       # (S, N, N) B^-1
    sn2: torch.Tensor        # (S, N) noise variance per point
    chol_ok: Optional[torch.Tensor] = None   # (S,) first try succeeded
    # the integrated mean's extras (None unless cfg.intmean > 0)
    betabar: Optional[torch.Tensor] = None   # (S, Nb)
    HBinv: Optional[torch.Tensor] = None     # (S, Nb, N)
    Ainv: Optional[torch.Tensor] = None      # (S, Nb, Nb)

    @classmethod
    def of(cls, built) -> "Posterior":
        alpha, L, Binv, sn2, ok, extras = built
        return cls(alpha, L, Binv, sn2, ok, **extras)


def warped_observations(cfg: GPConfig, hyp: torch.Tensor, y, s2, mask):
    """Apply the output warp to the observations and the user noise:
    (t (Bt, N), s2 warped (Bt, N), log_jac (Bt,)), where log_jac is the
    masked sum of log |dt/dy| (`gplite_core.m:14-26,196-198`). Without a
    warp y and s2 come back as they are, with log_jac 0."""
    if cfg.outwarp == 0:
        return y[None, :], s2, hyp.new_zeros(hyp.shape[0])
    hyp_ow = hyp[:, cfg.sl_outwarp]
    t = outwarp_direct(cfg.outwarp, hyp_ow, y[None, :])
    g = outwarp_deriv(cfg.outwarp, hyp_ow, y[None, :])
    m = mask.to(y.dtype)
    log_jac = (torch.log(g.abs() + torch.finfo(y.dtype).tiny) * m).sum(-1)
    s2w = None if s2 is None else s2 * g * g
    return t * m, s2w, log_jac


def gram_matrix(cfg: GPConfig, hyp: torch.Tensor, X: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked Gram matrix (Bt, N, N) for hyp (Bt, nhyp): zero rows and
    columns at padded entries."""
    m = mask.to(X.dtype)
    return kernel_cross(cfg, hyp, X, X) * (m[:, None] * m[None, :])


def _system_matrix(cfg: GPConfig, hyp: torch.Tensor, X, y, s2, mask):
    """B = K + diag(sn2) with identity rows/cols on padded entries:
    ((Bt, N, N), sn2 (Bt, N)). ``y`` (N,) is the observation vector before
    any output warp: the output-dependent noise keys on it even under a
    warp (`gplite_core.m:35`). ``s2``, (N,) or (Bt, N), is the user noise
    variance, already scaled by the warp (None for noiseless targets)."""
    m = mask.to(X.dtype)
    K = gram_matrix(cfg, hyp, X, mask)
    sn2 = noise_variance(cfg, hyp[:, cfg.sl_noise], X.shape[0], s2, y)
    diag = sn2 * m + (1.0 - m)
    return K + torch.diag_embed(diag), sn2


def _chol_ok(L, info):
    return (info == 0) & torch.isfinite(
        torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)


def robust_cholesky(B: torch.Tensor):
    """Batched Cholesky with per-element jitter escalation
    (`gplite_core.m:78-95`). The reference reads a failed factorisation from
    a non-finite diagonal; here `cholesky_ex` reports it in ``info``, and
    each failed element retries alone with jitter scale * 10^(t-12),
    t = 1..11. Returns (L, ok_first_try)."""
    L, info = torch.linalg.cholesky_ex(B)
    first_ok = _chol_ok(L, info)
    ok = first_ok
    scale = torch.diagonal(B, dim1=-2, dim2=-1).abs().mean(-1)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    for t in range(1, 12):
        bad = ~ok
        if not bool(bad.any()):
            break
        jitter = scale[bad] * 10.0 ** (t - 12)
        Lb, infob = torch.linalg.cholesky_ex(B[bad] + jitter[:, None, None] * eye)
        L = L.clone()
        L[bad] = Lb
        ok = ok.clone()
        ok[bad] = _chol_ok(Lb, infob)
    return L, first_ok


def _factor(B):
    """Lower Cholesky factors of the batch B (Bt, n, n), the identity where
    a factor fails, and which succeeded (Bt,)."""
    L, info = torch.linalg.cholesky_ex(B)
    ok = _chol_ok(L, info)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return torch.where(ok[:, None, None], L, eye), ok


class _CholeskyOrIdentity(torch.autograd.Function):
    """`_factor` with Cholesky's usual backward pass (Murray 2016, the
    formula `torch.linalg.cholesky` differentiates by), zero on the rows
    whose factor failed."""

    @staticmethod
    def forward(B):
        return _factor(B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        L, ok = output
        ctx.save_for_backward(L, ok)
        ctx.mark_non_differentiable(ok)

    @staticmethod
    def backward(ctx, gL, _):
        L, ok = ctx.saved_tensors
        gB = (L.mH @ gL).tril()
        gB = 0.5 * (gB + gB.tril(-1).mH)
        gB = torch.linalg.solve_triangular(L.mH, gB, upper=True, left=True)
        gB = torch.linalg.solve_triangular(L, gB, upper=False, left=False)
        return torch.where(ok[:, None, None], gB, 0.0)


def _factor_or_identity(B):
    """Lower Cholesky factors of the batch B (Bt, n, n) and which of them
    succeeded (Bt,); a failed factor is the identity. One factorisation,
    and nothing reads the host: where autograd can reach B, the backward
    pass gives the failed rows a zero gradient, so no NaN reaches it and a
    step that differentiates through it can be captured as a CUDA graph."""
    if not B.requires_grad:
        return _factor(B)
    return _CholeskyOrIdentity.apply(B)


def _masked_basis(cfg: GPConfig, X, m):
    """The integrated mean's basis at the training inputs, zero on padded
    rows: (N, Nb)."""
    return int_mean_basis(cfg, X) * m[:, None]


def build_posterior(cfg: GPConfig, hyp: torch.Tensor, X, y, s2, mask):
    """Posterior factorisation for hyp (S, nhyp): alpha (S, N), L and the
    explicit inverse Binv (S, N, N), sn2 (S, N), chol_ok (S,), and a dict
    of the integrated mean's extras, each None unless ``cfg.intmean > 0``:
    the GLS estimate of the basis coefficients betabar (S, Nb), HBinv
    (S, Nb, N) and Ainv = (H B^-1 H^T)^-1 (S, Nb, Nb) (the `intmean` block
    of `gplite_post.m:174-197`, `gplite_core.m:106-124`)."""
    t, s2w, _ = warped_observations(cfg, hyp, y, s2, mask)
    B, sn2 = _system_matrix(cfg, hyp, X, y, s2w, mask)
    m = mask.to(X.dtype)
    r = (t - mean_function(cfg, hyp[:, cfg.sl_mean], X)) * m
    L, ok = robust_cholesky(B)
    alpha = (torch.cholesky_solve(r[..., None], L)[..., 0] * m).contiguous()
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    # cholesky_solve returns column-major matrices; the sweep kernel reads
    # Binv row-major.
    Binv = torch.cholesky_solve(eye.expand_as(B), L).contiguous()
    extras = dict(betabar=None, HBinv=None, Ainv=None)
    if cfg.nint > 0:
        H = _masked_basis(cfg, X, m)                          # (N, Nb)
        BiH = torch.cholesky_solve(H.expand(B.shape[0], -1, -1), L)
        A = H.T @ BiH                                         # (S, Nb, Nb)
        eye_b = torch.eye(cfg.nint, dtype=B.dtype, device=B.device)
        Ainv = torch.cholesky_solve(eye_b.expand_as(A),
                                    torch.linalg.cholesky_ex(A)[0])
        betabar = (Ainv @ (H.T @ alpha[..., None]))[..., 0]
        extras = dict(betabar=betabar,
                      HBinv=BiH.transpose(-1, -2).contiguous(),
                      Ainv=Ainv.contiguous())
    return alpha, L, Binv, sn2, ok, extras


def neg_log_marginal_likelihood(cfg: GPConfig, hyp: torch.Tensor, X, y, s2,
                                mask) -> torch.Tensor:
    """Masked negative log marginal likelihood (B,), differentiable in hyp.
    Where the Cholesky fails the value is +inf and the gradient 0; nothing
    waits for the device (`_factor_or_identity`), so a sampler's or an
    optimiser's step can be captured as a CUDA graph. Under an output warp the
    likelihood is that of the warped observations plus the Jacobian of the
    change of variables (`gplite_core.m:196-198`); an integrated mean's
    coefficients are marginalised exactly under a vague prior
    (`gplite_core.m:133-189`)."""
    t, s2w, log_jac = warped_observations(cfg, hyp, y, s2, mask)
    B, _ = _system_matrix(cfg, hyp, X, y, s2w, mask)
    m = mask.to(X.dtype)
    r = (t - mean_function(cfg, hyp[:, cfg.sl_mean], X)) * m
    L, ok = _factor_or_identity(B)
    a = torch.cholesky_solve(r[..., None], L)[..., 0]
    nlZ = (0.5 * (r * a).sum(-1)
           + (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) * m).sum(-1)
           + 0.5 * m.sum() * _LOG2PI)
    if cfg.nint > 0:
        # nlZ += -1/2 u^T A^-1 u + 1/2 log|A| - Nb/2 log(2 pi), with
        # A = H B^-1 H^T and u = H B^-1 r
        H = _masked_basis(cfg, X, m)
        A = H.T @ torch.cholesky_solve(H.expand(B.shape[0], -1, -1), L)
        u = (H.T @ a[..., None])
        LA, ok_a = _factor_or_identity(A)
        ok = ok & ok_a
        w = torch.linalg.solve_triangular(LA, u, upper=False)[..., 0]
        nlZ = (nlZ - 0.5 * (w * w).sum(-1)
               + torch.log(torch.diagonal(LA, dim1=-2, dim2=-1)).sum(-1)
               - 0.5 * cfg.nint * _LOG2PI)
    return torch.where(ok, nlZ - log_jac, math.inf)


def hyperprior_logpdf(prior, hyp: torch.Tensor) -> torch.Tensor:
    """Log prior over hyp (B, nhyp) (cf. `gplite_hypprior.m`): Student-t(df)
    for finite df > 0, Gaussian otherwise, flat where sigma is non-finite."""
    mu, sigma, df = prior.mu, prior.sigma, prior.df
    has_prior = torch.isfinite(sigma)
    sigma_s = torch.where(has_prior, sigma, 1.0)
    z = (hyp - torch.where(has_prior, mu, 0.0)) / sigma_s
    use_t = (df > 0) & torch.isfinite(df)
    df_s = torch.where(use_t, df, 1.0)
    lp_t = (torch.lgamma(0.5 * (df_s + 1.0)) - torch.lgamma(0.5 * df_s)
            - 0.5 * torch.log(math.pi * df_s) - torch.log(sigma_s)
            - 0.5 * (df_s + 1.0) * torch.log1p(z * z / df_s))
    lp_g = -0.5 * math.log(2.0 * math.pi) - torch.log(sigma_s) - 0.5 * z * z
    lp = torch.where(use_t, lp_t, lp_g)
    return torch.where(has_prior, lp, 0.0).sum(-1)


def gp_log_posterior(cfg: GPConfig, prior, hyp, X, y, s2, mask):
    """Unnormalised log posterior of hyperparameters (B,)."""
    return (-neg_log_marginal_likelihood(cfg, hyp, X, y, s2, mask)
            + hyperprior_logpdf(prior, hyp))


def solve_K(post: Posterior, v: torch.Tensor) -> torch.Tensor:
    """B^-1 v per sample from the Cholesky factor: v (N,) gives (S, N);
    v (N, k) or (S, N, k) gives (S, N, k)."""
    if v.dim() == 1:
        return torch.cholesky_solve(v[:, None].expand(
            post.L.shape[0], -1, -1), post.L)[..., 0]
    return torch.cholesky_solve(v.expand(post.L.shape[0], -1, -1), post.L)


def predict_one(cfg: GPConfig, hyp: torch.Tensor, post: Posterior, X, y,
                mask, Xstar):
    """Latent mean and variance at Xstar (M, D) for each sample of hyp
    (S, nhyp): (fmu (S, M), fs2 (S, M)), by products with the stored B^-1.
    The integrated mean's correction follows `gplite_pred.m:89-94,110-118`;
    under an output warp the mean is warped back and the variance follows
    by the delta method (`gplite_pred.m:130-149`). ``y`` is unused, as in
    the reference's signature."""
    m = mask.to(X.dtype)
    ks = kernel_cross(cfg, hyp, X, Xstar) * m[None, :, None]     # (S,N,M)
    fmu = (mean_function(cfg, hyp[:, cfg.sl_mean], Xstar)
           + (ks * post.alpha[:, :, None]).sum(1))
    qf = (ks * (post.Binv @ ks)).sum(1)
    kss = torch.exp(2.0 * hyp[:, cfg.idx_log_sf])[:, None]
    fs2 = (kss - qf).clamp_min(0.0)
    if cfg.nint > 0:
        hs = int_mean_basis(cfg, Xstar)                       # (M, Nb)
        R = hs[None] - (post.HBinv @ ks).transpose(-1, -2)    # (S, M, Nb)
        fmu = fmu + (R @ post.betabar[..., None])[..., 0]
        fs2 = fs2 + (R * (R @ post.Ainv)).sum(-1)
    if cfg.outwarp != 0:
        hyp_ow = hyp[:, cfg.sl_outwarp]
        fmu = outwarp_inverse(cfg.outwarp, hyp_ow, fmu)
        g = outwarp_deriv(cfg.outwarp, hyp_ow, fmu)
        fs2 = fs2 / (g * g).clamp_min(torch.finfo(fs2.dtype).tiny)
    return fmu, fs2
