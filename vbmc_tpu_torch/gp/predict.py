"""GP prediction batched over hyperparameter samples
(cf. `vbmc_tpu/gp/predict.py`, `gplite/gplite_pred.m`)."""

from __future__ import annotations

import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.means import mean_function, int_mean_basis
from vbmc_tpu_torch.gp.outwarp import outwarp_deriv, outwarp_inverse


def gp_predict_full(cfg: GPConfig, gp: GP, Xstar: torch.Tensor):
    """Latent mean/variance per sample: (fmu (S, M), fs2 (S, M)); masked
    samples included (reduce with ``gp.hyp_mask``). The integrated mean's
    correction follows `gplite_pred.m:89-94,110-118`; under an output warp
    the mean is warped back and the variance follows by the delta method
    (`gplite_pred.m:130-149`)."""
    m = gp.mask.to(gp.X.dtype)
    ks = kernel_cross(cfg, gp.hyp, gp.X, Xstar) * m[None, :, None]  # (S,N,M)
    fmu = (mean_function(cfg, gp.hyp[:, cfg.sl_mean], Xstar)
           + (ks * gp.alpha[:, :, None]).sum(1))
    qf = (ks * (gp.Binv @ ks)).sum(1)
    kss = torch.exp(2.0 * gp.hyp[:, cfg.idx_log_sf])[:, None]
    fs2 = (kss - qf).clamp_min(0.0)
    if cfg.nint > 0:
        hs = int_mean_basis(cfg, Xstar)                       # (M, Nb)
        R = hs[None] - (gp.HBinv @ ks).transpose(-1, -2)      # (S, M, Nb)
        fmu = fmu + (R @ gp.betabar[..., None])[..., 0]
        fs2 = fs2 + (R * (R @ gp.Ainv)).sum(-1)
    if cfg.outwarp != 0:
        hyp_ow = gp.hyp[:, cfg.sl_outwarp]
        fmu = outwarp_inverse(cfg.outwarp, hyp_ow, fmu)
        g = outwarp_deriv(cfg.outwarp, hyp_ow, fmu)
        fs2 = fs2 / (g * g).clamp_min(torch.finfo(fs2.dtype).tiny)
    return fmu, fs2


def sample_summary(fmu, fs2, hyp_mask):
    """Masked mean and total variance (mean variance + between-sample
    variance, two-pass) over the sample axis (`gplite_pred.m:153-165`)."""
    m = hyp_mask.to(fmu.dtype)[:, None]
    ns = m.sum().clamp_min(1.0)
    fbar = (fmu * m).sum(0) / ns
    vbar = (fs2 * m).sum(0) / ns
    vf = (((fmu - fbar) ** 2) * m).sum(0) / (ns - 1.0).clamp_min(1.0)
    vf = torch.where(ns > 1, vf, torch.zeros_like(vf))
    return fbar, vf + vbar


def gp_predict(cfg: GPConfig, gp: GP, Xstar: torch.Tensor):
    """Moment-matched predictive summary across samples:
    (fbar (M,), vtot (M,), fmu (S, M), fs2 (S, M))."""
    fmu, fs2 = gp_predict_full(cfg, gp, Xstar)
    fbar, vtot = sample_summary(fmu, fs2, gp.hyp_mask)
    return fbar, vtot, fmu, fs2
