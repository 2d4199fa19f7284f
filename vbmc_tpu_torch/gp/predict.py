"""GP prediction batched over hyperparameter samples
(cf. `vbmc_tpu/gp/predict.py`, `gplite/gplite_pred.m`)."""

from __future__ import annotations

import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.core import Posterior, predict_one
from vbmc_tpu_torch.gp.gp import GP


def gp_predict_full(cfg: GPConfig, gp: GP, Xstar: torch.Tensor):
    """Latent mean/variance per sample: (fmu (S, M), fs2 (S, M)); masked
    samples included (reduce with ``gp.hyp_mask``). `core.predict_one` on
    the GP's stored factorisation."""
    post = Posterior(gp.alpha, gp.L, gp.Binv, gp.sn2, None, gp.betabar,
                     gp.HBinv, gp.Ainv)
    return predict_one(cfg, gp.hyp, post, gp.X, gp.y, gp.mask, Xstar)


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
