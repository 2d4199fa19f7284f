"""Covariance functions (cf. `vbmc_tpu/gp/kernels.py`). Families follow the
reference ids (`gplite_covfun.m:77-91`): 0 'seiso' (one length scale, 2
hyperparameters), 1 'se' ard (D+1, the VBMC default), 3 'matern' ard with
degree nu in {1, 3, 5} (`GPConfig.cov_nu`, D+1). Every function is batched
over a leading axis of hyperparameter vectors."""

from __future__ import annotations

import torch

from vbmc_tpu_torch.gp.config import (GPConfig, COV_SEISO, COV_SEARD,
                                      COV_MATERN)
from vbmc_tpu_torch.utils.math import sq_dist


def kernel_cross(cfg: GPConfig, hyp: torch.Tensor, Xa: torch.Tensor,
                 Xb: torch.Tensor) -> torch.Tensor:
    """k(Xa, Xb) for hyperparameters hyp (B, nhyp): (B, n, m)."""
    # (B, 1, 1) for the iso kernel: broadcasts over D
    ell = torch.exp(hyp[:, cfg.sl_log_ell])[:, None, :]
    sf2 = torch.exp(2.0 * hyp[:, cfg.idx_log_sf])[:, None, None]
    d2 = sq_dist(Xa / ell, Xb / ell)
    if cfg.covfun in (COV_SEARD, COV_SEISO):
        return sf2 * torch.exp(-0.5 * d2)
    if cfg.covfun == COV_MATERN:
        # K = sf2 f(t) exp(-t), t = sqrt(nu) r (`gplite_covfun.m:195-214`).
        # The Gram diagonal and identical padded rows have d2 = 0, where
        # d sqrt / d d2 is infinite; a single where on the result would
        # still pass inf * 0 = NaN back to the length scales, so the
        # argument of the sqrt is made safe first. The true dK/dell there
        # is 0.
        if cfg.cov_nu not in (1, 3, 5):
            raise ValueError(
                f"Matérn degree nu must be 1, 3 or 5 (got {cfg.cov_nu})")
        d2c = torch.clamp(cfg.cov_nu * d2, min=0.0)
        pos = d2c > 0
        t = torch.where(pos, torch.sqrt(torch.where(pos, d2c, 1.0)), 0.0)
        if cfg.cov_nu == 1:
            f = 1.0
        elif cfg.cov_nu == 3:
            f = 1.0 + t
        else:
            f = 1.0 + t * (1.0 + t / 3.0)
        return sf2 * f * torch.exp(-t)
    raise ValueError(f"unsupported covfun {cfg.covfun}")
