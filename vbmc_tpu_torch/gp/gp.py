"""The GP surrogate container (cf. `vbmc_tpu/gp/gp.py`): padded, masked
tensors with a leading hyperparameter-sample axis."""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp import core
from vbmc_tpu_torch.utils.math import bucket_n, pad_to, to_np


@dataclasses.dataclass
class HypPrior:
    mu: torch.Tensor      # (nhyp,)
    sigma: torch.Tensor   # (nhyp,) non-finite => flat prior
    df: torch.Tensor      # (nhyp,) finite > 0 => Student-t, else Gaussian
    lb: torch.Tensor      # (nhyp,) hard bounds
    ub: torch.Tensor
    plb: torch.Tensor     # (nhyp,) plausible box
    pub: torch.Tensor

    @functools.cached_property
    def host_box(self):
        """Host float64 copies (lb, ub, plb, pub) of the hard bounds and of
        the plausible box, its infinite ends replaced by the hard bounds."""
        lb, ub, plb, pub = (to_np(v) for v in (self.lb, self.ub, self.plb,
                                                 self.pub))
        return (lb, ub, np.where(np.isfinite(plb), plb, lb),
                np.where(np.isfinite(pub), pub, ub))


@dataclasses.dataclass
class GP:
    """Trained GP surrogate with S hyperparameter samples (padded)."""

    X: torch.Tensor         # (N_max, D) training inputs (transformed space)
    y: torch.Tensor         # (N_max,)
    s2: torch.Tensor        # (N_max,) user noise variance (0: noiseless)
    mask: torch.Tensor      # (N_max,) bool
    hyp: torch.Tensor       # (S_max, nhyp)
    hyp_mask: torch.Tensor  # (S_max,) bool
    alpha: torch.Tensor     # (S_max, N_max)
    L: torch.Tensor         # (S_max, N_max, N_max)
    Binv: torch.Tensor      # (S_max, N_max, N_max) explicit inverse
    sn2: torch.Tensor       # (S_max, N_max)
    # the integrated mean's extras (None unless cfg.intmean > 0)
    betabar: Optional[torch.Tensor] = None   # (S_max, Nb)
    HBinv: Optional[torch.Tensor] = None     # (S_max, Nb, N_max)
    Ainv: Optional[torch.Tensor] = None      # (S_max, Nb, Nb)

    @property
    def n_max(self) -> int:
        return self.X.shape[0]

    @property
    def s_max(self) -> int:
        return self.hyp.shape[0]

    @property
    def D(self) -> int:
        return self.X.shape[1]


def build_gp(cfg: GPConfig, X, y, s2, mask, hyp_samples, hyp_mask) -> GP:
    """Posterior factorisations for all hyperparameter samples; masked
    samples are factorised too (dense buffers) and excluded from averages
    through ``hyp_mask``."""
    alpha, L, Binv, sn2, _, extras = core.build_posterior(
        cfg, hyp_samples, X, y, s2, mask)
    return GP(X=X, y=y, s2=s2, mask=mask, hyp=hyp_samples, hyp_mask=hyp_mask,
              alpha=alpha, L=L, Binv=Binv, sn2=sn2, **extras)


def pad_training_data(X: np.ndarray, y: np.ndarray, s2: Optional[np.ndarray],
                      n_bucket: Optional[int] = None, *, device,
                      dtype) -> tuple:
    """Host training data (``s2`` the user noise variance, or None for
    none) padded to ``n_bucket`` rows, by default `bucket_n` of its size, on
    ``device`` in ``dtype``. Returns (X, y, s2, mask), ``mask`` true on the
    rows that hold data."""
    n = X.shape[0]
    nb = bucket_n(n) if n_bucket is None else n_bucket

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    return (t(pad_to(np.asarray(X, float), nb)),
            t(pad_to(np.asarray(y, float).ravel(), nb)),
            t(np.zeros(nb) if s2 is None
              else pad_to(np.asarray(s2, float).ravel(), nb)),
            torch.as_tensor(np.arange(nb) < n, device=device))


def gp_from_host(cfg: GPConfig, X: np.ndarray, y: np.ndarray,
                 s2: Optional[np.ndarray], hyp_samples: np.ndarray,
                 n_bucket: int, s_bucket: int, *, device="cpu",
                 dtype=torch.float64) -> GP:
    """Pad host data to buckets and build the GP. Padded hyperparameter
    slots replicate the first sample (well-conditioned factorisations)."""
    s = hyp_samples.shape[0]
    hs = pad_to(np.asarray(hyp_samples, float), s_bucket)
    hs[s:] = hs[0]
    hmask = torch.as_tensor(np.arange(s_bucket) < s, device=device)
    return build_gp(cfg, *pad_training_data(X, y, s2, n_bucket, device=device,
                                            dtype=dtype),
                    torch.as_tensor(hs, device=device, dtype=dtype), hmask)
