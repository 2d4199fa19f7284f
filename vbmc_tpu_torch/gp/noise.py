"""GP observation noise (cf. `vbmc_tpu/gp/noise.py`,
`gplite/gplite_noisefun.m`): the total noise variance of each training
point is the constant noise term plus the user-provided noise, taken as
given (``user_noise`` 1) or rescaled by a hyperparameter (``user_noise``
2), plus rectified-linear output-dependent noise (``output_noise`` 1)."""

from __future__ import annotations

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import GPConfig


def noise_variance(cfg: GPConfig, hyp_noise: torch.Tensor, n: int,
                   s2=None, y=None) -> torch.Tensor:
    """Per-point noise variance (B, n) for hyp_noise (B, nnoise), the user
    noise variance s2, (n,) or (B, n), and the observations y (n,) that the
    output-dependent term keys on (None counts as 0 for either)."""
    B = hyp_noise.shape[0]
    idx = 0
    if cfg.const_noise == 1:
        sn2 = torch.exp(2.0 * hyp_noise[:, :1]).expand(B, n)
        idx += 1
    else:
        sn2 = torch.full((B, n), torch.finfo(hyp_noise.dtype).eps,
                         dtype=hyp_noise.dtype, device=hyp_noise.device)
    if cfg.user_noise == 1:
        if s2 is not None:
            sn2 = sn2 + s2
    elif cfg.user_noise == 2:
        if s2 is not None:
            sn2 = sn2 + torch.exp(hyp_noise[:, idx:idx + 1]) * s2
        idx += 1
    if cfg.output_noise == 1:
        ythresh = hyp_noise[:, idx:idx + 1]
        w2 = torch.exp(2.0 * hyp_noise[:, idx + 1:idx + 2])
        zz = torch.clamp(ythresh - (0.0 if y is None else y), min=0.0)
        sn2 = sn2 + w2 * zz * zz
    return sn2


def noise_info(cfg: GPConfig, y: np.ndarray):
    """Bounds / plausible box / x0 of the noise hyperparameters."""
    nn = cfg.nnoise
    info = dict(lb=np.full(nn, -np.inf), ub=np.full(nn, np.inf),
                plb=np.full(nn, -np.inf), pub=np.full(nn, np.inf),
                x0=np.full(nn, np.nan))
    if y.size <= 1:
        y = np.array([0.0, 1.0])
    height = max(y.max() - y.min(), 1e-10)
    ToL = 1e-6
    idx = 0
    if cfg.const_noise == 1:
        for k, v in dict(lb=np.log(ToL), ub=np.log(height),
                         plb=0.5 * np.log(ToL),
                         pub=np.log(max(np.std(y, ddof=1), 1e-10)),
                         x0=np.log(1e-3)).items():
            info[k][idx] = v
        idx += 1
    if cfg.user_noise == 2:
        for k, v in dict(lb=np.log(1e-3), ub=np.log(1e3), plb=np.log(0.5),
                         pub=np.log(2.0), x0=0.0).items():
            info[k][idx] = v
        idx += 1
    if cfg.output_noise == 1:
        # the threshold, then the log slope; the caller sets the
        # threshold's own bounds from the dimension
        miny, maxy = y.min(), y.max()
        for k, v in dict(lb=miny, ub=maxy, plb=miny, pub=max(maxy - 5, miny),
                         x0=max(maxy - 10, miny)).items():
            info[k][idx] = v
        for k, v in dict(lb=np.log(1e-3), ub=np.log(0.1), plb=np.log(0.01),
                         pub=np.log(0.1), x0=np.log(0.1)).items():
            info[k][idx + 1] = v
    return info
