"""Deployment ``d10k50``: an anisotropic Gaussian at D = 10, the top of the
range of VBMC's synthetic benchmark (Acerbi 2018); the target is this
repository's own stress target, normalised, so that lnZ = 0, the mean is 0
and the covariance is diag(sd^2) with sd = linspace(sd_lo, sd_hi, D)."""

from __future__ import annotations

import numpy as np


def _sd(cfg):
    return np.linspace(cfg["sd_lo"], cfg["sd_hi"], cfg["D"])


def make_target(cfg):
    sd = _sd(cfg)
    D = cfg["D"]
    lnz = cfg["lnz"]
    const = -0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)) + lnz

    def mvn(x):
        return float(-0.5 * np.sum((np.asarray(x) / sd) ** 2) + const)
    return mvn


def truth(cfg):
    sd = _sd(cfg)
    return dict(lnz=float(cfg["lnz"]), mean=np.zeros(cfg["D"]),
                cov=np.diag(sd ** 2))
