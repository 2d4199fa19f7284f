"""Random GP problems for the port's parity tests: a configuration, its
data and plausible hyperparameter vectors, all from a numpy seed, for every
family of `GPConfig` (both packages take the same numbers)."""

import dataclasses

import numpy as np

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp.means import mean_info, fix_center_from_data
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig

ALL_MEANFUNS = (0, 1, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22)
FIXED_CENTER = (10, 12, 14, 18)


def tcfg_of(cfg) -> TGPConfig:
    """The port's copy of a reference configuration."""
    return TGPConfig(**dataclasses.asdict(cfg))


def gp_problem(seed, D=3, n=25, S=4, noisy=False, **cfg_kw):
    """(cfg, X, y, s2, hyps (S, nhyp)) with hyperparameters inside the
    plausible box of each block."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.05 * rng.standard_normal(n)
    s2 = 0.01 + 0.02 * rng.random(n) if noisy else None
    if cfg_kw.get("meanfun", 4) in FIXED_CENTER:
        cfg_kw.setdefault("fix_center", fix_center_from_data(X, y))
    cfg = GPConfig(D=D, **cfg_kw)
    hyps = np.zeros((S, cfg.nhyp))
    ne = cfg.n_ell
    hyps[:, :ne] = np.log(0.9) + 0.1 * rng.standard_normal((S, ne))
    hyps[:, ne] = 0.2 * rng.standard_normal(S)
    i = cfg.ncov
    if cfg.const_noise:
        hyps[:, i] = np.log(0.05)
        i += 1
    if cfg.user_noise == 2:
        hyps[:, i] = 0.3 * rng.standard_normal(S)
        i += 1
    if cfg.output_noise:
        hyps[:, i] = np.median(y) + 0.3 * rng.standard_normal(S)
        hyps[:, i + 1] = np.log(0.05)
    if cfg.nmean:
        info = mean_info(cfg, X, y)
        lo = np.maximum(info["plb"], info["x0"] - 1.0)
        hi = np.minimum(info["pub"], info["x0"] + 1.0)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        hyps[:, cfg.sl_mean] = lo + rng.random((S, cfg.nmean)) * (hi - lo)
    if cfg.noutwarp:
        ow = np.zeros((S, cfg.noutwarp))
        ow[:, 0] = np.quantile(y, 0.6) + 0.2 * rng.standard_normal(S)
        ow[:, 1:] = 0.2 * rng.standard_normal((S, cfg.noutwarp - 1))
        hyps[:, cfg.sl_outwarp] = ow
    return cfg, X, y, s2, hyps
