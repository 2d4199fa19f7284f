"""GP mean functions and their hyperparameter info
(cf. `vbmc_tpu/gp/means.py`): zero, constant, negative quadratic (the VBMC
default), squared exponential and the negative-quadratic variants of
`gplite/gplite_meanfun.m:399-572`, and the basis of the integrated
Bayesian-linear mean. Evaluation is batched over hyperparameter vectors;
the info is host NumPy."""

from __future__ import annotations

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import (
    GPConfig, MEAN_ZERO, MEAN_CONST, MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE,
    MEAN_NEGQUADONLY, MEAN_NEGQUADLINONLY, MEAN_NEGQUADFIXISO,
    MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX, MEAN_NEGQUADFIXONLY, MEAN_NEGQUADMIX,
    INTMEAN_NONE, INTMEAN_LINEAR, INTMEAN_QUAD, INTMEAN_FULLQUAD)


def fix_center_from_data(X, y) -> tuple:
    """The default centre of the fixed-centre families: the training input
    with the highest observed value (`gplite_meanfun.m:334-341`), as a
    hashable tuple for `GPConfig.fix_center`."""
    X = np.asarray(X, float)
    y = np.asarray(y, float).ravel()
    return tuple(float(v) for v in X[int(np.argmax(y))])


def _center(cfg: GPConfig, like: torch.Tensor) -> torch.Tensor:
    if len(cfg.fix_center) != cfg.D:
        raise ValueError(
            f"meanfun {cfg.meanfun} requires GPConfig.fix_center of length "
            f"D={cfg.D} (got {len(cfg.fix_center)}); compute it with "
            "gp.means.fix_center_from_data(X, y)")
    # one fill a coordinate on the device, not a copy from the host: the
    # acquisition's CMA-ES captures this inside a CUDA graph
    return torch.stack([like.new_full((), float(v)) for v in cfg.fix_center])


def int_mean_basis(cfg: GPConfig, X: torch.Tensor) -> torch.Tensor:
    """Basis h(x) of the integrated Bayesian-linear mean at rows of X:
    (N, Nb) (cf. `gplite_intmeanfun.m`, which builds the transpose).
    [1 | x_1..x_D | x_1^2..x_D^2 | x_i x_j (i<j)], cut at `cfg.intmean`."""
    if cfg.intmean == INTMEAN_NONE:
        return X.new_zeros(X.shape[0], 0)
    cols = [X.new_ones(X.shape[0], 1)]
    if cfg.intmean >= INTMEAN_LINEAR:
        cols.append(X)
    if cfg.intmean >= INTMEAN_QUAD:
        cols.append(X * X)
    if cfg.intmean >= INTMEAN_FULLQUAD:
        iu, ju = torch.triu_indices(cfg.D, cfg.D, 1, device=X.device)
        cols.append(X.index_select(1, iu) * X.index_select(1, ju))
    return torch.cat(cols, dim=1)


def mean_function(cfg: GPConfig, hyp_mean: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """Mean at rows of X (M, D) for hyp_mean (B, nmean): (B, M)."""
    B = hyp_mean.shape[0]
    D = cfg.D
    mf = cfg.meanfun
    if mf == MEAN_ZERO:
        return X.new_zeros(B, X.shape[0])
    if mf == MEAN_CONST:
        return hyp_mean[:, :1].expand(B, X.shape[0])

    def sumz2(xm, log_omega):
        """sum_d ((x - xm) / omega)^2 for xm, log_omega (B, D) or (D,)."""
        xm = xm[:, None, :] if xm.dim() == 2 else xm
        return (((X[None] - xm)
                 / torch.exp(log_omega[:, None, :])) ** 2).sum(-1)

    m0 = hyp_mean[:, 0:1]
    if mf == MEAN_NEGQUAD:
        return m0 - 0.5 * sumz2(hyp_mean[:, 1:D + 1],
                                hyp_mean[:, D + 1:2 * D + 1])
    if mf == MEAN_SE:
        h = torch.exp(hyp_mean[:, 2 * D + 1:2 * D + 2])
        return m0 + h * torch.exp(-0.5 * sumz2(
            hyp_mean[:, 1:D + 1], hyp_mean[:, D + 1:2 * D + 1]))
    if mf == MEAN_NEGQUADSE:
        # negative quadratic plus an SE bump with its own location and
        # scale; the bump's height is a raw hyperparameter and may be
        # negative, unlike MEAN_SE (`gplite_meanfun.m:456-480`)
        h_se = hyp_mean[:, 4 * D + 1:4 * D + 2]
        return (m0 - 0.5 * sumz2(hyp_mean[:, 1:D + 1],
                                 hyp_mean[:, D + 1:2 * D + 1])
                + h_se * torch.exp(-0.5 * sumz2(
                    hyp_mean[:, 2 * D + 1:3 * D + 1],
                    hyp_mean[:, 3 * D + 1:4 * D + 1])))
    if mf == MEAN_NEGQUADONLY:
        return -0.5 * sumz2(X.new_zeros(D), hyp_mean[:, :D])
    if mf == MEAN_NEGQUADLINONLY:
        return -0.5 * sumz2(hyp_mean[:, :D], hyp_mean[:, D:2 * D])
    if mf == MEAN_NEGQUADFIXISO:
        # fixed centre, one isotropic scale (`gplite_meanfun.m:485-495`)
        return m0 - 0.5 * sumz2(_center(cfg, X),
                                hyp_mean[:, 1:2].expand(B, D))
    if mf == MEAN_NEGQUADFIX:
        # fixed centre, a scale per dimension (`gplite_meanfun.m:496-506`)
        return m0 - 0.5 * sumz2(_center(cfg, X), hyp_mean[:, 1:D + 1])
    if mf == MEAN_NEGQUADSEFIX:
        # fixed-centre quadratic plus an SE bump at the same centre with
        # omega_se = alpha omega and h_se > 0 (`gplite_meanfun.m:507-526`):
        # m = (m0 - h_se) - 1/2 sum z2 + h_se exp(-sum z2 / (2 alpha^2))
        alpha = torch.exp(hyp_mean[:, D + 1:D + 2])
        h_se = torch.exp(hyp_mean[:, D + 2:D + 3])
        s = sumz2(_center(cfg, X), hyp_mean[:, 1:D + 1])
        return (m0 - h_se) - 0.5 * s + h_se * torch.exp(-0.5 * s / alpha ** 2)
    if mf == MEAN_NEGQUADFIXONLY:
        # fixed centre, no offset (`gplite_meanfun.m:536-544`)
        return -0.5 * sumz2(_center(cfg, X), hyp_mean[:, :D])
    if mf == MEAN_NEGQUADMIX:
        # an inner quadratic (scaled by 1/beta near the centre) and an outer
        # one, blended by a Gaussian window of radius rho
        # (`gplite_meanfun.m:552-572`, the sgn = -1 branch):
        #   q = sum ((x-xm)/omega)^2,  a = exp(-q/(2 rho^2))
        #   m = m0 + hm - q/(2 beta^2) - a (hm + (1 - 1/beta^2) q/2)
        hm = hyp_mean[:, 2 * D + 1:2 * D + 2]
        rho2 = torch.exp(2.0 * hyp_mean[:, 2 * D + 2:2 * D + 3])
        beta2 = torch.exp(2.0 * hyp_mean[:, 2 * D + 3:2 * D + 4])
        s = sumz2(hyp_mean[:, 1:D + 1], hyp_mean[:, D + 1:2 * D + 1])
        kkm = torch.exp(-0.5 * s / rho2) * (
            hm + 0.5 * (1.0 - 1.0 / beta2) * s)
        return m0 + hm - (0.5 / beta2) * s - kkm
    raise ValueError(f"unsupported meanfun {mf}")


def mean_info(cfg: GPConfig, X: np.ndarray, y: np.ndarray):
    """Bounds / plausible box / starting point of the mean hyperparameters
    (`gplite_meanfun.m:136-331`), computed on the host once per GP fit, as
    a rule from the HPD part of the training data. Returns a dict of
    (nmean,) arrays."""
    D = cfg.D
    nm = cfg.nmean
    ToL, Big = 1e-6, np.exp(3.0)
    lb = np.full(nm, -np.inf)
    ub = np.full(nm, np.inf)
    plb = np.full(nm, -np.inf)
    pub = np.full(nm, np.inf)
    x0 = np.full(nm, np.nan)

    if nm == 0:
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)

    if y.size <= 1:
        y = np.array([0.0, 1.0])
    w = np.maximum(X.max(axis=0) - X.min(axis=0), 1e-10)
    h = max(y.max() - y.min(), 1e-10)

    def _omega_block(sl):
        lb[sl] = np.log(w) + np.log(ToL)
        ub[sl] = np.log(w) + np.log(Big)
        plb[sl] = np.log(w) + 0.5 * np.log(ToL)
        pub[sl] = np.log(w)
        x0[sl] = np.log(np.maximum(X.std(axis=0, ddof=1), 1e-10))

    def _xm_block(sl):
        lb[sl] = X.min(axis=0) - 0.5 * w
        ub[sl] = X.max(axis=0) + 0.5 * w
        plb[sl] = X.min(axis=0)
        pub[sl] = X.max(axis=0)
        x0[sl] = np.median(X, axis=0)

    if cfg.meanfun in (MEAN_NEGQUADONLY, MEAN_NEGQUADFIXONLY):
        _omega_block(slice(0, D))             # omega only, no offset
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
    if cfg.meanfun == MEAN_NEGQUADLINONLY:    # xm + omega, no offset
        _xm_block(slice(0, D))
        _omega_block(slice(D, 2 * D))
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)

    # m0
    lb[0] = y.min() - 0.5 * h
    ub[0] = y.max() + 0.5 * h
    plb[0] = np.quantile(y, 0.1)
    pub[0] = np.quantile(y, 0.9)
    x0[0] = np.median(y)

    if cfg.meanfun in (MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                       MEAN_NEGQUADMIX):
        # m0 bounds shared with MEAN_NEGQUAD (`gplite_meanfun.m:189-194`,
        # cases {4,10,12,22}).
        lb[0] = y.min()
        ub[0] = y.max() + h
        plb[0] = np.median(y)
        pub[0] = y.max()
        x0[0] = np.quantile(y, 0.9)
        if cfg.meanfun == MEAN_NEGQUADFIXISO:
            # Single isotropic log-omega (`gplite_meanfun.m:265-271`).
            lw = np.log(w)
            lb[1] = lw.min() + np.log(ToL)
            ub[1] = lw.max() + np.log(Big)
            plb[1] = lw.min() + 0.5 * np.log(ToL)
            pub[1] = lw.max()
            x0[1] = float(np.mean(np.log(
                np.maximum(X.std(axis=0, ddof=1), 1e-10))))
        elif cfg.meanfun == MEAN_NEGQUADFIX:
            _omega_block(slice(1, D + 1))     # (:273-279)
        else:  # MEAN_NEGQUADMIX (:313-331)
            _xm_block(slice(1, D + 1))
            _omega_block(slice(D + 1, 2 * D + 1))
            lb[2 * D + 1], ub[2 * D + 1] = -3 * h, 3 * h        # hm
            plb[2 * D + 1], pub[2 * D + 1] = -h, h
            x0[2 * D + 1] = 0.0
            for j in (2 * D + 2, 2 * D + 3):  # log rho, log beta
                lb[j], ub[j] = np.log(1e-3), np.log(1e3)
                plb[j], pub[j] = np.log(0.1), np.log(10.0)
                x0[j] = 0.0
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)

    if cfg.meanfun == MEAN_NEGQUADSEFIX:
        # m0 (`gplite_meanfun.m:226-231`, case {14,15}) + per-dim omega +
        # the SE rescale alpha_se and height h_se (:281-291).
        lb[0], ub[0] = y.min() - h, y.max() + h
        plb[0], pub[0] = y.min(), y.max()
        x0[0] = np.median(y)
        _omega_block(slice(1, D + 1))
        lb[D + 1], ub[D + 1] = np.log(0.01), np.log(10.0)   # alpha_se
        plb[D + 1], pub[D + 1] = np.log(0.1), np.log(1.0)
        x0[D + 1] = np.log(0.5)
        lb[D + 2], ub[D + 2] = np.log(1e-3), np.log(1e4)    # h_se
        plb[D + 2], pub[D + 2] = np.log(0.1), np.log(100.0)
        x0[D + 2] = 0.0
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)

    if cfg.meanfun in (MEAN_NEGQUAD, MEAN_NEGQUADSE):
        lb[0] = y.min()
        ub[0] = y.max() + h
        plb[0] = np.median(y)
        pub[0] = y.max()
        x0[0] = np.quantile(y, 0.9)
    elif cfg.meanfun == MEAN_SE:
        lb[0] = y.min() - h
        ub[0] = y.max()
        plb[0] = y.min()
        pub[0] = np.median(y)
        x0[0] = np.quantile(y, 0.1)
    if cfg.meanfun in (MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE):
        _xm_block(slice(1, D + 1))
        _omega_block(slice(D + 1, 2 * D + 1))
    if cfg.meanfun == MEAN_SE:
        lb[2 * D + 1] = np.log(h) + np.log(ToL)
        ub[2 * D + 1] = np.log(h) + np.log(Big)
        plb[2 * D + 1] = np.log(h) + 0.5 * np.log(ToL)
        pub[2 * D + 1] = np.log(h)
        x0[2 * D + 1] = np.log(max(np.std(y, ddof=1), 1e-10))
    elif cfg.meanfun == MEAN_NEGQUADSE:
        # the SE bump's location, scale and raw height
        # (`gplite_meanfun.m:244-263`)
        _xm_block(slice(2 * D + 1, 3 * D + 1))
        x0[2 * D + 1:3 * D + 1] = X[np.argmax(y)]
        _omega_block(slice(3 * D + 1, 4 * D + 1))
        lb[4 * D + 1] = -Big * h
        ub[4 * D + 1] = Big * h
        plb[4 * D + 1] = -h
        pub[4 * D + 1] = h
        x0[4 * D + 1] = min(np.std(y, ddof=1), h)

    nan = np.isnan(x0)
    x0[nan] = 0.5 * (plb[nan] + pub[nan])
    return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
