"""GP hyperparameter training (cf. `vbmc_tpu/gp/fit.py`,
`misc/gptrain_vbmc.m`, `gplite/gplite_train.m`): a space-filling design
evaluated as one batch of marginal likelihoods, MAP by batched bounded
L-BFGS over starts, then hyperparameter samples from parallel slice chains
(nhyp <= 20) or the complementary-halves ensemble (nhyp > 20)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import (
    GPConfig, MEAN_NEGQUAD, MEAN_CONST, MEAN_SE, MEAN_NEGQUADFIXISO,
    MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX, MEAN_NEGQUADMIX)
from vbmc_tpu_torch.gp import core
from vbmc_tpu_torch.gp.gp import HypPrior, build_gp, pad_training_data
from vbmc_tpu_torch.gp.means import mean_info
from vbmc_tpu_torch.gp.noise import noise_info
from vbmc_tpu_torch.gp.outwarp import outwarp_info
from vbmc_tpu_torch.optim import minimize_lbfgs_bounded
from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_final
from vbmc_tpu_torch.samplers.slice import slice_sample_chains
from vbmc_tpu_torch.tracing import span
from vbmc_tpu_torch.utils.math import bucket_ns, bucket_pow2


@dataclasses.dataclass
class TrainOptions:
    ns_samples: int = 0          # GP hyperparameter samples (0 => MAP only)
    ninit: int = 1024            # space-filling design size (0 => skip)
    nopts: int = 2               # number of MAP optimisation restarts
    thin: int = 5
    burnin: Optional[int] = None  # default: thin * ns_samples
    n_chains: int = 4
    widths: Optional[np.ndarray] = None   # sampler widths (from hyp cov)
    # True when the widths carry a rindex inflation beyond the base
    # multiplier (unstable run): only then do they bypass the design cap.
    widths_escalated: bool = False
    lbfgs_iters: int = 80
    hpd_frac: float = 0.8
    tol_gp_noise: float = np.sqrt(1e-5)
    noise_size: Optional[float] = None
    length_prior_mean_mult: Optional[float] = None  # default sqrt(D/6)
    length_prior_std: float = 0.5 * np.log(1e3)
    quadratic_mean_bound: bool = True
    tol_sd: float = 0.1
    uncertainty_level: int = 0   # 0 exact; 1 infer noise; 2 provided noise
    upper_length_factor: float = 0.0
    # Output-warp ("fitness shaping") threshold state
    # (`gptrain_vbmc.m:246-270`): how far below ymax the warp may engage,
    # and the scale of the half-Cauchy prior on the threshold.
    outwarp_delta: Optional[float] = None
    outwarp_thresh_base: Optional[float] = None


def get_hpd(X: np.ndarray, y: np.ndarray, frac: float = 0.8):
    """Top-``frac`` of points by log density (cf. `misc/gethpd_vbmc.m`)."""
    n_hpd = max(int(np.ceil(frac * X.shape[0])), 1)
    sel = np.argsort(y)[::-1][:n_hpd]
    return X[sel], y[sel]


def assemble_hyp_prior(cfg: GPConfig, X: np.ndarray, y: np.ndarray,
                       plb_tr: np.ndarray, pub_tr: np.ndarray,
                       opts: TrainOptions, *, device="cpu",
                       dtype=torch.float64):
    """Bounds, priors and starting point of all hyperparameters
    (`gptrain_vbmc.m:109-311`). Returns (HypPrior, x0 (nhyp,))."""
    D = cfg.D
    X_hpd, y_hpd = get_hpd(X, y, opts.hpd_frac)
    width = np.maximum(X_hpd.max(axis=0) - X_hpd.min(axis=0), 1e-10)
    yh = y_hpd if y_hpd.size > 1 else np.array([0.0, 1.0])
    height = max(yh.max() - yh.min(), 1e-10)
    ToL = 1e-6

    nh = cfg.nhyp
    lb = np.full(nh, -np.inf)
    ub = np.full(nh, np.inf)
    plb = np.full(nh, -np.inf)
    pub = np.full(nh, np.inf)
    x0 = np.full(nh, np.nan)
    mu = np.full(nh, np.nan)
    sigma = np.full(nh, np.nan)
    df = np.full(nh, 3.0)

    # Covariance: log ell, log sf. An iso kernel has one length scale,
    # whose statistics are the means over the dimensions
    # (`gplite_covfun.m:116-123`); an ard kernel has them per dimension.
    ne = cfg.n_ell

    def per_ell(v):
        return v if ne == D else np.mean(v)

    lw = per_ell(np.log(width))
    lb[:ne] = lw + np.log(ToL)
    ub[:ne] = lw + np.log(10.0)
    plb[:ne] = lw + 0.5 * np.log(ToL)
    pub[:ne] = lw
    x0[:ne] = per_ell(np.log(np.maximum(X_hpd.std(axis=0, ddof=1), 1e-10)))
    i_sf = cfg.idx_log_sf
    lb[i_sf] = np.log(height) + np.log(ToL)
    ub[i_sf] = np.log(height * 10)
    plb[i_sf] = np.log(height) + 0.5 * np.log(ToL)
    pub[i_sf] = np.log(height)
    x0[i_sf] = np.log(max(np.std(yh, ddof=1), 1e-10))
    if opts.upper_length_factor > 0:
        ub[:ne] = per_ell(np.log(opts.upper_length_factor
                                 * (pub_tr - plb_tr)))

    # Fixed length-scale prior from the plausible box (gptrain:288-289).
    mult = opts.length_prior_mean_mult
    if mult is None:
        mult = np.sqrt(D / 6.0)
    mu[:ne] = per_ell(np.log(mult * (pub_tr - plb_tr)))
    sigma[:ne] = opts.length_prior_std

    # Noise (gptrain:143-165, 180): the constant term, then the user-noise
    # multiplier.
    ninfo = noise_info(cfg, yh)
    sl = cfg.sl_noise
    lb[sl], ub[sl] = ninfo["lb"], ninfo["ub"]
    plb[sl], pub[sl] = ninfo["plb"], ninfo["pub"]
    x0[sl] = ninfo["x0"]
    min_noise = opts.tol_gp_noise
    i_n = cfg.ncov
    if cfg.const_noise == 1:
        if opts.uncertainty_level == 0:
            noisesize = max(opts.noise_size or 0.0, min_noise)
            noisestd = 0.5
        elif opts.uncertainty_level == 1:
            noisesize = min_noise
            noisestd = np.log(10.0)
        else:
            noisesize = min_noise
            noisestd = 0.5
        x0[i_n] = np.log(noisesize)
        mu[i_n] = np.log(noisesize)
        sigma[i_n] = noisestd
        lb[i_n] = np.log(min_noise)
        i_n += 1
    if cfg.user_noise == 2:
        noisemult = max(opts.noise_size or 0.0, min_noise) \
            if opts.noise_size else 1.0
        noisemultstd = np.log(10.0) / 2 if opts.noise_size else np.log(10.0)
        x0[i_n] = np.log(noisemult)
        mu[i_n] = np.log(noisemult)
        sigma[i_n] = noisemultstd

    # Mean (gptrain:182-203).
    minfo = mean_info(cfg, X_hpd, yh)
    sl = cfg.sl_mean
    lb[sl], ub[sl] = minfo["lb"], minfo["ub"]
    plb[sl], pub[sl] = minfo["plb"], minfo["pub"]
    x0[sl] = minfo["x0"]
    i_m = cfg.ncov + cfg.nnoise
    if cfg.meanfun in (MEAN_NEGQUAD, MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                       MEAN_NEGQUADSEFIX, MEAN_NEGQUADMIX) \
            and opts.quadratic_mean_bound:
        # every quadratic family that the reference trains, meanfuns
        # {4,10,12,14,22} (`gptrain_vbmc.m:186-203`)
        deltay = max(opts.tol_sd, min(D, yh.max() - yh.min()))
        ub[i_m] = yh.max() + deltay
    elif cfg.meanfun == MEAN_CONST:
        ub[i_m] = yh.min()
    elif cfg.meanfun == MEAN_SE:
        x0[i_m] = y.min()
        ub[i_m] = yh.min()
    if cfg.meanfun == MEAN_NEGQUADSEFIX:
        # tighter bounds on the SE rescale and Student-t priors on alpha_se
        # and h_se (`gptrain_vbmc.m:190-193,291-296`); without them h_se
        # roams up to 1e4
        i_a, i_h = i_m + D + 1, i_m + D + 2
        ub[i_a] = np.log(1.0)
        lb[i_a] = np.log(1e-3)
        mu[i_a], sigma[i_a] = np.log(0.1), np.log(10.0)
        mu[i_h], sigma[i_h] = np.log(0.1), np.log(100.0)
    elif cfg.meanfun == MEAN_NEGQUADMIX:
        # t priors on the mixture's shape hm, rho, beta
        # (`gptrain_vbmc.m:221-230`), with the range of all of y
        y_all = np.asarray(y, float)
        i_hm = i_m + 2 * D + 1
        mu[i_hm] = 0.0
        sigma[i_hm] = max(0.5 * float(y_all.max() - y_all.min()), 1e-3)
        mu[i_hm + 1], sigma[i_hm + 1] = 0.0, 1.0     # log rho
        mu[i_hm + 2], sigma[i_hm + 2] = 0.0, 1.0     # log beta

    # Output warp (gptrain:246-270).
    if cfg.noutwarp > 0:
        oinfo = outwarp_info(cfg.outwarp, yh)
        sl = cfg.sl_outwarp
        lb[sl], ub[sl] = oinfo["lb"], oinfo["ub"]
        plb[sl], pub[sl] = oinfo["plb"], oinfo["pub"]
        x0[sl] = oinfo["x0"]
        i_w = cfg.ncov + cfg.nnoise + cfg.nmean
        delta = opts.outwarp_delta if opts.outwarp_delta is not None \
            else 10.0 * D
        base = opts.outwarp_thresh_base \
            if opts.outwarp_thresh_base is not None else 10.0 * D
        y_all = np.asarray(y, float)
        # the threshold engages at most delta below ymax, under a
        # half-Cauchy prior
        ub[i_w] = y_all.max() - delta
        lb[i_w] = min(y_all.min(), y_all.max() - 2 * delta)
        plb[i_w] = min(plb[i_w], ub[i_w])
        pub[i_w] = min(pub[i_w], ub[i_w])
        mu[i_w] = y_all.max() - delta
        sigma[i_w] = base
        df[i_w] = 1.0
        if cfg.outwarp in (1, 2):          # negpow / negpowc1: [y0, log k]
            ub[i_w + 1] = np.log(2.0)
            mu[i_w + 1] = 0.0
            sigma[i_w + 1] = np.log(2.0)
        else:                              # negscaledpow: [y0, log a, log k]
            mu[i_w + 1] = 0.0
            sigma[i_w + 1] = np.log(2.0)
            ub[i_w + 2] = 0.0
            mu[i_w + 2] = 0.0
            sigma[i_w + 2] = np.log(2.0)
        x0[sl] = np.minimum(x0[sl], ub[sl] - 1e-6)

    nanmask = np.isnan(x0)
    x0[nanmask] = 0.5 * (plb[nanmask] + pub[nanmask])

    def t(v):
        return torch.as_tensor(v, device=device, dtype=dtype)

    return HypPrior(mu=t(mu), sigma=t(sigma), df=t(df), lb=t(lb), ub=t(ub),
                    plb=t(plb), pub=t(pub)), x0


def hyp_sampler_for(cfg: GPConfig, sb: int) -> str:
    """The reference's sampler policy: the batched ensemble when nhyp > 20
    (D >= 6 with the negquad mean) and the buffer holds >= 8 walkers,
    coordinate slice chains otherwise."""
    return "ensemble" if (cfg.nhyp > 20 and sb >= 8) else "slice"


def sampler_widths(prior: HypPrior, opts: TrainOptions,
                   default: np.ndarray) -> np.ndarray:
    """The slice sampler's step widths: ``default`` (the design's spread or
    the plausible box), capped by the running hyperparameter-covariance
    widths ``opts.widths`` when they are given; when those carry a rindex
    inflation (``opts.widths_escalated``) the cap widens to the hard range
    where that is finite."""
    if opts.widths is None or np.asarray(opts.widths).size != default.size:
        return default
    cap = default
    if opts.widths_escalated:
        lb, ub = prior.host_box[:2]
        cap = np.maximum(np.where(np.isfinite(ub - lb), ub - lb, np.inf),
                         default)
    return np.minimum(np.asarray(opts.widths, float), cap)


def _objective(cfg, prior, X, y, s2, mask):
    def obj(h):
        nll = (core.neg_log_marginal_likelihood(cfg, h, X, y, s2, mask)
               - core.hyperprior_logpdf(prior, h))
        return torch.where(torch.isfinite(nll), nll, 1e12)
    return obj


def map_sample_assemble_core(cfg: GPConfig, gen: torch.Generator, x0s_map,
                             eps_or_cs, widths, prior: HypPrior, X, y, s2,
                             mask, ns: int, burn: int, thin: int,
                             n_keep_max: int, warm: bool, maxiter: int,
                             sampler: str = "slice"):
    """MAP polish -> best start -> chain starts (jittered around the MAP by
    ``eps_or_cs``, or with ``warm`` the rows of ``eps_or_cs`` themselves:
    the previous posterior samples of a quick update) -> sampler -> padded
    sample buffer, with the log-posterior gate that collapses samples > 50
    nats below the best onto the MAP.
    Returns (buf (sb, nhyp), hyp_mask (sb,), hyp_map (nhyp,),
    gated samples (sb, nhyp))."""
    obj = _objective(cfg, prior, X, y, s2, mask)
    with span("map"):
        if maxiter > 0:
            hyp_opt, f_opt = minimize_lbfgs_bounded(obj, x0s_map, prior.lb,
                                                    prior.ub, maxiter=maxiter)
        else:
            with torch.no_grad():
                hyp_opt, f_opt = x0s_map, obj(x0s_map)
    best = torch.argmin(torch.where(torch.isfinite(f_opt), f_opt, torch.inf))
    hyp_map = torch.minimum(torch.maximum(hyp_opt[best], prior.lb + 1e-12),
                            prior.ub - 1e-12)

    # Chain starts scatter by the sampling widths (mode discovery on
    # unstable runs); stranded chains are caught by the gate below.
    x0s_chain = eps_or_cs if warm else \
        hyp_map[None, :] + eps_or_cs * (0.1 * widths)[None, :]
    x0s_chain = torch.minimum(torch.maximum(x0s_chain, prior.lb + 1e-10),
                              prior.ub - 1e-10)
    x0s_chain[0] = hyp_map

    def logpdf(h):
        lp = core.gp_log_posterior(cfg, prior, h, X, y, s2, mask)
        in_bounds = ((h >= prior.lb) & (h <= prior.ub)).all(-1)
        return torch.where(in_bounds & torch.isfinite(lp), lp, -torch.inf)

    with span("sample"), torch.no_grad():
        if sampler == "ensemble":
            flat, lp_flat = ensemble_slice_final(gen, logpdf, x0s_chain,
                                                 prior.lb, prior.ub,
                                                 burn + thin)
        else:
            C = x0s_chain.shape[0]
            n_keep = min(ns // C + (ns % C > 0), n_keep_max)
            samples, logps = slice_sample_chains(gen, logpdf, x0s_chain,
                                                 widths, prior.lb, prior.ub,
                                                 n_keep, burn, thin,
                                                 n_keep_max)
            # Interleave chains: sample i of chain c -> position i*C + c.
            flat = samples.transpose(0, 1).reshape(-1, samples.shape[-1])
            lp_flat = logps.transpose(0, 1).reshape(-1)
    sb = flat.shape[0]
    sel = torch.arange(sb, device=flat.device) < ns
    lp_best = torch.where(sel, lp_flat, -torch.inf).max()
    good = (lp_flat > lp_best - 50.0)[:, None]
    buf = torch.where(sel[:, None] & good, flat, hyp_map[None, :])
    return buf, sel, hyp_map, torch.where(good, flat, hyp_map[None, :])


def train_gp(gen: torch.Generator, cfg: GPConfig, X: np.ndarray,
             y: np.ndarray, s2: Optional[np.ndarray], plb_tr, pub_tr,
             opts: TrainOptions, hyp0: Optional[np.ndarray] = None,
             host_seed: Optional[int] = None, *, device="cuda",
             dtype=torch.float64):
    """Fit the GP surrogate on host training data (unpadded; ``s2`` the
    user noise variance or None); returns (GP, info dict). ``host_seed``
    seeds the host draws (design points, chain-start jitter). The GP
    lives on the card unless the caller names another ``device``, as in
    `vbmc`; without a card the default raises."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=device,
                               dtype=dtype)

    Xp, yp, s2p, mask = pad_training_data(X, y, s2, device=device,
                                          dtype=dtype)
    prior, x0_default = assemble_hyp_prior(cfg, np.asarray(X), np.asarray(y),
                                           np.asarray(plb_tr),
                                           np.asarray(pub_tr), opts,
                                           device=device, dtype=dtype)
    nh = cfg.nhyp
    if host_seed is None:
        host_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                      device=gen.device).item())
    hrng = np.random.default_rng(host_seed)

    starts = [np.asarray(x0_default)[None, :]]
    if hyp0 is not None and hyp0.size and hyp0.shape[-1] == nh:
        starts.append(np.asarray(hyp0, float).reshape(-1, nh))
    starts = np.unique(np.concatenate(starts, axis=0), axis=0)
    lb_np, ub_np, plb_np, pub_np = prior.host_box
    starts = np.clip(starts, lb_np + 1e-12, ub_np - 1e-12)
    obj = _objective(cfg, prior, Xp, yp, s2p, mask)

    widths_default = np.maximum(pub_np - plb_np, 1e-3)
    if opts.ninit > 0:
        # Fixed-size chunks of 256 design points, as in the reference.
        CHUNK = 256
        n_design = CHUNK * max(1, -(-int(opts.ninit) // CHUNK))
        u = hrng.random((n_design, nh))
        design = plb_np + u * (pub_np - plb_np)
        n_s = min(starts.shape[0], n_design // 2)
        design[:n_s] = starts[:n_s]
        with span("design"), torch.no_grad():
            nll = torch.cat([obj(t(design[i:i + CHUNK]))
                             for i in range(0, n_design, CHUNK)])
            nll = nll.cpu().double().numpy()
        nll = np.where(np.isfinite(nll), nll, np.inf)
        order = np.argsort(nll)
        x0s = design[order[:max(opts.nopts, 1)]]
        top = design[order[:max(3 * opts.nopts, 10)]]
        widths_default = np.maximum(top.std(axis=0, ddof=1), 1e-3)
        if opts.nopts > 0:
            reps = int(np.ceil(opts.nopts / x0s.shape[0]))
            x0s_map = np.tile(x0s, (reps, 1))[:opts.nopts]
            map_iters = opts.lbfgs_iters
        else:
            x0s_map = x0s[:1]
            map_iters = 0
    else:
        # No design: every start goes to the MAP batch, padded to 8 rows.
        n_pad = bucket_pow2(starts.shape[0])
        x0s_map = np.concatenate(
            [starts, np.tile(starts[-1:], (n_pad - starts.shape[0], 1))])
        map_iters = opts.lbfgs_iters if opts.nopts > 0 else 0

    ns = int(opts.ns_samples)
    if ns > 0:
        sb = bucket_ns(ns)
        C = min(opts.n_chains, sb)
        while sb % C != 0:
            C -= 1
        keep_max = sb // C
        widths = sampler_widths(prior, opts, widths_default)
        burn = opts.burnin if opts.burnin is not None else opts.thin * ns
        sampler = hyp_sampler_for(cfg, sb)
        n_rows = sb if sampler == "ensemble" else C
        eps = hrng.standard_normal((n_rows, nh))
        buf, hyp_mask, hyp_map, flat = map_sample_assemble_core(
            cfg, gen, t(x0s_map), t(eps), t(widths), prior, Xp, yp, s2p,
            mask, ns, max(burn // C, opts.thin), opts.thin, keep_max, False,
            map_iters, sampler=sampler)
        with span("build"):
            gp = build_gp(cfg, Xp, yp, s2p, mask, buf, hyp_mask)
            # the copies wait for the factorisations queued above
            hyp_map = hyp_map.cpu().double().numpy()
            hyp_full = flat.cpu().double().numpy()
    else:
        if map_iters > 0:
            with span("map"):
                hyp_opt, f_opt = minimize_lbfgs_bounded(
                    obj, t(x0s_map), prior.lb, prior.ub, maxiter=map_iters)
                f_opt = f_opt.cpu().double().numpy()
                best = int(np.nanargmin(np.where(np.isfinite(f_opt), f_opt,
                                                 np.inf)))
                hyp_map = hyp_opt[best].cpu().double().numpy()
        else:
            hyp_map = x0s_map[0]
        hyp_map = np.clip(hyp_map, lb_np + 1e-12, ub_np - 1e-12)
        sb = bucket_ns(1)
        hyp_full = hyp_map[None, :]
        with span("build"):
            gp = build_gp(cfg, Xp, yp, s2p, mask,
                          t(np.tile(hyp_map[None, :], (sb, 1))),
                          torch.as_tensor(np.arange(sb) < 1, device=device))
    info = dict(hyp_map=hyp_map, hyp_full=hyp_full, prior=prior,
                ns_samples=ns, widths_default=widths_default)
    return gp, info
