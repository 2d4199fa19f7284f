"""Active sampling (cf. `vbmc_tpu/active_sample.py`,
`private/activesample_vbmc.m`, `misc/initdesign_vbmc.m`): initial design,
candidate generation, the acquisition sweep (a CUDA kernel on the card:
prospective for noiseless targets, VIQR / IMIQR with an importance-sampling
set for noisy ones), CMA-ES refinement, target evaluation, and the GP
refresh or, on noisy targets, the per-point full update."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP, build_gp
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.vp import VariationalPosterior, vp_rnd, vp_moments
from vbmc_tpu_torch.acquisitions import (ACQ_INFO, evaluate_acquisition,
                                         sweep_acquisition, AcqState)
from vbmc_tpu_torch.active_is import (build_is_state_core,
                                      evaluate_is_acquisition,
                                      sweep_is_acquisition)
from vbmc_tpu_torch.samplers.cmaes import cmaes_minimize
from vbmc_tpu_torch.vpoptim import fractional_ess
from vbmc_tpu_torch.utils.math import bucket_n, pad_to, to_np


@dataclasses.dataclass
class SearchBounds:
    lb: np.ndarray          # current search box (transformed space)
    ub: np.ndarray
    lb_hard: np.ndarray     # transformed hard bounds
    ub_hard: np.ndarray

    @staticmethod
    def init(plb, pub, lb_hard, ub_hard, mult: float):
        prange = pub - plb
        return SearchBounds(lb=np.maximum(plb - prange * mult, lb_hard),
                            ub=np.minimum(pub + prange * mult, ub_hard),
                            lb_hard=lb_hard, ub_hard=ub_hard)

    def expand(self, xnew: np.ndarray) -> bool:
        """Expand the box when a new point lands near its edges
        (`activesample_vbmc.m:492-508`). True when the box moved."""
        delta = 0.05 * (self.ub - self.lb)
        near_lo = np.abs(xnew - self.lb) < delta
        near_hi = np.abs(xnew - self.ub) < delta
        if not (near_lo.any() or near_hi.any()):
            return False
        old_lb, old_ub = self.lb.copy(), self.ub.copy()
        self.lb[near_lo] = np.maximum(self.lb_hard[near_lo],
                                      (self.lb - delta)[near_lo])
        self.ub[near_hi] = np.minimum(self.ub_hard[near_hi],
                                      (self.ub + delta)[near_hi])
        return bool(np.any(self.lb != old_lb) or np.any(self.ub != old_ub))


def initial_design(gen: torch.Generator, logger: FunctionLogger,
                   n_evals: int, plb, pub,
                   x0_cache: Optional[np.ndarray] = None,
                   init_design: str = "plausible"):
    """First batch of evaluations: the starting points plus uniform draws
    in the plausible box (`initdesign_vbmc.m:10-28`). A starting cache
    larger than ``n_evals`` (k-means thinning) is not ported."""
    D = plb.shape[0]
    pts = []
    if x0_cache is not None and len(x0_cache):
        Xc = np.asarray(x0_cache, float).reshape(-1, D)
        if Xc.shape[0] > n_evals:
            raise NotImplementedError(
                "a starting cache larger than fun_eval_start (k-means "
                "thinning) is ROADMAP Queue 1, slice 4")
        pts.append(Xc)
    n_rand = max(n_evals - sum(p.shape[0] for p in pts), 0)
    if n_rand > 0:
        u = torch.rand((n_rand, D), generator=gen, device=gen.device,
                       dtype=torch.float64).cpu().numpy()
        if init_design == "plausible":
            pts.append(plb + u * (pub - plb))
        elif init_design == "narrow":
            xstart = pts[0][0] if pts and len(pts[0]) else 0.5 * (plb + pub)
            Xr = xstart[None, :] + (u - 0.5) * 0.1 * (pub - plb)[None, :]
            pts.append(np.clip(Xr, plb, pub))
        else:
            raise ValueError(f"Unknown initial design '{init_design}'.")
    for x in np.concatenate(pts, axis=0)[:n_evals]:
        logger.evaluate(x)


def _train_box(gp: GP, sb_lb, sb_ub):
    """Box around the (masked) training inputs, clipped to finite search
    bounds (`activesample_vbmc.m:600-612`)."""
    big = torch.finfo(gp.X.dtype).max
    m = gp.mask[:, None]
    Xmin = torch.where(m, gp.X, big).amin(0)
    Xmax = torch.where(m, gp.X, -big).amax(0)
    diam = Xmax - Xmin
    box_lb = torch.where(torch.isfinite(sb_lb),
                         torch.maximum(Xmin - 0.5 * diam, sb_lb),
                         Xmin - 0.5 * diam)
    box_ub = torch.where(torch.isfinite(sb_ub),
                         torch.minimum(Xmax + 0.5 * diam, sb_ub),
                         Xmax + 0.5 * diam)
    return box_lb, box_ub


def _gen_candidates(gen, vp, gp, sb_lb, sb_ub, n_search: int, n_heavy: int,
                    n_mvn: int, n_box: int):
    """Search set (`activesample_vbmc.m:545-639`): heavy-tailed VP draws,
    moment-matched Gaussian draws, box-uniform draws and balanced VP draws,
    clipped to the search box. Returns (Xs (n_search, D), VP covariance)."""
    D = vp.D
    dt, dev = gp.X.dtype, gp.X.device
    mean_t, cov_t = vp_moments(vp, orig_flag=False)
    parts = []
    if n_heavy > 0:
        parts.append(vp_rnd(vp, gen, n_heavy, orig_flag=False, df=3.0))
    if n_mvn > 0:
        Lc = torch.linalg.cholesky(cov_t + 1e-12 * torch.eye(D, dtype=dt,
                                                             device=dev))
        eps = torch.randn((n_mvn, D), generator=gen, device=dev, dtype=dt)
        parts.append(mean_t[None, :] + eps @ Lc.T)
    if n_box > 0:
        box_lb, box_ub = _train_box(gp, sb_lb, sb_ub)
        u = torch.rand((n_box, D), generator=gen, device=dev, dtype=dt)
        parts.append(box_lb + u * (box_ub - box_lb))
    n_vp = n_search - sum(p.shape[0] for p in parts)
    if n_vp > 0:
        parts.append(vp_rnd(vp, gen, n_vp, orig_flag=False,
                            balance_flag=True))
    Xs = torch.cat(parts)[:n_search]
    return torch.minimum(torch.maximum(Xs, sb_lb), sb_ub), cov_t


def _argmin_and_refine(gen, Xs, acq, cov_t, sb_lb, sb_ub, f_batch,
                       max_evals: int, popsize: int):
    """Sweep winner, refined by CMA-ES started at it with the VP's
    per-dimension scales; the refined point is taken only if better."""
    acq_f = torch.where(torch.isfinite(acq), acq, torch.inf)
    best = torch.argmin(acq_f)
    x0, f0 = Xs[best], acq_f[best]
    insigma = torch.sqrt(torch.diagonal(cov_t).clamp_min(1e-12))
    res = cmaes_minimize(gen, f_batch, x0, insigma, torch.minimum(x0, sb_lb),
                         torch.maximum(x0, sb_ub), max_evals=max_evals,
                         popsize=popsize)
    return torch.where(res.f_best < f0, res.x_best, x0), f0


def _propose_point(cfg: GPConfig, name: str, gen, vp, gp, state: AcqState,
                   sb_lb, sb_ub, n_search: int, n_heavy: int, n_mvn: int,
                   n_box: int, max_evals: int, popsize: int):
    """One acquisition step: candidates -> sweep -> argmin -> CMA-ES."""
    Xs, cov_t = _gen_candidates(gen, vp, gp, sb_lb, sb_ub, n_search, n_heavy,
                                n_mvn, n_box)
    acq = sweep_acquisition(cfg, name, Xs, vp, gp, state)

    def f_batch(xs):
        return evaluate_acquisition(cfg, name, xs, vp, gp, state)

    return _argmin_and_refine(gen, Xs, acq, cov_t, sb_lb, sb_ub, f_batch,
                              max_evals, popsize)


def _propose_point_is(cfg: GPConfig, name: str, gen, vp, gp, state: AcqState,
                      sb_lb, sb_ub, n_search: int, n_heavy: int, n_mvn: int,
                      n_box: int, n_is_vp: int, n_is_box: int,
                      n_is_mcmc: int, mh_steps: int, fess_thresh: float,
                      max_evals: int, popsize: int):
    """One VIQR / IMIQR acquisition step: importance-sampling set ->
    candidates -> sweep -> argmin -> CMA-ES on the plain evaluation. The
    set is rebuilt for every point: the GP posterior changes as
    evaluations accrue (`activesample_vbmc.m:208-211`)."""
    ais = build_is_state_core(gen, cfg, name, vp, gp, n_is_vp, n_is_box,
                              n_is_mcmc, mh_steps=mh_steps,
                              fess_thresh=fess_thresh)
    Xs, cov_t = _gen_candidates(gen, vp, gp, sb_lb, sb_ub, n_search, n_heavy,
                                n_mvn, n_box)
    acq = sweep_is_acquisition(cfg, name, Xs, vp, gp, state, ais)

    def f_batch(xs):
        return evaluate_is_acquisition(cfg, name, xs, vp, gp, state, ais)

    return _argmin_and_refine(gen, Xs, acq, cov_t, sb_lb, sb_ub, f_batch,
                              max_evals, popsize)


def gp_reupdate(cfg: GPConfig, gp: GP, logger: FunctionLogger) -> GP:
    """Refresh the GP posterior on the current training data (with the
    logger's noise variances), keeping the hyperparameter samples
    (`misc/gpreupdate.m`)."""
    X, y, s2 = logger.training_data()
    n = X.shape[0]
    nb = bucket_n(n)
    dev, dt = gp.X.device, gp.X.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dt)

    return build_gp(cfg, t(pad_to(X, nb)), t(pad_to(y, nb)),
                    t(np.zeros(nb) if s2 is None else pad_to(s2, nb)),
                    torch.as_tensor(np.arange(nb) < n, device=dev), gp.hyp,
                    gp.hyp_mask)


def _geomean_length_scale(cfg: GPConfig, gp: GP) -> np.ndarray:
    m = to_np(gp.hyp_mask).astype(float)
    le = to_np(gp.hyp)[:, :cfg.D]
    return np.exp((le * m[:, None]).sum(0) / max(m.sum(), 1.0))


def _hard_bound_eps(logger: FunctionLogger, options):
    """Original-space epsilon box used to reject near-bound candidates."""
    h = logger.trinfo.host()
    lb, ub = h["lb_orig"], h["ub_orig"]
    both = np.isfinite(lb) & np.isfinite(ub)
    width = np.where(both, ub - lb, 0.0)
    return (np.where(both, lb + width * options.tol_bound_x, -np.inf),
            np.where(both, ub - width * options.tol_bound_x, np.inf))


def check_search_options(options):
    """The ported search is the default composition with CMA-ES refinement
    from the VP moments; anything else raises."""
    if (options.search_cache_frac != 0 or options.hpd_search_frac != 0
            or options.search_optimizer != "cmaes"
            or not options.search_cmaes_vp_init):
        raise NotImplementedError(
            "only the default search set with CMA-ES refinement from the VP "
            "moments is ported (search_cache_frac, hpd_search_frac, "
            "search_optimizer, search_cmaes_vp_init: ROADMAP Queue 1, "
            "slice 3)")
    if len(options.integer_vars):
        raise NotImplementedError("integer_vars is ROADMAP Queue 1, slice 3")
    if options.uncertainty_handling and options.max_repeated_observations > 0:
        raise NotImplementedError(
            "repeated observations of noisy targets "
            "(max_repeated_observations > 0) are ROADMAP Queue 1, slice 3")


def active_sample(gen: torch.Generator, cfg: GPConfig,
                  logger: FunctionLogger, n_points: int,
                  vp: VariationalPosterior, gp: GP, sb: SearchBounds,
                  options, *, acq_name: str, tol_gp_var: float,
                  full_update: bool = False, quick_updater=None,
                  fess_thresh: float = 1.0):
    """Acquire ``n_points`` new evaluations; returns (gp, vp), the GP
    refreshed on the enlarged training set.

    With ``full_update`` (noisy targets near the end of warm-up or on
    unstable runs, `activesample_vbmc.m:46-76, 429-473`) the
    ``quick_updater(gen, logger, gp, vp) -> (gp, vp, gls)`` re-trains the GP
    hyperparameters and re-fits the VP after each acquired point, gated on
    the fractional effective sample size when ``fess_thresh`` < 1;
    otherwise the GP keeps its hyperparameters."""
    check_search_options(options)
    dt, dev = gp.X.dtype, gp.X.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dt)

    lb_eps, ub_eps = _hard_bound_eps(logger, options)
    ns = options.ns_search
    common = dict(n_search=ns,
                  n_heavy=int(round(options.heavy_tail_search_frac * ns)),
                  n_mvn=int(round(options.mvn_search_frac * ns)),
                  n_box=int(round(options.box_search_frac * ns)),
                  max_evals=options.search_max_fun_evals,
                  popsize=options.search_cmaes_popsize)
    if ACQ_INFO[acq_name]["importance_sampling"]:
        propose = _propose_point_is
        common.update(
            n_is_vp=int(options.active_importance_sampling_vp_samples),
            n_is_box=int(options.active_importance_sampling_box_samples),
            n_is_mcmc=int(options.active_importance_sampling_mcmc_samples),
            mh_steps=int(options.active_importance_sampling_mh_steps),
            fess_thresh=float(options.active_importance_sampling_fess_thresh))
    else:
        propose = _propose_point
    sb_lb, sb_ub = t(sb.lb), t(sb.ub)
    gls = t(_geomean_length_scale(cfg, gp))
    for i in range(n_points):
        state = AcqState(ymax=t(logger.ymax), tol_var=t(tol_gp_var),
                         lb_eps_orig=t(lb_eps), ub_eps_orig=t(ub_eps),
                         regularize=True, gp_length_scale=gls)
        with torch.no_grad():
            x_new, _ = propose(cfg, acq_name, gen, vp, gp, state, sb_lb,
                               sb_ub, **common)
        x_best = to_np(x_new)
        logger.evaluate(x_best)
        if sb.expand(x_best):
            sb_lb, sb_ub = t(sb.lb), t(sb.ub)
        if i == n_points - 1:
            break
        if full_update and quick_updater is not None:
            do_update = True
            if fess_thresh < 1.0:
                # fESS gate (`activesample_vbmc.m:436-445`): skip the
                # retrain and refit while the VP still matches the
                # refreshed GP well enough.
                gp_tmp = gp_reupdate(cfg, gp, logger)
                do_update = fractional_ess(gen, cfg, vp, gp_tmp,
                                           100) <= fess_thresh
                if not do_update:
                    gp = gp_tmp
            if do_update:
                gp, vp, gls = quick_updater(gen, logger, gp, vp)
        else:
            gp = gp_reupdate(cfg, gp, logger)
    return gp_reupdate(cfg, gp, logger), vp
