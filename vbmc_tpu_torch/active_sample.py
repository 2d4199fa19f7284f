"""Active sampling (cf. `vbmc_tpu/active_sample.py`,
`private/activesample_vbmc.m`, `misc/initdesign_vbmc.m`): initial design,
candidate generation, the acquisition sweep (a CUDA kernel on the card
where the configuration is one the kernel computes: prospective for
noiseless targets, VIQR / IMIQR with an importance-sampling set for noisy
ones), CMA-ES refinement, target evaluation, and the GP refresh or, on
noisy targets, the per-point full update.

A point is proposed on one of two paths, as in the reference. The default
search composition goes through `_propose_point`.
A search cache, HPD draws, another optimiser, integer variables or
repeated observations need steps on the host between the sweep and the
evaluation, and go through `get_search_points` and the host path of
`active_sample`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch import elbo
from vbmc_tpu_torch.tracing import span
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import get_hpd
from vbmc_tpu_torch.gp.gp import GP, build_gp, pad_training_data
from vbmc_tpu_torch.gp.predict import gp_predict
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.vp import VariationalPosterior, vp_rnd, vp_moments
from vbmc_tpu_torch.acquisitions import (ACQ_INFO, evaluate_acquisition,
                                         sweep_acquisition, AcqState)
from vbmc_tpu_torch.active_is import (build_is_state_core,
                                      evaluate_is_acquisition,
                                      sweep_is_acquisition)
from vbmc_tpu_torch.samplers.cmaes import cmaes_minimize
from vbmc_tpu_torch.transforms import real_to_int
from vbmc_tpu_torch.vpoptim import fractional_ess
from vbmc_tpu_torch.utils.kmeans import kmeans
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
                   fvals_cache: Optional[np.ndarray] = None,
                   init_design: str = "plausible"):
    """First batch of evaluations: the starting points plus random draws
    (`initdesign_vbmc.m:10-28`), uniform in the plausible box
    ('plausible') or in a window of a tenth of it around the first
    starting point ('narrow'). A starting point with a finite value in
    ``fvals_cache`` enters the logger with that value; the target is not
    called there.

    A starting cache larger than ``n_evals`` is thinned by k-means, keeping
    of each cluster its member of highest value when ``fvals_cache`` covers
    the cache, else its first member (`initdesign_vbmc.m:30-45`); the rest
    is the search cache that `get_search_points` draws on
    (`activesample_vbmc.m:545-558`). Returns (search_cache (n_left, D),
    search_cache_y (n_left,)): the leftover points, possibly none, and
    their values (NaN where none was given)."""
    D = plb.shape[0]
    pts = []
    fv = (np.asarray(fvals_cache, float).ravel()
          if fvals_cache is not None else None)
    leftover = np.zeros((0, D))
    leftover_y = np.zeros(0)
    if x0_cache is not None and len(x0_cache):
        Xc = np.asarray(x0_cache, float).reshape(-1, D)
        if Xc.shape[0] > n_evals and n_evals > 0:
            _, assign = kmeans(Xc, n_evals, seed=0)
            covered = fv is not None and fv.size >= Xc.shape[0]
            chosen = np.zeros(Xc.shape[0], dtype=bool)
            for c in range(n_evals):
                members = np.where(assign == c)[0]
                if members.size == 0:
                    continue
                if covered:
                    best = members[int(np.nanargmax(
                        np.where(np.isfinite(fv[members]), fv[members],
                                 -np.inf)))]
                else:
                    best = members[0]
                chosen[best] = True
            # top up an underfull selection with unchosen points
            for j in np.where(~chosen)[0]:
                if chosen.sum() >= n_evals:
                    break
                chosen[j] = True
            leftover = Xc[~chosen]
            leftover_y = (fv[~chosen] if covered
                          else np.full(leftover.shape[0], np.nan))
            idx = np.where(chosen)[0]
            Xc = Xc[idx]
            fv = fv[idx] if fv is not None and fv.size else None
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
    for i, x in enumerate(np.concatenate(pts, axis=0)[:n_evals]):
        if fv is not None and i < len(fv) and np.isfinite(fv[i]):
            logger.add(x, float(fv[i]))
        else:
            logger.evaluate(x)
    return leftover, leftover_y


def get_search_points(gen: torch.Generator, n_search: int,
                      vp: VariationalPosterior, logger: FunctionLogger,
                      sb: SearchBounds, options,
                      search_cache: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
    """The search set of the host path (`activesample_vbmc.m:545-639`), on
    the VP's device: points of the search cache, heavy-tailed VP draws,
    moment-matched Gaussian draws, Gaussian draws matched to HPD parts of
    the training set, box-uniform draws around the training inputs, and
    balanced VP draws for the rest; clipped to the search box.
    (n_search, D)"""
    D = vp.D
    dev, dt = vp.mu.device, vp.mu.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dt)

    def randn(n):
        return torch.randn((n, D), generator=gen, device=dev, dtype=dt)

    parts = []
    n_sc = int(round(options.search_cache_frac * n_search))
    if n_sc > 0 and search_cache is not None and len(search_cache):
        parts.append(t(search_cache[:n_sc]))
    n_heavy = int(round(options.heavy_tail_search_frac * n_search))
    if n_heavy > 0:
        parts.append(vp_rnd(vp, gen, n_heavy, orig_flag=False, df=3.0))
    n_mvn = int(round(options.mvn_search_frac * n_search))
    if n_mvn > 0:
        mu, cov = vp_moments(vp, orig_flag=False)
        L = torch.linalg.cholesky(cov + 1e-12 * torch.eye(D, device=dev,
                                                          dtype=dt))
        parts.append(mu[None, :] + randn(n_mvn) @ L.T)
    n_hpd = int(round(options.hpd_search_frac * n_search))
    if n_hpd > 0:
        X, y, _ = logger.training_data()
        hpd_min, hpd_max = options.hpd_frac / 8, options.hpd_frac
        u = torch.rand(4, generator=gen, device=dev,
                       dtype=torch.float64).cpu().numpy()
        fracs = np.sort(np.concatenate([
            u * (hpd_max - hpd_min) + hpd_min, [hpd_min, hpd_max]]))
        n_vec = np.diff(np.round(np.linspace(0, n_hpd,
                                             len(fracs) + 1))).astype(int)
        for frac, n_i in zip(fracs, n_vec):
            if n_i == 0:
                continue
            X_hpd, _ = get_hpd(X, y, frac)
            if X_hpd.shape[0] < 2:
                mu_h = X[np.argmax(y)]
                cov_h = np.cov(X.T) + 1e-12 * np.eye(D)
            else:
                mu_h = X_hpd.mean(0)
                cov_h = np.cov(X_hpd.T, bias=True) + 1e-12 * np.eye(D)
            parts.append(t(mu_h)[None, :]
                         + randn(int(n_i)) @ t(np.linalg.cholesky(
                             np.atleast_2d(cov_h))).T)
    n_box = int(round(options.box_search_frac * n_search))
    if n_box > 0:
        X, _, _ = logger.training_data()
        diam = X.max(0) - X.min(0)
        box_lb, box_ub = X.min(0) - 0.5 * diam, X.max(0) + 0.5 * diam
        if np.all(np.isfinite(sb.lb)) and np.all(np.isfinite(sb.ub)):
            box_lb = np.maximum(box_lb, sb.lb)
            box_ub = np.minimum(box_ub, sb.ub)
        u = torch.rand((n_box, D), generator=gen, device=dev, dtype=dt)
        parts.append(t(box_lb) + u * t(box_ub - box_lb))
    n_vp = max(n_search - sum(p.shape[0] for p in parts), 0)
    if n_vp > 0:
        parts.append(vp_rnd(vp, gen, n_vp, orig_flag=False,
                            balance_flag=True))
    Xs = torch.cat(parts)[:n_search]
    return torch.minimum(torch.maximum(Xs, t(sb.lb)), t(sb.ub))


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


def _propose_point(gen, vp, gp, sweep, f_batch, sb_lb, sb_ub, n_search: int,
                   n_heavy: int, n_mvn: int, n_box: int, max_evals: int,
                   popsize: int):
    """One acquisition step: candidates -> ``sweep`` -> argmin -> CMA-ES on
    ``f_batch``, started at the sweep's winner with the VP's per-dimension
    scales, whose refined point is taken only if better. Returns the chosen
    point on the host."""
    with span("search"):
        Xs, cov_t = _gen_candidates(gen, vp, gp, sb_lb, sb_ub, n_search,
                                    n_heavy, n_mvn, n_box)
    with span("sweep"):
        acq = sweep(Xs)
    with span("refine"):
        acq_f = torch.where(torch.isfinite(acq), acq, torch.inf)
        best = torch.argmin(acq_f)
        x0, f0 = Xs[best], acq_f[best]
        insigma = torch.sqrt(torch.diagonal(cov_t).clamp_min(1e-12))
        res = cmaes_minimize(gen, f_batch, x0, insigma,
                             torch.minimum(x0, sb_lb),
                             torch.maximum(x0, sb_ub), max_evals=max_evals,
                             popsize=popsize, f0=f0)
        return to_np(res.x_best)


def gp_reupdate(cfg: GPConfig, gp: GP, logger: FunctionLogger) -> GP:
    """Refresh the GP posterior on the current training data (with the
    logger's noise variances), keeping the hyperparameter samples
    (`misc/gpreupdate.m`)."""
    with span("gp_update"):
        return build_gp(cfg, *pad_training_data(*logger.training_data(),
                                                device=gp.X.device,
                                                dtype=gp.X.dtype),
                        gp.hyp, gp.hyp_mask)


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


def _var_log_joint(cfg: GPConfig, gp: GP, vp: VariationalPosterior):
    """Variance of the log-joint integral per hyperparameter sample (S,),
    which "eig" needs anew as the GP changes
    (`activesample_vbmc.m:152-157`)."""
    J = elbo.gplogjoint(cfg, gp, vp.mu[None], vp.sigma[None], vp.lam[None],
                        vp.w[None], vp.kmask, compute_var=1)[4][0]
    wk = vp.w * vp.kmask.to(vp.w.dtype)
    return torch.einsum("j,sjk,k->s", wk, J, wk).clamp_min(1e-12)


def active_sample(gen: torch.Generator, cfg: GPConfig,
                  logger: FunctionLogger, n_points: int,
                  vp: VariationalPosterior, gp: GP, sb: SearchBounds,
                  options, *, acq_name: str, quick_updater=None,
                  delta_smoothing: Optional[np.ndarray] = None,
                  optim_state=None,
                  search_cache: Optional[np.ndarray] = None):
    """Acquire ``n_points`` new evaluations; returns (gp, vp), the GP
    refreshed on the enlarged training set.

    With a ``quick_updater(gen, logger, gp, vp) -> (gp, vp, gls)`` (the
    full update of noisy targets near the end of warm-up or on unstable
    runs, `activesample_vbmc.m:46-76, 429-473`) the GP hyperparameters are
    re-trained and the VP re-fitted after each acquired point, gated on the
    fractional effective sample size when
    ``options.active_sample_fess_thresh`` < 1; without one the GP keeps its
    hyperparameters. ``delta_smoothing`` (D,) is the GP smoothing bandwidth
    of the acquisition (`acqwrapper_vbmc.m:12-15`), None for none.
    ``optim_state`` carries the streak of repeated observations of a noisy
    target; ``search_cache`` (transformed space) feeds the search set when
    ``options.search_cache_frac`` > 0."""
    D = vp.D
    dt, dev = gp.X.dtype, gp.X.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dt)

    use_is = ACQ_INFO[acq_name]["importance_sampling"]
    # Integer dimensions are rounded through the transform
    # (`activesample_vbmc.m:219,248`, `misc/real2int_vbmc.m`).
    integer_mask = np.zeros(D, dtype=bool)
    if len(options.integer_vars):
        integer_mask[np.asarray(options.integer_vars, dtype=int)] = True
    has_int = bool(integer_mask.any())
    repeat_obs = (logger.noise_flag and options.max_repeated_observations > 0
                  and optim_state is not None)
    # The default composition with CMA-ES from the VP's moments goes
    # through _propose_point; rounding and the repeated-observation
    # check need steps between the sweep and the evaluation.
    fused_ok = (options.search_cache_frac == 0
                and options.hpd_search_frac == 0
                and options.search_optimizer == "cmaes"
                and options.search_cmaes_vp_init
                and not has_int and not repeat_obs)

    lb_eps, ub_eps = _hard_bound_eps(logger, options)
    ns = options.ns_search
    common = dict(n_search=ns,
                  n_heavy=int(round(options.heavy_tail_search_frac * ns)),
                  n_mvn=int(round(options.mvn_search_frac * ns)),
                  n_box=int(round(options.box_search_frac * ns)),
                  max_evals=options.search_max_fun_evals,
                  popsize=options.search_cmaes_popsize)
    is_sizes = dict(
        n_vp=int(options.active_importance_sampling_vp_samples),
        n_box=int(options.active_importance_sampling_box_samples),
        n_mcmc=int(options.active_importance_sampling_mcmc_samples),
        mh_steps=int(options.active_importance_sampling_mh_steps),
        fess_thresh=float(options.active_importance_sampling_fess_thresh))
    smooth = delta_smoothing is not None
    delta = t(delta_smoothing) if smooth else None
    sb_lb, sb_ub = t(sb.lb), t(sb.ub)
    gls = t(_geomean_length_scale(cfg, gp))
    insigma_vp = None      # the VP's scales, until the VP changes

    for i in range(n_points):
        with torch.no_grad():
            state = AcqState(
                ymax=t(logger.ymax), tol_var=t(options.tol_gp_var),
                lb_eps_orig=t(lb_eps), ub_eps_orig=t(ub_eps),
                regularize=True, gp_length_scale=gls,
                var_log_joint=(_var_log_joint(cfg, gp, vp)
                               if acq_name == "eig" else None),
                delta=delta)
            # The importance-sampling set is rebuilt for every point: the GP
            # changes as evaluations accrue (`activesample_vbmc.m:208-211`).
            ais = None
            if use_is:
                with span("is_set"):
                    ais = build_is_state_core(gen, cfg, acq_name, vp, gp,
                                              **is_sizes)

            def sweep(Xs):
                if ais is not None:
                    return sweep_is_acquisition(cfg, acq_name, Xs, vp, gp,
                                                state, ais)
                return sweep_acquisition(cfg, acq_name, Xs, vp, gp, state,
                                         smooth=smooth)

            def f_batch(xs, st=state):
                if ais is not None:
                    return evaluate_is_acquisition(cfg, acq_name, xs, vp, gp,
                                                   st, ais)
                return evaluate_acquisition(cfg, acq_name, xs, vp, gp, st,
                                            smooth=smooth)

            if fused_ok:
                x_best = _propose_point(gen, vp, gp, sweep, f_batch, sb_lb,
                                        sb_ub, **common)
            else:
                with span("search"):
                    Xs = real_to_int(logger.trinfo, get_search_points(
                        gen, ns, vp, logger, sb, options,
                        search_cache=search_cache), integer_mask)
                with span("sweep"):
                    acq = sweep(Xs)
                with span("refine"):
                    acq = torch.where(torch.isfinite(acq), acq, torch.inf)
                    best = torch.argmin(acq)
                    x_best_t, f_best = Xs[best], float(acq[best])

                    # CMA-ES refinement of the winner (`activesample:246-330`).
                    if options.search_optimizer == "cmaes":
                        if options.search_cmaes_vp_init:
                            if insigma_vp is None:
                                _, cov = vp_moments(vp, orig_flag=False)
                                insigma_vp = torch.sqrt(
                                    torch.diagonal(cov).clamp_min(1e-12))
                            insigma = insigma_vp
                        else:
                            X_t, y_t, _ = logger.training_data()
                            X_hpd, _ = get_hpd(X_t, y_t, options.hpd_frac)
                            insigma = t(np.maximum(X_hpd.std(0), 1e-6))
                        res = cmaes_minimize(
                            gen, f_batch, x_best_t, insigma,
                            torch.minimum(x_best_t, sb_lb),
                            torch.maximum(x_best_t, sb_ub),
                            max_evals=options.search_max_fun_evals,
                            popsize=options.search_cmaes_popsize)
                        x_ref, f_ref = res.x_best, float(res.f_best)
                        if has_int:
                            # rounding may change the value: evaluate there
                            x_ref = real_to_int(logger.trinfo,
                                                t(x_ref)[None, :],
                                                integer_mask)[0]
                            f_ref = float(f_batch(x_ref[None, :])[0])
                        if f_ref < f_best:
                            x_best_t, f_best = x_ref, f_ref
                    x_best = to_np(x_best_t)

                # Repeated observations of a noisy target
                # (`activesample_vbmc.m:334-365`): when acquiring at a point
                # already observed is better, at a discount, than the new
                # candidate, measure that point again; the logger merges
                # the duplicates by their precisions.
                if repeat_obs:
                    if (optim_state.repeated_obs_streak
                            >= options.max_repeated_observations):
                        optim_state.repeated_obs_streak = 0
                    else:
                        X_t, _, _ = logger.training_data()
                        acq_t = f_batch(
                            t(pad_to(X_t, bucket_n(X_t.shape[0]))),
                            dataclasses.replace(state, regularize=False))
                        acq_t = to_np(acq_t)[:X_t.shape[0]]
                        acq_t = np.where(np.isfinite(acq_t), acq_t, np.inf)
                        idx_t = int(np.argmin(acq_t))
                        if acq_t[idx_t] < options.repeated_acq_discount \
                                * f_best:
                            x_best = X_t[idx_t]
                            optim_state.repeated_obs_streak += 1
                        else:
                            optim_state.repeated_obs_streak = 0

        with span("evaluate"):
            y_new, _ = logger.evaluate(x_best)
        if sb.expand(x_best):
            sb_lb, sb_ub = t(sb.lb), t(sb.ub)
        # The acquisition's debug record (`activesample_vbmc.m:403-409`).
        if optim_state is not None and getattr(options, "acq_debug", False):
            with torch.no_grad():
                fbar_q, vtot_q, _, _ = gp_predict(cfg, gp, t(x_best)[None, :])
            optim_state.acqtable.append(
                (acq_name, float(y_new), float(fbar_q[0]),
                 float(np.sqrt(max(float(vtot_q[0]), 0.0)))))
        if i == n_points - 1:
            break
        if quick_updater is not None:
            with span("full_update"):
                do_update = True
                fess_thresh = options.active_sample_fess_thresh
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
                    insigma_vp = None
        else:
            gp = gp_reupdate(cfg, gp, logger)
    return gp_reupdate(cfg, gp, logger), vp
