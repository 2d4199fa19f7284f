"""The VBMC orchestrator (cf. `vbmc_tpu/main.py`, `vbmc.m:506-882`), for
noiseless targets and for noisy ones that return their noise SD or leave it
to the GP, with every GP mean family, the integrated mean, output warping
("fitness shaping"), bandwidth smoothing and every acquisition; warm starts
from a variational posterior, pre-evaluated starting points (``fvals``),
tempered targets, the retry from the best posterior, the live plot, and
the multi-run sweep `vbmc_sweep`.

Orchestration (state machine, warm-up, termination, warp-undo
transactions, the acquisition hedge) is host Python on numpy, in the port's
own `options`, `state` and `hedge` modules; every numeric path runs in
PyTorch on the card, or on the CPU when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from vbmc_tpu_torch.options import VBMCOptions, ResolvedOptions
from vbmc_tpu_torch import state as st
from vbmc_tpu_torch import tracing
from vbmc_tpu_torch.hedge import AcqHedge
from vbmc_tpu_torch.transforms import (create_trinfo, direct_np, inverse_np,
                                       LOGIT, PROBIT, STUDENT4)
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.gp.config import (
    GPConfig, MEAN_ZERO, MEAN_CONST, MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE,
    MEAN_NEGQUADONLY, MEAN_NEGQUADLINONLY, MEAN_NEGQUADFIXISO,
    MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX, MEAN_NEGQUADFIXONLY, MEAN_NEGQUADMIX,
    FIXED_CENTER_MEANFUNS, OUTWARP_NEGPOW, OUTWARP_NEGPOWC1,
    OUTWARP_NEGSCALEDPOW)
from vbmc_tpu_torch.gp.fit import train_gp, TrainOptions
from vbmc_tpu_torch.gp.means import fix_center_from_data
from vbmc_tpu_torch.gp.predict import gp_predict
from vbmc_tpu_torch.vp import (VariationalPosterior, make_vp, vp_moments,
                               vp_kldiv, vp_rnd, is_valid_vp, vp_train2real)
from vbmc_tpu_torch.vpoptim import vpoptimize
from vbmc_tpu_torch.active_sample import (initial_design, active_sample,
                                          SearchBounds, gp_reupdate)
from vbmc_tpu_torch.quick_update import QuickUpdater
from vbmc_tpu_torch.utils.math import bucket_k, bucket_n, mvn_kl, pad_to, \
    to_np, N_BUCKETS

_MEANFUN_IDS = {"zero": MEAN_ZERO, "const": MEAN_CONST,
                "negquad": MEAN_NEGQUAD, "se": MEAN_SE,
                "negquadse": MEAN_NEGQUADSE,
                "negquadonly": MEAN_NEGQUADONLY,
                "negquadlinonly": MEAN_NEGQUADLINONLY,
                "negquadfixiso": MEAN_NEGQUADFIXISO,
                "negquadfix": MEAN_NEGQUADFIX,
                "negquadsefix": MEAN_NEGQUADSEFIX,
                "negquadfixonly": MEAN_NEGQUADFIXONLY,
                "negquadmix": MEAN_NEGQUADMIX}
_TRANSFORM_IDS = {"logit": LOGIT, "probit": PROBIT, "norminv": PROBIT,
                  "student4": STUDENT4}
_OUTWARP_IDS = {"negpow": OUTWARP_NEGPOW, "negpowc1": OUTWARP_NEGPOWC1,
                "negscaledpow": OUTWARP_NEGSCALEDPOW}


@dataclasses.dataclass
class VBMCResult:
    """What `vbmc` returns. ``timers`` holds the run's seconds by span path
    (`tracing`: ``active_sampling``, ``gp_train.map``, ...; the five
    phases always, 0 where a phase never ran), ``final_boost``, ``total``
    and, after a retry that won, ``first_run``. ``spans`` is the run's span
    log, one ``(iteration, path, t0_ns, t1_ns)`` per span in the order the
    spans closed, on `time.monotonic_ns()`."""
    vp: VariationalPosterior
    elbo: float
    elbo_sd: float
    exitflag: int
    message: str
    stats: st.Stats
    optim_state: st.OptimState
    logger: FunctionLogger
    vp_train: VariationalPosterior
    func_count: int
    iterations: int
    convergence_status: str
    idx_best: int
    timers: dict
    overhead: float = float("nan")
    warps_made: int = 0        # rotoscale warps applied
    warps_undone: int = 0      # of which undone by the ELBO check
    quick_updates: int = 0     # per-point full updates (noisy targets)
    spans: list = dataclasses.field(default_factory=list)


# The top-level spans of an iteration that every `timer` names, 0 where one
# did not run.
PHASES = ("active_sampling", "gp_train", "variational_fit", "finalize",
          "warping")


def _with_phases(seconds: dict) -> dict:
    return {**dict.fromkeys(PHASES, 0.0), **seconds}


def bounds_check(x0, lb, ub, plb, pub, D):
    """Validate/repair bounds (cf. `misc/boundscheck_vbmc.m:12-142`)."""
    import warnings

    def broadcast(v, default):
        if v is None:
            return np.full(D, default, dtype=float)
        v = np.asarray(v, dtype=float).ravel()
        return np.full(D, float(v[0])) if v.size == 1 else v.copy()

    lb = broadcast(lb, -np.inf)
    ub = broadcast(ub, np.inf)
    x0 = np.atleast_2d(np.asarray(x0, float)) if x0 is not None else None
    if plb is None or pub is None:
        if x0 is not None and x0.shape[0] > 1:
            plb_i = np.min(x0, axis=0) if plb is None else broadcast(plb, np.nan)
            pub_i = np.max(x0, axis=0) if pub is None else broadcast(pub, np.nan)
            width = pub_i - plb_i
            plb = np.maximum(lb, plb_i - 0.1 * width)
            pub = np.minimum(ub, pub_i + 0.1 * width)
        else:
            plb = lb.copy() if plb is None else plb
            pub = ub.copy() if pub is None else pub
    plb = broadcast(plb, np.nan)
    pub = broadcast(pub, np.nan)

    if np.any(np.isfinite(lb) ^ np.isfinite(ub)):
        raise ValueError(
            "Variables bounded only on one side are not supported; use a "
            "transformed parameterization or provide both bounds.")
    if x0 is not None and (np.any(x0 < lb[None, :]) or
                           np.any(x0 > ub[None, :])):
        raise ValueError("The starting points x0 are not inside the provided "
                         "hard bounds LB and UB.")
    rng_b = ub - lb
    rng_b = np.where(np.isinf(rng_b), 1e3, rng_b)
    sf = 1e-3
    lb_eff = np.where(np.abs(lb) <= np.finfo(float).tiny, sf * rng_b,
                      lb + sf * rng_b)
    ub_eff = np.where(np.abs(ub) <= np.finfo(float).tiny, -sf * rng_b,
                      ub - sf * rng_b)
    lb_eff = np.where(np.isinf(lb), lb, lb_eff)
    ub_eff = np.where(np.isinf(ub), ub, ub_eff)
    if np.any(lb_eff >= ub_eff):
        raise ValueError("Hard bounds LB and UB are numerically too close; "
                         "make them more separate.")
    if x0 is not None and (np.any(x0 <= lb_eff[None, :]) or
                           np.any(x0 >= ub_eff[None, :])):
        warnings.warn("The starting points x0 are on or numerically too "
                      "close to the hard bounds LB and UB; moving the "
                      "initial points inside.")
        x0 = np.clip(x0, lb_eff, ub_eff)
    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")
    if np.any(plb <= lb_eff) or np.any(pub >= ub_eff):
        warnings.warn("Hard and plausible bounds should not be too close; "
                      "moving the plausible bounds.")
        plb = np.maximum(plb, lb_eff)
        pub = np.minimum(pub, ub_eff)
    if x0 is not None and (np.any(x0 <= plb[None, :]) or
                           np.any(x0 >= pub[None, :])):
        warnings.warn("The starting points x0 are not inside the provided "
                      "plausible bounds PLB and PUB; expanding the plausible "
                      "bounds.")
        plb = np.minimum(plb, np.min(x0, axis=0))
        pub = np.maximum(pub, np.max(x0, axis=0))
    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")
    return x0, lb, ub, plb, pub


def _check_options(opt: ResolvedOptions):
    """The reference's up-front validation of enum-like options
    (`vbmc_tpu/main.py:397-416`)."""
    if opt.gp_mean_fun not in _MEANFUN_IDS:
        raise ValueError(
            f"gp_mean_fun={opt.gp_mean_fun!r} is not supported; choose one "
            f"of {sorted(_MEANFUN_IDS)}.")
    if opt.bounded_transform not in _TRANSFORM_IDS:
        raise ValueError(
            f"bounded_transform={opt.bounded_transform!r} is not supported; "
            f"choose one of {sorted(_TRANSFORM_IDS)}.")
    if opt.fitness_shaping and opt.gp_out_warp_fun not in _OUTWARP_IDS:
        raise ValueError(
            f"gp_out_warp_fun={opt.gp_out_warp_fun!r} is not supported; "
            f"choose one of {sorted(_OUTWARP_IDS)}.")
    for a in (opt.search_acq_fcn or ()):
        _canonical_acq(a)


def _gp_train_options(run: _Run) -> TrainOptions:
    """GP training policy per iteration (`misc/get_GPTrainOptions.m`, the
    Ns schedule of `gptrain_vbmc.m:314-343`)."""
    state, stats, options, logger = run.state, run.stats, run.opt, run.logger
    n = logger.n_train
    neff = logger.neff
    if state.stop_sampling == 0:
        ns = int(round(options.ns_gp_max / math.sqrt(max(n, 1))))
        if state.warmup:
            ns = min(ns, options.ns_gp_max_warmup)
        elif math.isfinite(options.ns_gp_max_main):
            ns = min(ns, int(options.ns_gp_max_main))
        if n >= options.stable_gp_sampling:
            state.stop_sampling = n
        if state.vp_K >= options.stable_gp_vp_k:
            state.stop_sampling = n
    if state.stop_sampling > 0:
        ns = options.stable_gp_samples

    # Cubic Ninit schedule 1024 -> 64 (`get_GPTrainOptions:93-100`).
    a = -(options.gp_train_n_init - options.gp_train_n_init_final)
    b, c, d = -3 * a, 3 * a, options.gp_train_n_init
    x = (neff - options.fun_eval_start) / \
        (min(options.max_fun_evals, 1e3) - options.fun_eval_start)
    n_init = max(int(round(a * x ** 3 + b * x ** 2 + c * x + d)), 0)

    rindex_prev = stats.last.rindex if len(stats) else math.inf
    thin = options.gp_sample_thin
    if state.recompute_var_post:
        burnin = thin * ns
        nopts = 1 if ns > 0 else 2
    else:
        burnin = thin * 3
        if rindex_prev < options.gp_retrain_threshold:
            n_init = 0
            nopts = 0 if ns > 0 else 1
        else:
            burnin = thin * ns
            nopts = 1 if ns > 0 else 2

    widths = None
    escalated = False
    if options.gp_sample_widths > 0 and state.hyp_runcov is not None:
        widthmult = max(options.gp_sample_widths,
                        rindex_prev if math.isfinite(rindex_prev) else
                        options.gp_sample_widths)
        widths = np.maximum(np.sqrt(np.diag(state.hyp_runcov)), 1e-3) \
            * widthmult
        escalated = bool(widthmult > options.gp_sample_widths)

    return TrainOptions(
        ns_samples=ns, ninit=n_init, nopts=max(nopts, 0 if ns > 0 else 1),
        thin=thin, burnin=burnin, n_chains=options.n_gp_chains,
        widths=widths, widths_escalated=escalated,
        lbfgs_iters=options.lbfgs_iters, hpd_frac=options.hpd_frac,
        tol_gp_noise=options.tol_gp_noise, noise_size=options.noise_size,
        length_prior_mean_mult=options.evalopt("gp_length_prior_mean",
                                               options.D),
        length_prior_std=options.gp_length_prior_std,
        quadratic_mean_bound=options.gp_quadratic_mean_bound,
        tol_sd=options.tol_sd, uncertainty_level=logger.uncertainty_level,
        upper_length_factor=options.upper_gp_length_factor,
        outwarp_delta=state.outwarp_delta,
        outwarp_thresh_base=options.out_warp_thresh_base)


def _update_hyp_runcov(state: st.OptimState, hyp_full: np.ndarray,
                       options: ResolvedOptions):
    """Running average of the hyperparameter covariance
    (`gptrain_vbmc.m:82-94`)."""
    if hyp_full is None or hyp_full.shape[0] <= 1:
        state.hyp_runcov = None
        return
    hypcov = np.cov(hyp_full.T)
    if state.hyp_runcov is None or options.hyp_run_weight == 0:
        state.hyp_runcov = hypcov
    else:
        w = options.hyp_run_weight ** options.fun_evals_per_iter
        state.hyp_runcov = (1 - w) * hypcov + w * state.hyp_runcov


def _recenter_cfg(cfg: GPConfig, X_tr: np.ndarray,
                  y_tr: np.ndarray) -> GPConfig:
    """Move the fixed centre of the FIXED_CENTER_MEANFUNS families to the
    current incumbent, as the reference recomputes `meanfun_extras` =
    X[argmax y] at every `gplite_train` (`gplite_meanfun.m:334-341`)."""
    if cfg.meanfun not in FIXED_CENTER_MEANFUNS:
        return cfg
    center = fix_center_from_data(X_tr, y_tr)
    if center == cfg.fix_center:
        return cfg
    return dataclasses.replace(cfg, fix_center=center)


def _noise_shaping(s2, y, options):
    """Add artificial noise to low-density observations
    (`misc/noiseshaping_vbmc.m`)."""
    if s2 is None:
        s2 = np.full(y.shape, options.tol_gp_noise ** 2)
    ydelta = np.maximum(0.0, np.max(y) - y - options.noise_shaping_threshold)
    return s2 + (options.noise_shaping_factor * ydelta) ** 2


def _estimate_sn2hpd(gp, logger, sn2: np.ndarray) -> float:
    """GP noise around the top HPD region (`gptrain_vbmc.m:347-377`)."""
    X, _, _ = logger.training_data()
    n_hpd = max(int(math.ceil(0.2 * X.shape[0])), 1)
    m = to_np(gp.hyp_mask).astype(float)
    sn2_mean = (sn2 * m[:, None]).sum(0) / max(m.sum(), 1.0)
    sel = np.where(to_np(gp.mask).astype(bool))[0]
    if sel.size == 0:
        return float("inf")
    order_idx = np.argsort(to_np(gp.y)[sel])[::-1][:n_hpd]
    return float(np.median(sn2_mean[sel][order_idx]))


def _predict_padded(cfg, gp, X: np.ndarray):
    """GP predictive summary at host points, in chunks of the top N bucket,
    each padded to its bucket. Returns host (fbar, vtot)."""
    X = np.asarray(X, float)
    n = X.shape[0]
    top = N_BUCKETS[-1]
    fb, vt = [], []
    with torch.no_grad():
        for i in range(0, max(n, 1), top):
            chunk = X[i:i + top]
            Xp = torch.as_tensor(pad_to(chunk, bucket_n(chunk.shape[0])),
                                 device=gp.X.device, dtype=gp.X.dtype)
            fbar, vtot, _, _ = gp_predict(cfg, gp, Xp)
            fb.append(to_np(fbar)[:chunk.shape[0]])
            vt.append(to_np(vtot)[:chunk.shape[0]])
    return np.concatenate(fb), np.concatenate(vt)


def _recompute_lcbmax(cfg, gp, logger, stats: st.Stats, options) -> np.ndarray:
    """Historical max-LCB trace under the current GP (`vbmc.m:816`)."""
    n = logger.Xn
    fbar, vtot = _predict_padded(cfg, gp, logger.X[:n])
    lcb = fbar - options.elcbo_impro_weight * np.sqrt(np.maximum(vtot, 0.0))
    lcb = np.where(logger.X_flag[:n], lcb, -np.inf)
    out = np.empty(len(stats))
    for i, itstat in enumerate(stats.iterations):
        upto = min(int(itstat.func_count), n)
        out[i] = np.max(lcb[:upto]) if upto > 0 else -np.inf
    return out


def _canonical_acq(name: str) -> str:
    aliases = {"acqf": "prospective", "prospective": "prospective",
               "acqfsn2": "prospective_sn2", "prospective_sn2": "prospective_sn2",
               "acqflog": "prospective_log", "prospective_log": "prospective_log",
               "us": "us", "acqus": "us", "eig": "eig", "acqeig": "eig",
               "viqr": "viqr", "acqviqr": "viqr",
               "imiqr": "imiqr", "acqimiqr": "imiqr"}
    if name not in aliases:
        raise ValueError(
            f"search_acq_fcn entry {name!r} is not a known acquisition "
            f"function (known: prospective, prospective_sn2, "
            f"prospective_log, us, eig, viqr, imiqr).")
    return aliases[name]


def _collect_hyp_starts(stats: st.Stats, hyp_warm, ninit: int):
    """Recycle hyperparameter samples from the most recent iterations."""
    pool = []
    if hyp_warm is not None:
        pool.append(np.atleast_2d(hyp_warm))
    for itstat in stats.iterations[len(stats) // 2:]:
        if itstat.gp_hyp is not None:
            pool.append(np.atleast_2d(itstat.gp_hyp))
    if not pool:
        return None
    cat = np.concatenate(pool, axis=0)
    n_keep = max(int(ninit // 2), 4)
    if cat.shape[0] > n_keep:
        cat = cat[np.random.default_rng(0).permutation(cat.shape[0])[:n_keep]]
    return np.unique(cat, axis=0)


def vbmc(fun: Callable, x0=None, lb=None, ub=None, plb=None, pub=None,
         options: Optional[VBMCOptions] = None, *, device="cuda",
         dtype=torch.float64) -> VBMCResult:
    """Run VBMC on a black-box log joint ``fun`` (with
    ``specify_target_noise`` it returns (value, noise SD)): the same call as
    `vbmc_tpu.vbmc`, plus the device and dtype every tensor lives in. The
    device is the card unless the caller names another (``device="cpu"``);
    without a card the default raises, and nothing moves to the CPU on its
    own. Randomness is one `torch.Generator` on that device seeded from
    ``options.seed``.

    ``x0`` may be a variational posterior (a warm start): 100 draws from it
    (seeded with ``options.seed + 77``) give the starting points and, when
    none are given, the plausible bounds (their 5% and 95% quantiles).

    The call's spans (`tracing`) roll up into each iteration's ``timer``
    (the spans closed since the previous iteration's) and into the result's
    ``timers`` and ``spans``."""
    tracer = tracing.Tracer()
    with tracer.current():
        run = _Run(tracer, fun, x0, lb, ub, plb, pub, options, device, dtype)
        while not run.is_finished:
            _next_iteration(run)
            vp_old = run.vp
            warping(run)
            active_sampling(run)
            gpinfo = gp_train(run)
            fit = variational_fit(run)
            finalize(run, vp_old, gpinfo, fit)
            termination(run)
            output_fcn(run)
        return final_boost(run)


# What an input warp changes and its undo puts back (`vbmc.m:566-624`):
# these fields of the run and of its OptimState, and the logger's transform.
_WARPED = ("vp", "gp", "plb_t", "pub_t", "sb", "hyp_warm")
_WARPED_STATE = ("hyp_runcov", "run_mean", "run_cov")


class _Run:
    """What one `vbmc` call carries from phase to phase; making it is the
    call's set-up. Each span of an iteration is one function of it
    (`warping`, `active_sampling`, `gp_train`, `variational_fit`,
    `finalize`, `termination`, `output_fcn`), and so is `final_boost`."""

    def __init__(self, tracer, fun, x0, lb, ub, plb, pub, options, device,
                 dtype):
        self.t0 = time.monotonic()
        self.tracer, self.fun, self.dtype = tracer, fun, dtype
        # the user's options (the retry's base), resolved for D, and the
        # bounds in original space after `bounds_check`
        self.options = VBMCOptions() if options is None else options
        (device, opt, self.x0, self.lb, self.ub, self.plb,
         self.pub) = _checked_call(device, x0, lb, ub, plb, pub, self.options)
        self.device, self.opt = device, opt
        D = opt.D

        trinfo = create_trinfo(
            self.lb, self.ub, self.plb, self.pub,
            bounded_type=_TRANSFORM_IDS[opt.bounded_transform],
            device=device, dtype=dtype)
        # the plausible box, transformed
        self.plb_t = direct_np(trinfo, self.plb[None, :])[0]
        self.pub_t = direct_np(trinfo, self.pub[None, :])[0]
        lb_t = direct_np(trinfo, self.lb[None, :])[0]
        ub_t = direct_np(trinfo, self.ub[None, :])[0]

        uncertainty_level = (2 if opt.specify_target_noise
                             else (1 if opt.uncertainty_handling else 0))
        self.logger = FunctionLogger(fun, D, trinfo,
                                     uncertainty_level=uncertainty_level,
                                     cache_size=opt.cache_size,
                                     temperature=opt.temperature)
        # the GP family; its mean's fixed centre follows the data
        self.cfg = _gp_config(opt, uncertainty_level)
        self.shaping = _noise_shaping if opt.noise_shaping else None

        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(opt.seed)
        self.rng = np.random.default_rng(opt.seed)
        K = opt.k_warmup
        u0 = direct_np(trinfo, self.x0[:1])[0]
        mu_init = np.tile(u0, (K, 1)) + 1e-6 * self.rng.standard_normal((K, D))
        self.vp = make_vp(trinfo, mu_init, sigma=1e-3, lam=np.ones(D),
                          k_max=bucket_k(K))
        self.gp = None
        self.hyp_warm = None      # GP training's warm starts
        self.elbo = self.elbo_sd = float("nan")

        self.state = st.OptimState(
            warmup=opt.warmup, vp_K=K,
            entropy_switch=opt.entropy_switch and D >= opt.det_entropy_min_d,
            outwarp_delta=(opt.out_warp_thresh_base
                           if opt.fitness_shaping else None))
        if opt.ns_gp_max <= 0:
            self.state.stop_sampling = math.inf
        self.stats = st.Stats()
        self.sb = SearchBounds.init(self.plb_t, self.pub_t, lb_t, ub_t,
                                    opt.active_search_bound)
        # leftover starting points, in original space so that they survive
        # input warps
        self.search_cache = None
        self.acq_names = tuple(_canonical_acq(a) for a in opt.search_acq_fcn)
        self.hedge = None
        if opt.acq_hedge and len(self.acq_names) > 1:
            self.hedge = AcqHedge(names=list(self.acq_names),
                                  decay=opt.acq_hedge_decay)
        self.plot = opt.plot      # off after a failed plot
        self.notes = []           # the iteration's
        self.warps_made = self.warps_undone = self.quick_updates = 0
        self.is_finished, self.exitflag, self.msg = False, 0, ""
        if opt.display == "iter":
            mode = "NOISY" if uncertainty_level else "EXACT"
            print(f"Beginning variational optimization assuming {mode} "
                  f"observations of the log-joint.")
            print(" Iteration  f-count     Mean[ELBO]     Std[ELBO]     "
                  "sKL-iter[q]   K[q]  Convergence  Action")

    def save(self):
        """What an input warp changes, for `restore`."""
        return ({f: getattr(self, f) for f in _WARPED},
                {f: getattr(self.state, f) for f in _WARPED_STATE},
                self.logger.trinfo)

    def restore(self, saved):
        fields, state_fields, trinfo = saved
        self.logger.retransform(trinfo)
        vars(self).update(fields)
        vars(self.state).update(state_fields)


def _gp_config(opt: ResolvedOptions, uncertainty_level: int) -> GPConfig:
    user_noise = {0: 0, 1: 2, 2: 1}[uncertainty_level]
    if opt.noise_shaping:
        user_noise = max(user_noise, 1)
    return GPConfig(D=opt.D, meanfun=_MEANFUN_IDS[opt.gp_mean_fun],
                    const_noise=1, user_noise=user_noise, output_noise=0,
                    intmean=int(opt.gp_int_mean_fun),
                    outwarp=(_OUTWARP_IDS[opt.gp_out_warp_fun]
                             if opt.fitness_shaping else 0))


def _checked_call(device, x0, lb, ub, plb, pub, options: VBMCOptions):
    """The device checked, the options resolved for D, and the bounds and
    starting points checked (`bounds_check`), a VP ``x0`` replaced by draws
    from it. Returns (device, opt, x0, lb, ub, plb, pub)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"vbmc: device {str(device)!r} was asked for but "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "on the CPU")
    # Reduced-precision products corrupt the quadrature covariance (the
    # reference sets jax_default_matmul_precision=highest for the same
    # reason): keep float32 products in full float32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x0_from_vp = None
    if is_valid_vp(x0):
        gen0 = torch.Generator(device=x0.mu.device)
        gen0.manual_seed(options.seed + 77)
        with torch.no_grad():
            Xvp = to_np(vp_rnd(x0, gen0, 100, orig_flag=True))
        x0 = Xvp[:1]
        if plb is None or pub is None:
            plb = np.quantile(Xvp, 0.05, axis=0)
            pub = np.quantile(Xvp, 0.95, axis=0)
        x0_from_vp = Xvp
    if x0 is not None:
        x0 = np.atleast_2d(np.asarray(x0, float))
        D = x0.shape[1]
    elif plb is not None:
        D = np.asarray(plb).ravel().shape[0]
    else:
        raise ValueError("Provide x0, or plausible bounds PLB and PUB.")

    opt = options.resolve(D)
    _check_options(opt)
    x0, lb, ub, plb, pub = bounds_check(x0, lb, ub, plb, pub, D)
    if x0 is None or not np.all(np.isfinite(x0)):
        x0 = 0.5 * (plb + pub)[None, :]
    if x0_from_vp is not None:
        # the other draws join as extra starting points, inside the bounds
        x0 = np.concatenate([x0, np.clip(x0_from_vp[1:opt.fun_eval_start],
                                         lb, ub)], axis=0)
    return device, opt, x0, lb, ub, plb, pub


def _next_iteration(run: _Run):
    """Start an iteration: its number, its notes and the entropy switch."""
    opt, state = run.opt, run.state
    state.iter = run.tracer.iteration = len(run.stats) + 1
    run.notes = ["start warm-up"] if state.iter == 1 and state.warmup else []
    if (state.entropy_switch and run.logger.func_count
            >= opt.entropy_force_switch * opt.max_fun_evals):
        state.entropy_switch = False
        run.notes.append("entropy switch")


def _train_gp(run: _Run, hyp0=None):
    """GP training on the run's training set with this iteration's options
    (`train_gp`), the mean's fixed centre moved to the incumbent first.
    ``hyp0`` are the hyperparameter starts, by default the warm starts and
    the recent iterations' samples. Returns (gp, info); opens no span."""
    topts = _gp_train_options(run)
    X_tr, y_tr, s2_tr = run.logger.training_data(noise_shaping=run.shaping,
                                                 options=run.opt)
    if hyp0 is None:
        hyp0 = _collect_hyp_starts(run.stats, run.hyp_warm, topts.ninit)
    run.cfg = _recenter_cfg(run.cfg, X_tr, y_tr)
    return train_gp(run.gen, run.cfg, X_tr, y_tr, s2_tr, run.plb_t,
                    run.pub_t, topts, hyp0=hyp0,
                    host_seed=int(run.rng.integers(2 ** 31 - 1)),
                    device=run.device, dtype=run.dtype)


def _fit_vp(run: _Run, vp, gp, K: int, n_fast: int, n_slow: int,
            warmup: Optional[bool] = None, **kw):
    """`vpoptimize` with the run's generator, GP family, warm-up (unless
    ``warmup`` says otherwise), entropy switch and a host seed from its
    draws; ``kw`` goes on. Opens no span."""
    return vpoptimize(run.gen, run.cfg, vp, gp, K, run.opt,
                      warmup=run.state.warmup if warmup is None else warmup,
                      entropy_switch=run.state.entropy_switch,
                      n_fast_opts=n_fast, n_slow_opts=n_slow,
                      host_seed=int(run.rng.integers(2 ** 31 - 1)), **kw)


def warping(run: _Run):
    """Input warping (`vbmc.m:530-625`): when one is due, a rotoscale warp
    to the best iteration's posterior (`warp_input_vbmc.m`), as a
    transaction on the run. With ``warp_undo_check`` the GP is retrained
    and the posterior refitted in the warped space, and the warp is undone
    if the ELBO regresses."""
    from vbmc_tpu_torch import warp as warp_mod
    opt, state, stats, logger = run.opt, run.state, run.stats, run.logger
    it = state.iter
    warp_delay = opt.warp_every_iters * max(1, state.warping_count) \
        if opt.incremental_warp_delay else opt.warp_every_iters
    if not (opt.warp_roto_scaling and it > 1 and not state.warmup
            and run.gp is not None and opt.D > 1
            and (it - state.last_warping) > warp_delay
            and state.vp_K >= opt.warp_min_k
            and stats.last.rindex < opt.warp_tol_reliability):
        return
    with tracing.span("warping"):
        idx_b = st.best_iteration(stats, safe_sd=opt.best_safe_sd,
                                  frac_back=opt.best_frac_back,
                                  rank_criterion=opt.rank_criterion)
        before = run.save()
        with tracing.span("rotoscale"):
            trinfo_new = warp_mod.compute_rotoscale(
                stats.iterations[idx_b].vp,
                corr_thresh=opt.warp_roto_corr_thresh,
                cov_reg=opt.warp_cov_reg)
        seed_w = int(run.rng.integers(2 ** 31 - 1))
        with tracing.span("bounds"):
            run.plb_t, run.pub_t = warp_mod.update_plausible_bounds(
                trinfo_new, run.plb, run.pub, seed_w)
            sb_lb, sb_ub = warp_mod.remap_search_box(
                logger.trinfo, trinfo_new, run.sb.lb, run.sb.ub, seed_w + 1)
        with tracing.span("transform"):
            logger.retransform(trinfo_new)
            run.vp, run.hyp_warm = warp_mod.warp_gp_and_vp(
                trinfo_new, run.vp, run.gp, run.cfg,
                temperature=opt.temperature)
        # The rotated space is unbounded; hard bounds are checked in
        # original coordinates (`warp_input_vbmc.m:132-148`).
        run.sb = SearchBounds(lb=sb_lb, ub=sb_ub,
                              lb_hard=np.full(opt.D, -np.inf),
                              ub_hard=np.full(opt.D, np.inf))
        vars(state).update(dict.fromkeys(_WARPED_STATE))
        state.warping_count += 1
        state.last_warping = state.last_successful_warping = it
        run.warps_made += 1
        run.notes.append("rotoscale")
        if not opt.warp_undo_check:
            return

        run.gp, gpinfo = _train_gp(run, hyp0=run.hyp_warm)
        fit = _fit_vp(run, run.vp, run.gp, state.vp_K,
                      int(math.ceil(opt.evalopt("ns_elbo", state.vp_K))),
                      opt.elbo_starts)
        if (fit.elbo < run.elbo + opt.warp_tol_improvement
                or fit.elbo_sd > (run.elbo_sd * opt.warp_tol_sd_multiplier
                                  + opt.warp_tol_sd_base)):
            run.restore(before)
            state.last_successful_warping = -math.inf
            state.warping_count += 1  # a failed warp counts twice
            run.warps_undone += 1
            run.notes.append("undo")
        else:
            run.vp = fit.vp
            state.vp_K = int(to_np(run.vp.kmask).sum())
            run.hyp_warm = gpinfo["hyp_full"]
            state.recompute_var_post = True


def active_sampling(run: _Run):
    """Active sampling (`activesample_vbmc.m`): the initial design at the
    first iteration, then ``fun_evals_per_iter`` points by one acquisition
    (the hedge's choice, or one drawn from the list); near the end of
    warm-up or on unstable runs with a full update after each point
    (noisy-target default, `activesample_vbmc.m:46-76`)."""
    opt, state, stats, logger = run.opt, run.state, run.stats, run.logger
    with tracing.span("active_sampling"):
        if state.skip_active_sampling:
            state.skip_active_sampling = False
            return
        if run.gp is None:
            cache_t, _ = initial_design(
                run.gen, logger, opt.fun_eval_start, run.plb_t, run.pub_t,
                x0_cache=direct_np(logger.trinfo, run.x0),
                fvals_cache=(np.asarray(opt.fvals, float)
                             if opt.fvals is not None else None),
                init_design=opt.init_design)
            if len(cache_t):
                run.search_cache = inverse_np(logger.trinfo, cache_t)
            return
        if run.hedge is not None:
            acq_name = run.hedge.choose(run.rng)
        else:
            acq_name = run.acq_names[int(run.rng.integers(
                len(run.acq_names)))]
        rindex_prev = stats.last.rindex if len(stats) else math.inf
        quick_updater = None
        if ((opt.active_sample_gp_update or opt.active_sample_vp_update)
                and ((state.iter - opt.active_sample_full_update_past_warmup)
                     <= state.last_warmup
                     or rindex_prev
                     > opt.active_sample_full_update_threshold)):
            quick_updater = QuickUpdater(
                run.cfg, opt, _gp_train_options(run), run.plb_t, run.pub_t,
                warmup=state.warmup, entropy_switch=state.entropy_switch,
                K=state.vp_K, do_gp=bool(opt.active_sample_gp_update),
                do_vp=bool(opt.active_sample_vp_update),
                noise_shaping=run.shaping)
        # The GP smoothing bandwidth (`setupvars_vbmc.m:247`: in units of
        # the plausible box), applied as in `acqwrapper_vbmc.m:12-15`.
        delta = (opt.bandwidth * (run.pub_t - run.plb_t)
                 if opt.bandwidth > 0 else None)
        run.gp, run.vp = active_sample(
            run.gen, run.cfg, logger, opt.fun_evals_per_iter, run.vp, run.gp,
            run.sb, opt, acq_name=acq_name, quick_updater=quick_updater,
            delta_smoothing=delta, optim_state=state,
            search_cache=(direct_np(logger.trinfo, run.search_cache)
                          if run.search_cache is not None else None))
        if quick_updater is not None:
            run.quick_updates += quick_updater.updates


def gp_train(run: _Run) -> dict:
    """GP training (`gptrain_vbmc.m`). Returns `train_gp`'s info."""
    with tracing.span("gp_train"):
        run.gp, gpinfo = _train_gp(run)
        run.hyp_warm = gpinfo["hyp_full"]
        _update_hyp_runcov(run.state, gpinfo["hyp_full"], run.opt)
    return gpinfo


def variational_fit(run: _Run):
    """Variational optimization (`vpoptimize_vbmc.m`) at the mixture size
    of `update_K`. Returns `vpoptimize`'s result."""
    opt, state = run.opt, run.state
    with tracing.span("variational_fit"):
        K_new = st.update_K(state, run.stats, opt)
        n_fast = int(math.ceil(opt.evalopt("ns_elbo", K_new)))
        if state.recompute_var_post or opt.always_refit_var_post:
            n_slow = opt.elbo_starts
            state.recompute_var_post = False
        else:
            n_fast = int(math.ceil(n_fast * opt.ns_elbo_incr))
            n_slow = 1
        fit = _fit_vp(run, run.vp, run.gp, K_new, n_fast, n_slow)
        run.vp = fit.vp
        state.vp_K = int(to_np(run.vp.kmask).sum())
        run.elbo, run.elbo_sd = fit.elbo, fit.elbo_sd
        if opt.temperature > 1:
            # the trace and the stopping rules see the real posterior's
            # ELBO
            _, run.elbo, run.elbo_sd = vp_train2real(
                run.vp, opt.temperature, run.elbo, run.elbo_sd)
    return fit


def finalize(run: _Run, vp_old, gpinfo: dict, fit):
    """The iteration's statistics (`vbmc.m:740-800`): the posterior's move
    since ``vp_old``, the max LCB, the HPD noise and the running moments,
    recorded with the timer of the spans closed since the last record."""
    opt, state, logger, vp, gp = run.opt, run.state, run.logger, run.vp, \
        run.gp
    with tracing.span("finalize"):
        with torch.no_grad():
            kld = to_np(vp_kldiv(vp, vp_old, n_samples=10 ** 5,
                                 gauss_flag=opt.kl_gauss, gen=run.gen))
            mu_t, cov_t = (to_np(a) for a in vp_moments(vp, orig_flag=False))
            sKL_true = None
            if opt.true_mean is not None and opt.true_cov is not None:
                tm, tc = vp_moments(vp, orig_flag=True, n_samples=10 ** 5,
                                    gen=run.gen)
                kl1, kl2 = mvn_kl(tm, tc, torch.as_tensor(
                    np.asarray(opt.true_mean, float), device=run.device,
                    dtype=tm.dtype), torch.as_tensor(
                    np.asarray(opt.true_cov, float), device=run.device,
                    dtype=tm.dtype))
                sKL_true = 0.5 * float(kl1 + kl2)
        fbar, vtot = _predict_padded(run.cfg, gp, logger.training_data()[0])
        sKL = max(0.0, 0.5 * float(np.sum(kld)))
        lcbmax = float(np.max(fbar - opt.elcbo_impro_weight
                              * np.sqrt(np.maximum(vtot, 0.0))))
        state.sn2hpd = _estimate_sn2hpd(gp, logger, to_np(gp.sn2))
        if state.run_mean is None:
            state.run_mean, state.run_cov = mu_t, cov_t
        else:
            w_run = opt.moments_run_weight ** (logger.n_train
                                               - state.last_run_avg)
            state.run_mean = w_run * state.run_mean + (1 - w_run) * mu_t
            state.run_cov = w_run * state.run_cov + (1 - w_run) * cov_t
        state.last_run_avg = logger.n_train

    run.stats.add(st.IterStats(
        iter=state.iter, elbo=run.elbo, elbo_sd=run.elbo_sd, sKL=sKL,
        sKL_true=sKL_true, K=state.vp_K, N=logger.n_train, neff=logger.neff,
        func_count=logger.func_count, warmup=state.warmup,
        pruned=fit.pruned, varss=fit.varss, lcbmax=lcbmax, vp=vp, gp=gp,
        gp_hyp=to_np(gp.hyp)[to_np(gp.hyp_mask).astype(bool)],
        gp_hyp_full=gpinfo["hyp_full"], gp_ns=gpinfo["ns_samples"],
        timer={k: round(v, 4)
               for k, v in _with_phases(run.tracer.rollup()).items()}))


def termination(run: _Run):
    """The stopping rules and the end of warm-up (`vbmc_termination.m`,
    `vbmc_warmup.m`), the output warp's threshold and the hedge's
    reward."""
    opt, state, stats, logger = run.opt, run.state, run.stats, run.logger
    with tracing.span("termination"):
        stats.last.t_algoperfuneval = st.update_cost_model(state, stats)
        run.is_finished, run.exitflag, run.msg, t_notes = \
            st.check_termination(state, stats, opt, logger.func_count)
        run.notes += t_notes
        if state.warmup and state.iter > 1:
            if opt.recompute_lcb_max:
                state.lcbmax_vec = _recompute_lcbmax(run.cfg, run.gp, logger,
                                                     stats, opt)
            w_notes, trim_flag = st.check_warmup(state, stats, opt, logger)
            run.notes += w_notes
            if trim_flag:
                run.gp = gp_reupdate(run.cfg, run.gp, logger)
            if not state.warmup:
                state.hyp_runcov = None
        stats.last.warmup = state.warmup

        # Fitness-shaping threshold check (vbmc.m:838-846): raise the
        # warp's threshold when the posterior's tail of low density reaches
        # too far below ymax.
        if (state.outwarp_delta is not None
                and state.R < opt.warp_tol_reliability):
            with torch.no_grad():
                Xrnd = to_np(vp_rnd(run.vp, run.gen, 2 ** 14,
                                    orig_flag=False))
            ymu, _ = _predict_padded(run.cfg, run.gp, Xrnd)
            ydelta = max(0.0, logger.ymax - float(np.quantile(ymu, 1e-3)))
            if (ydelta > state.outwarp_delta * opt.out_warp_thresh_tol
                    and state.R < 1):
                state.outwarp_delta *= opt.out_warp_thresh_mult

        # Hedge reward: ELCBO improvement over the previous iteration
        # (`vbmc.m:848-850`, `acqhedge_vbmc.m:28-56`).
        if run.hedge is not None and state.iter > 1:
            prev = stats.iterations[-2]
            impro = ((run.elbo - opt.elcbo_impro_weight * run.elbo_sd)
                     - (prev.elbo - opt.elcbo_impro_weight * prev.elbo_sd))
            run.hedge.update(impro, opt.fun_evals_per_iter)


def output_fcn(run: _Run):
    """The user's ``output_fcn``, which may stop the run, and the live plot
    (`private/vbmc_iterplot.m`); then the iteration's display line."""
    opt, state, logger = run.opt, run.state, run.logger
    with tracing.span("output_fcn"):
        if opt.output_fcn is not None:
            stop_req = opt.output_fcn(dict(
                iteration=state.iter, elbo=run.elbo, elbo_sd=run.elbo_sd,
                sKL=run.stats.last.sKL, K=state.vp_K, rindex=state.R,
                func_count=logger.func_count, vp=run.vp,
                warmup=state.warmup, timer=run.stats.last.timer))
            if stop_req:
                run.is_finished = True
                run.msg = run.msg or "Inference stopped by the user OutputFcn."

        # A failed plot turns plotting off with a warning, as in the
        # reference.
        if run.plot:
            from vbmc_tpu_torch.plotting import iteration_plot
            try:
                iteration_plot(run.stats, run.vp, logger)
            except Exception as e:
                import warnings
                warnings.warn(f"iteration plot disabled: {e!r}")
                run.plot = False

    if opt.display == "iter":
        print(f" {state.iter:9d} {logger.func_count:8d} {run.elbo:14.2f} "
              f"{run.elbo_sd:13.2f} {run.stats.last.sKL:15.2f} "
              f"{state.vp_K:6d} {state.R:12.3g}     {', '.join(run.notes)}")


def final_boost(run: _Run) -> VBMCResult:
    """The best iteration's posterior, boosted to ``min_final_components``
    (`misc/finalboost_vbmc.m`) and, for a run that did not converge, the
    retry from it (`vbmc.m:968-1009`). Returns the call's result."""
    opt, stats = run.opt, run.stats
    with tracing.span("final_boost"):
        idx_best = st.best_iteration(stats, safe_sd=opt.best_safe_sd,
                                     frac_back=opt.best_frac_back,
                                     rank_criterion=opt.rank_criterion)
        best = stats.iterations[idx_best]
        vp_fit, elbo, elbo_sd = best.vp, best.elbo, best.elbo_sd
        # with the GP of the best iteration (`finalboost_vbmc.m:36`)
        K_best = int(to_np(best.vp.kmask).sum())
        K_boost = max(opt.min_final_components, K_best)
        if K_best < K_boost:
            res_boost = _fit_vp(
                run, best.vp, best.gp or run.gp, K_boost,
                int(math.ceil(opt.evalopt("ns_elbo", K_boost)
                              * opt.ns_elbo_incr)), 1, warmup=False,
                n_ent=opt.evalopt("ns_ent_boost", K_boost),
                n_ent_fine=opt.evalopt("ns_ent_fine_boost", K_boost),
                n_ent_fast=opt.evalopt("ns_ent_fast_boost", K_boost),
                prune=False)
            vp_fit, elbo, elbo_sd = res_boost.vp, res_boost.elbo, \
                res_boost.elbo_sd
        vp = vp_fit
        if opt.temperature > 1:
            # Into real space once: the boost's ELBO is the tempered
            # posterior's, a stored one is the real posterior's already.
            vp, elbo_real, sd_real = vp_train2real(vp_fit, opt.temperature,
                                                   elbo, elbo_sd)
            if K_best < K_boost:
                elbo, elbo_sd = elbo_real, sd_real

        convergence = "probable" if best.stable else "no"
        if run.exitflag == 0 and not best.stable:
            run.msg = run.msg or ("Inference terminated without reaching "
                                  "stability; examine the run diagnostics.")
        if opt.display in ("iter", "final"):
            print(run.msg)
            print(f"Estimated ELBO: {float(elbo):.3f} +/- "
                  f"{float(elbo_sd):.3f} [{convergence} convergence, "
                  f"{run.logger.func_count} fcn evals]")
        res2 = _retry(run, vp_fit, elbo, elbo_sd)
        if res2 is not None:
            return res2

    timers = _with_phases(run.tracer.totals())
    timers["total"] = time.monotonic() - run.t0
    overhead = (timers["total"] / run.logger.total_fun_eval_time - 1.0
                if run.logger.total_fun_eval_time > 0 else float("inf"))
    return VBMCResult(
        vp=vp, elbo=float(elbo), elbo_sd=float(elbo_sd),
        exitflag=run.exitflag, message=run.msg, stats=stats,
        optim_state=run.state, logger=run.logger, vp_train=best.vp,
        func_count=run.logger.func_count, iterations=len(stats),
        convergence_status=convergence, idx_best=idx_best, timers=timers,
        overhead=overhead, warps_made=run.warps_made,
        warps_undone=run.warps_undone, quick_updates=run.quick_updates,
        spans=run.tracer.log)


def _retry(run: _Run, vp_fit, elbo, elbo_sd) -> Optional[VBMCResult]:
    """Automatic retry from the best posterior (`vbmc.m:968-1009`), on the
    same device and dtype, warm-started from the training-space VP; its
    result, when `vbmc`'s rule picks it, else None.

    Unlike the reference (`vbmc_tpu/main.py:908-917`) no `except` keeps the
    first result when the second run fails: a failure there raises (ROADMAP
    Queue 3 u). Both ELBOs it compares are the real posterior's; the
    reference converts a tempered run's ELBO after the retry, and twice
    when no boost ran (ROADMAP Queue 3 aa)."""
    opt = run.opt
    if run.exitflag >= 1 or opt.retry_max_fun_evals <= 0:
        return None
    if opt.display == "iter":
        print("Attempting a second inference run from the current "
              "posterior.")
    retry_user = dataclasses.replace(
        run.options, max_fun_evals=opt.retry_max_fun_evals,
        retry_max_fun_evals=0, seed=opt.seed + 1)
    res2 = vbmc(run.fun, vp_fit, run.lb, run.ub, None, None,
                options=retry_user, device=run.device, dtype=run.dtype)
    if res2.exitflag >= 1 or (
            res2.elbo - opt.best_safe_sd * res2.elbo_sd
            > elbo - opt.best_safe_sd * elbo_sd):
        res2.timers["first_run"] = time.monotonic() - run.t0
        return res2
    return None


def vbmc_sweep(fun, x0=None, lb=None, ub=None, plb=None, pub=None,
               options: Optional[VBMCOptions] = None, n_runs: int = 3,
               dispatch: str = "local", *, device="cuda",
               dtype=torch.float64, **dispatch_kwargs):
    """Multi-run validation sweep (the `vbmc_diagnostics` workflow): run VBMC
    ``n_runs`` times with seeds ``options.seed + 1000 i`` and cross-check
    the runs, each on ``device`` in ``dtype``.

    dispatch="local": the runs one after the other in this process; returns
    (DiagnosticsResult, [VBMCResult, ...]).
    dispatch="subprocess": each run in a worker process of its own
    (`parallel/launch.py`; ``launcher``, ``env_per_run``, ``timeout``,
    ``workdir`` and ``python`` go to `dispatch_runs`). The target and any
    callable option must be picklable. Returns (DiagnosticsResult,
    [(vp, elbo, elbo_sd, meta), ...]).
    """
    from vbmc_tpu_torch.diagnostics import vbmc_diagnostics

    if options is None:
        options = VBMCOptions()
    if dispatch == "subprocess":
        from vbmc_tpu_torch.parallel.launch import dispatch_runs
        return dispatch_runs(fun, x0, lb, ub, plb, pub, options=options,
                             n_runs=n_runs, device=device, dtype=dtype,
                             **dispatch_kwargs)
    results = []
    for i in range(n_runs):
        opts_i = dataclasses.replace(options, seed=options.seed + 1000 * i)
        results.append(vbmc(fun, x0, lb, ub, plb, pub, options=opts_i,
                            device=device, dtype=dtype))
    return vbmc_diagnostics(results), results
