"""Run state, per-iteration statistics, and the orchestration controllers:
termination (`private/vbmc_termination.m`), warmup end
(`private/vbmc_warmup.m`), mixture-size schedule (`private/updateK.m`), and
best-iteration selection (`misc/best_vbmc.m`). All host-side control logic
operating on scalar summaries. A copy of `vbmc_tpu/state.py`, unchanged in
behaviour; the port imports nothing of that package."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class IterStats:
    """Per-iteration record (cf. `vbmc.m:1021-1053` savestats)."""
    iter: int
    elbo: float
    elbo_sd: float
    sKL: float
    sKL_true: Optional[float]
    K: int
    N: int
    neff: float
    func_count: int
    warmup: bool
    pruned: int
    varss: float
    rindex: float = math.inf
    elcbo_impro: float = math.nan
    stable: bool = False
    lcbmax: float = -math.inf
    vp: object = None
    # The iteration's trained GP (cf. `stats.gp`, `vbmc.m:1043-1044`). The
    # final boost MUST pair the best iteration's vp with the GP of that SAME
    # iteration (`finalboost_vbmc.m:36`): after an input warp they live in a
    # different transformed space than the current GP. Every fit and
    # update returns a new GP object, so the one kept here stays as it was;
    # N stays <= a few hundred.
    gp: object = None
    gp_hyp: Optional[np.ndarray] = None      # (S, Nhyp) hyp samples
    gp_hyp_full: Optional[np.ndarray] = None  # pre-thin samples
    gp_ns: int = 0
    timer: dict = dataclasses.field(default_factory=dict)
    t_algoperfuneval: float = math.nan


@dataclasses.dataclass
class Stats:
    iterations: List[IterStats] = dataclasses.field(default_factory=list)

    def __len__(self):
        return len(self.iterations)

    def add(self, it: IterStats):
        self.iterations.append(it)

    def series(self, name):
        return np.asarray([getattr(it, name) for it in self.iterations])

    @property
    def last(self) -> IterStats:
        return self.iterations[-1]


@dataclasses.dataclass
class OptimState:
    """Mutable algorithm state (cf. `misc/setupvars_vbmc.m:144-307`)."""
    iter: int = 0
    warmup: bool = True
    last_warmup: float = math.inf
    warmup_stable_count: int = 0
    data_trim_list: List[int] = dataclasses.field(default_factory=list)
    stop_sampling: float = 0.0
    recompute_var_post: bool = True
    entropy_switch: bool = False
    R: float = math.inf
    sn2hpd: float = math.inf
    vp_K: int = 2
    pruned_last: int = 0
    last_warping: float = -math.inf
    last_successful_warping: float = -math.inf
    warping_count: int = 0
    skip_active_sampling: bool = False
    run_mean: Optional[np.ndarray] = None
    run_cov: Optional[np.ndarray] = None
    last_run_avg: float = math.nan
    hyp_runcov: Optional[np.ndarray] = None
    lcbmax_vec: Optional[np.ndarray] = None
    # Fitness-shaping (output warp) threshold below ymax; None when off
    # (cf. `setupvars_vbmc.m:303-306`, adapted at `vbmc.m:838-846`).
    outwarp_delta: Optional[float] = None
    # Repeated-observation streak for noisy targets
    # (`activesample_vbmc.m:334-365`).
    repeated_obs_streak: int = 0
    # Algorithmic cost per function evaluation: per-eval overhead plus the
    # predicted marginal GP-train cost of one more training point
    # (`activesample_vbmc.m:185-204`).
    t_algoperfuneval: float = math.nan
    # Acquisition debug rows (acq name, y_new, gp fmu, gp sd at x_new),
    # populated when options.acq_debug is set
    # (`activesample_vbmc.m:403-409` acqtable).
    acqtable: List[tuple] = dataclasses.field(default_factory=list)


# ----------------------------------------------------------------------
# GP-train cost model (cf. private/activesample_vbmc.m:185-204)
# ----------------------------------------------------------------------

def update_cost_model(state: OptimState, stats: Stats) -> float:
    """Estimate the algorithmic cost per target evaluation.

    t_base is the previous iteration's total algorithmic time; the marginal
    cost of growing the training set is predicted by a log-log regression of
    recorded gp_train times against N (the reference's
    `t_algoperfuneval`). The value is recorded for observability and used by
    the repeated-observation logic; it also lets callers trade a full
    hyperparameter retrain against a cheap posterior refresh.
    """
    it = len(stats)
    if it == 0:
        return math.nan
    t = stats.last.timer
    t_base = sum(t.get(k, 0.0) for k in ("active_sampling", "gp_train",
                                         "variational_fit", "finalize"))
    neff = stats.series("neff")
    delta_neff = max(1.0, neff[-1] - neff[-2]) if it >= 2 else max(neff[0], 1.0)

    gp_diff = 0.0
    if it > 3:
        gp_times = np.asarray([s.timer.get("gp_train", np.nan)
                               for s in stats.iterations])
        N_seq = stats.series("N").astype(float)
        lo = max(it - 10, it // 2)
        xx = np.log(N_seq[lo:])
        yy = np.log(np.maximum(gp_times[lo:], 1e-6))
        good = np.isfinite(xx) & np.isfinite(yy)
        if len(np.unique(xx[good])) > 1:
            p = np.polyfit(xx[good], yy[good], 1)
            pred = np.exp(np.polyval(p, np.log([N_seq[-1], N_seq[-1] + 1])))
            gp_diff = float(pred[1] - pred[0])

    state.t_algoperfuneval = t_base / delta_neff + max(0.0, gp_diff)
    return state.t_algoperfuneval


# ----------------------------------------------------------------------
# Termination (cf. private/vbmc_termination.m)
# ----------------------------------------------------------------------

def check_termination(state: OptimState, stats: Stats, options,
                      func_count: int):
    """Compute reliability index / stability; returns
    (is_finished, exitflag, msg, action_notes)."""
    it = len(stats)
    cur = stats.last
    is_finished = False
    exitflag = 0
    msg = ""
    notes = []

    if func_count >= options.max_fun_evals:
        is_finished = True
        msg = "Inference terminated: reached maximum number of function evaluations."
    if it >= options.max_iter:
        is_finished = True
        msg = "Inference terminated: reached maximum number of iterations."

    if state.entropy_switch:
        tol_stable_iters = options.tol_stable_entropy_iters
    else:
        tol_stable_iters = int(math.ceil(options.tol_stable_count
                                         / options.fun_evals_per_iter))

    rindex_vec = np.full(3, np.inf)
    elcbo_impro = math.nan
    if it >= 3:
        elbo = stats.series("elbo")
        elbo_sd = stats.series("elbo_sd")
        sKL = stats.series("sKL")
        sn = math.sqrt(max(state.sn2hpd, 0.0)) if math.isfinite(state.sn2hpd) \
            else 0.0
        tol_sn = math.sqrt(sn / options.tol_sd) * options.tol_sd if sn > 0 else 0.0
        tol_sd = min(max(options.tol_sd, tol_sn), options.tol_sd * 10)

        rindex_vec[0] = abs(elbo[-1] - elbo[-2]) / tol_sd
        rindex_vec[1] = elbo_sd[-1] / tol_sd
        rindex_vec[2] = sKL[-1] / options.tol_skl

        # GP sample-variance stabilization check (termination:43-48).
        if state.stop_sampling == 0 and not state.warmup:
            varss = stats.series("varss")
            w1 = np.zeros(it); w1[-1] = 1.0
            Ns_seq = stats.series("N").astype(float)
            w2 = np.exp(-(Ns_seq[-1] - Ns_seq) / 10.0)
            w2 = w2 / w2.sum()
            w = 0.5 * w1 + 0.5 * w2
            if np.sum(w * varss) < options.tol_gp_var_mcmc:
                state.stop_sampling = stats.last.N

        # Average ELCBO improvement per function evaluation.
        idx0 = max(0, it - int(math.ceil(0.5 * tol_stable_iters)))
        xx = stats.series("func_count")[idx0:]
        yy = (elbo - options.elcbo_impro_weight * elbo_sd)[idx0:]
        if len(np.unique(xx)) > 1:
            elcbo_impro = float(np.polyfit(xx, yy, 1)[0])

    rindex = float(np.mean(rindex_vec))
    cur.rindex = rindex
    cur.elcbo_impro = elcbo_impro
    state.R = rindex

    stable = False
    if (it >= tol_stable_iters and rindex < 1.0
            and (not math.isnan(elcbo_impro))
            and elcbo_impro < options.tol_improvement):
        rr = stats.series("rindex")[it - tol_stable_iters:it - 1]
        stable_count = int(np.sum(rr < 1.0))
        need = tol_stable_iters - int(
            tol_stable_iters * options.tol_stable_excpt_frac) - 1
        if stable_count >= need:
            if state.entropy_switch and math.isfinite(options.entropy_force_switch):
                state.entropy_switch = False
                notes.append("entropy switch")
            else:
                if (it - state.last_successful_warping) >= tol_stable_iters / 3:
                    is_finished = True
                    exitflag = 1
                    msg = ("Inference terminated: variational solution "
                           "stable for options.tol_stable_count fcn evals.")
                stable = True
                notes.append("stable")
    cur.stable = stable

    if func_count < options.min_fun_evals or it < options.min_iter:
        is_finished = False

    return is_finished, exitflag, msg, notes


# ----------------------------------------------------------------------
# Warmup controller (cf. private/vbmc_warmup.m)
# ----------------------------------------------------------------------

def check_warmup(state: OptimState, stats: Stats, options, logger):
    """Decide whether warmup ends (or training data gets trimmed).
    Returns (action_notes, trim_flag)."""
    it = len(stats)
    notes = []
    trim_flag = False

    stop_thresh = options.stop_warmup_thresh * options.fun_evals_per_iter
    tol_stable_iters = int(math.ceil(options.tol_stable_warmup
                                     / options.fun_evals_per_iter))

    stable_count_flag = False
    if it > tol_stable_iters + 1:
        elbo = stats.series("elbo")
        elbo_sd = stats.series("elbo_sd")
        elcbo = elbo - options.elcbo_impro_weight * elbo_sd
        max_now = np.max(elcbo[max(3, it - tol_stable_iters):])
        max_before = np.max(elcbo[2:max(3, it - tol_stable_iters)])
        stable_count_flag = (max_now - max_before) < stop_thresh

    if state.lcbmax_vec is not None and len(state.lcbmax_vec) >= it:
        lcbmax_vec = np.asarray(state.lcbmax_vec[:it])
    else:
        lcbmax_vec = stats.series("lcbmax")

    impro_fcn = 0.0
    if options.warmup_check_max:
        idx_last = np.zeros(it, dtype=bool)
        recent = it - int(math.ceil(options.tol_stable_warmup
                                    / options.fun_evals_per_iter))
        idx_last[max(1, recent):] = True
        if idx_last.any() and (~idx_last).any():
            impro_fcn = max(0.0, float(np.max(lcbmax_vec[idx_last])
                                       - np.max(lcbmax_vec[~idx_last])))

    max_thresh = np.max(lcbmax_vec) - options.tol_improvement
    idx_1st = int(np.argmax(lcbmax_vec > max_thresh))
    pos = stats.series("func_count")[idx_1st]
    currentpos = stats.last.func_count

    last_trim = state.data_trim_list[-1] if state.data_trim_list else -math.inf
    stop_warmup = ((stable_count_flag and impro_fcn < stop_thresh)
                   or (currentpos - pos) > options.warmup_no_impro_threshold)
    stop_warmup = stop_warmup and (stats.last.N - last_trim) >= 10

    if not stop_warmup:
        return notes, trim_flag

    if (stats.last.rindex < options.stop_warmup_reliability
            or len(state.data_trim_list) >= 1):
        state.warmup = False
        notes.append("end warm-up")
        threshold = options.warmup_keep_threshold * \
            (len(state.data_trim_list) + 1)
        state.last_warmup = it
        state.last_warping = it
        state.last_successful_warping = it
    else:
        threshold = options.warmup_keep_threshold_false_alarm * \
            (len(state.data_trim_list) + 1)
        state.data_trim_list.append(stats.last.N)
        notes.append("trim data")

    # Trim training points far below the max (`vbmc_warmup:115-127`).
    n = logger.Xn
    y_orig = logger.y_orig[:n]
    ymax = np.nanmax(y_orig)
    D = logger.D
    keep = (ymax - y_orig) < threshold
    n_keep_min = D + 1
    if keep.sum() < n_keep_min:
        order = np.argsort(np.where(np.isfinite(y_orig), y_orig, -np.inf))[::-1]
        keep[order[:min(n_keep_min, n)]] = True
    logger.X_flag[:n] &= keep
    trim_flag = True

    state.skip_active_sampling = options.skip_active_sampling_after_warmup
    state.recompute_var_post = True
    return notes, trim_flag


# ----------------------------------------------------------------------
# Mixture-size schedule (cf. private/updateK.m)
# ----------------------------------------------------------------------

def update_K(state: OptimState, stats: Stats, options) -> int:
    K_new = state.vp_K
    neff = stats.last.neff if len(stats) else options.fun_eval_start
    K_max = int(math.ceil(options.evalopt("k_fun_max", neff)))
    K_bonus = int(round(options.adaptive_k))
    if state.warmup or len(stats) < 2:
        return K_new
    recent = int(math.ceil(0.5 * options.tol_stable_count
                           / options.fun_evals_per_iter))
    elbo = stats.series("elbo")[-recent:]
    elbo_sd = stats.series("elbo_sd")[-recent:]
    warm = stats.series("warmup")[-recent:]
    elcbo = elbo - options.elcbo_impro_weight * elbo_sd
    elcbo = elcbo[~warm.astype(bool)]
    if len(elcbo) == 0:
        return K_new
    elcbo[:min(2, len(elcbo))] = -np.inf
    improving = (len(elcbo) > 0 and np.isfinite(elcbo[-1])
                 and elcbo[-1] >= np.max(elcbo))
    if stats.last.pruned == 0 and improving:
        K_new += 1
    if (stats.last.rindex < 1 and not state.recompute_var_post and improving):
        pr = stats.series("pruned")[-max(1, int(math.ceil(0.5 * recent))):]
        if np.all(pr == 0):
            K_new += K_bonus
    return max(state.vp_K, min(K_new, K_max))


# ----------------------------------------------------------------------
# Best-iteration selection (cf. misc/best_vbmc.m)
# ----------------------------------------------------------------------

def best_iteration(stats: Stats, idx: Optional[int] = None,
                   safe_sd: float = 5.0, frac_back: float = 0.25,
                   rank_criterion: bool = True) -> int:
    if idx is None:
        idx = len(stats)
    if stats.iterations[idx - 1].stable:
        return idx - 1

    elbo = stats.series("elbo")[:idx]
    elbo_sd = stats.series("elbo_sd")[:idx]
    if rank_criterion:
        rank = np.zeros((idx, 4))
        rank[:, 0] = np.arange(idx, 0, -1)
        elcbo = elbo - safe_sd * elbo_sd
        order = np.argsort(-elcbo)
        rank[order, 1] = np.arange(1, idx + 1)
        order = np.argsort(stats.series("rindex")[:idx])
        rank[order, 2] = np.arange(1, idx + 1)
        rank[:, 3] = idx
        stable = stats.series("stable")[:idx].astype(bool)
        rank[stable, 3] = 1
        return int(np.argmin(rank.sum(1)))
    stable = stats.series("stable")[:idx].astype(bool)
    where_stable = np.where(stable)[0]
    if where_stable.size:
        idx_start = int(where_stable[-1])
    else:
        idx_start = max(0, idx - int(math.ceil(idx * frac_back)))
    elcbo = elbo - safe_sd * elbo_sd
    return idx_start + int(np.argmax(elcbo[idx_start:idx]))
