"""Variational posterior optimisation (cf. `vbmc_tpu/vpoptim.py`,
`misc/vpoptimize_vbmc.m`): candidate generation (vbinit), the sieve (one
batch of cheap ELCBO evaluations), L-BFGS on the entropy lower bound or
Adam on the Monte Carlo entropy over a batch of starts, precise
re-evaluation, and greedy weight pruning."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch import elbo as eb
from vbmc_tpu_torch.vp import (VariationalPosterior, vp_from_np,
                               vp_log_pdf_trans, vp_rnd)
from vbmc_tpu_torch.gp.predict import gp_predict
from vbmc_tpu_torch.optim import minimize_lbfgs_bounded, fminadam, \
    value_and_grad
from vbmc_tpu_torch.tracing import span
from vbmc_tpu_torch.utils.math import bucket_k, bucket_pow2, to_np

# Bound on B*S*K*N elements of one sieve chunk (the (B, S, K, N) quadrature
# temporaries): 2^24 float64 values = 128 MB each.
_SIEVE_CHUNK_ELEMS = 2 ** 24


def _bucket_ent(n: int) -> int:
    """Per-component entropy sample counts, bucketed to powers of two."""
    return 0 if n <= 0 else bucket_pow2(n, lo=8)


def vbinit(rng: np.random.Generator, init_type: int, n_opts: int,
           vp: VariationalPosterior, K_new: int, k_max: int,
           X_star: np.ndarray, y_star: np.ndarray, opt_weights: bool):
    """``n_opts`` candidate parameter sets of K_new components
    (`misc/vbinit_vbmc.m`), host NumPy. Returns mu (n, k_max, D),
    sigma (n, k_max), lam (n, D), w (n, k_max)."""
    D = vp.D
    kmask = to_np(vp.kmask).astype(bool)
    K_old = int(kmask.sum())
    mu0 = to_np(vp.mu)[:K_old]
    sigma0 = to_np(vp.sigma)[:K_old]
    lam0 = to_np(vp.lam)
    w0 = to_np(vp.w)[:K_old]
    n_star = X_star.shape[0]
    n = n_opts

    if init_type == 1:
        # From the old parameters; new components spawn near existing ones.
        kc = min(K_old, K_new)
        mu = np.zeros((n, K_new, D))
        sigma = np.ones((n, K_new))
        w = np.full((n, K_new), 1.0 / K_new)
        mu[:, :kc] = mu0[:kc]
        sigma[:, :kc] = sigma0[:kc]
        if opt_weights:
            w[:, :kc] = w0[:kc]
        lam = np.tile(lam0, (n, 1))
        n_grow = K_new - K_old
        if n_grow > 0:
            idx = rng.integers(K_old, size=(n, n_grow))
            mu[:, K_old:] = (mu0[idx]
                             + 0.5 * sigma0[idx][:, :, None] * lam0
                             * rng.standard_normal((n, n_grow, D)))
            sigma[:, K_old:] = sigma0[idx] * np.exp(
                0.2 * rng.standard_normal((n, n_grow)))
            if opt_weights:
                for j in range(n_grow):
                    xi = 0.25 + 0.25 * rng.random(n)
                    src = w[np.arange(n), idx[:, j]]
                    w[:, K_old + j] = xi * src
                    w[np.arange(n), idx[:, j]] = (1 - xi) * src
        jitter = np.ones(n, dtype=bool)
        jitter[0] = False
    elif init_type == 2:
        # Highest-density training points as means.
        order = np.argsort(y_star)[::-1]
        idx_ord = np.resize(np.arange(min(K_new, n_star)), K_new)
        base_mu = X_star[order[idx_ord]]
        V = np.var(base_mu, axis=0) if K_new > 1 else np.var(X_star, axis=0)
        lam1 = X_star.std(axis=0, ddof=1) + 1e-12
        lam1 = lam1 * np.sqrt(D / np.sum(lam1 ** 2))
        mu = np.tile(base_mu, (n, 1, 1))
        sigma = np.sqrt(np.mean(V / lam1 ** 2) / K_new) * np.exp(
            0.2 * rng.standard_normal((n, K_new)))
        lam = np.tile(lam1, (n, 1))
        w = np.full((n, K_new), 1.0 / K_new)
        jitter = np.ones(n, dtype=bool)
        jitter[0] = False
    else:
        # Random training points as means.
        idx_ord = np.resize(np.arange(min(K_new, n_star)), K_new)
        orders = np.argsort(rng.random((n, n_star)), axis=1)
        mu = X_star[orders[:, idx_ord]]
        V = np.where(K_new > 1, np.var(mu, axis=1), np.var(X_star, axis=0))
        sigma = np.sqrt(np.mean(V, axis=1, keepdims=True) / K_new) * np.exp(
            0.2 * rng.standard_normal((n, K_new)))
        lam1 = X_star.std(axis=0, ddof=1) + 1e-12
        lam1 = lam1 * np.sqrt(D / np.sum(lam1 ** 2))
        lam = np.tile(lam1, (n, 1))
        w = np.full((n, K_new), 1.0 / K_new)
        jitter = np.ones(n, dtype=bool)

    jf = jitter.astype(float)
    mu = mu + jf[:, None, None] * sigma[:, :, None] * lam[:, None, :] * \
        rng.standard_normal((n, K_new, D))
    sigma = sigma * np.exp(0.2 * jf[:, None] * rng.standard_normal((n, K_new)))
    lam = lam * np.exp(0.2 * jf[:, None] * rng.standard_normal((n, D)))
    if opt_weights:
        w = w * np.exp(0.2 * jf[:, None] * rng.standard_normal((n, K_new)))
    w = np.maximum(w, 1e-12)
    w = w / w.sum(axis=1, keepdims=True)

    mu_c = np.zeros((n, k_max, D))
    sg_c = np.ones((n, k_max))
    w_c = np.zeros((n, k_max))
    mu_c[:, :K_new] = mu
    sg_c[:, :K_new] = np.maximum(sigma, 1e-10)
    w_c[:, :K_new] = w
    return mu_c, sg_c, np.maximum(lam, 1e-10), w_c


def _thetas_np(flags, mu_c, sg_c, lam_c, w_c, kmask_np):
    """Host-side theta packing for a batch of candidates."""
    parts = []
    if flags.opt_mu:
        parts.append(mu_c.reshape(mu_c.shape[0], -1))
    if flags.opt_sigma:
        parts.append(np.log(sg_c))
    if flags.opt_lambda:
        parts.append(np.log(lam_c))
    if flags.opt_weights:
        parts.append(np.where(kmask_np[None, :],
                              np.log(np.maximum(w_c, 1e-30)), -40.0))
    return np.concatenate(parts, axis=1)


class VPTemplate(NamedTuple):
    """Fixed (non-optimised) VP tensors threaded through the objective."""
    mu: torch.Tensor
    sigma: torch.Tensor
    lam: torch.Tensor
    w: torch.Tensor
    kmask: torch.Tensor


class VPOptimResult(NamedTuple):
    vp: VariationalPosterior
    elbo: float
    elbo_sd: float
    G: float
    H: float
    varss: float
    varG: float
    pruned: int
    I_sk: np.ndarray
    J_sjk: np.ndarray


def _sieve(cfg, thetas, gp, tmpl, flags, ns_fast_k, gen, bnd):
    """Cheap negative ELCBO of every candidate, in chunks."""
    K, D = tmpl.mu.shape
    per_row = max(gp.s_max * K * gp.n_max, 1)
    chunk = max(1, _SIEVE_CHUNK_ELEMS // per_row)
    out = []
    with torch.no_grad():
        for i in range(0, thetas.shape[0], chunk):
            F, _ = eb.negelcbo(cfg, thetas[i:i + chunk], gp, tmpl.mu,
                               tmpl.sigma, tmpl.lam, tmpl.w, tmpl.kmask,
                               flags, 0.0, ns_fast_k, 0, gen, bnd=bnd,
                               use_bounds=True)
            out.append(F)
    return torch.cat(out)


def _full_eval(cfg, thetas, gp, tmpl, flags, ns_fine_k, gen):
    with torch.no_grad():
        return eb.elbo_stats(cfg, thetas, gp, tmpl.mu, tmpl.sigma, tmpl.lam,
                             tmpl.w, tmpl.kmask, flags, ns_fine_k, 1, gen)


def _lbfgs_eval_batch(cfg, flags, theta0s, gp, tmpl, beta, bnd, gen,
                      maxiter, ns_fine_k):
    """Deterministic slow path: batched L-BFGS over the starts on the
    entropy lower bound, then the precise ELCBO of each result."""
    def obj(th):
        F, _ = eb.negelcbo(cfg, th, gp, tmpl.mu, tmpl.sigma, tmpl.lam,
                           tmpl.w, tmpl.kmask, flags, beta, 0, 0, gen,
                           bnd=bnd, use_bounds=True)
        return F
    inf = torch.full_like(theta0s[0], math.inf)
    thetas, _ = minimize_lbfgs_bounded(obj, theta0s, -inf, inf,
                                       maxiter=maxiter)
    return _full_eval(cfg, thetas, gp, tmpl, flags, ns_fine_k, gen), thetas


def _adam_eval_batch(cfg, flags, theta0s, gp, tmpl, beta, bnd, gen,
                     ns_ent_k, maxiter, step_min, step_max, tol_fun,
                     use_midpoint, ns_fine_k):
    """Stochastic slow path: batched Adam on the MC-entropy ELCBO, the
    ELCBO-midpoint candidates (`vpoptimize_vbmc.m:103-136`), then the
    precise ELCBO of each candidate."""
    def f_vg(th, _it):
        def f(t):
            F, _ = eb.negelcbo(cfg, t, gp, tmpl.mu, tmpl.sigma, tmpl.lam,
                               tmpl.w, tmpl.kmask, flags, beta, ns_ent_k, 0,
                               gen, bnd=bnd, use_bounds=True)
            return F
        return value_and_grad(f, th)

    res = fminadam(f_vg, theta0s, tol_fun=tol_fun, maxiter=maxiter,
                   step_min=step_min, step_max=step_max)
    if use_midpoint:
        T = res.f_trace.shape[1]
        masked = torch.where(torch.arange(T, device=theta0s.device)[None, :]
                             < res.n_iters[:, None], res.f_trace, torch.inf)
        best_t = masked.argmin(1)
        xmid = res.x_trace[torch.arange(theta0s.shape[0]), best_t]
        # Interleave [mid_i, final_i].
        mids = torch.stack([xmid, res.x], dim=1).reshape(-1, res.x.shape[-1])
    else:
        mids = res.x
    return _full_eval(cfg, mids, gp, tmpl, flags, ns_fine_k, gen), mids


def _prune_eval_batch(cfg, gp, mu, sigma, lam, w, kmask, idxs, flags,
                      ns_fine_k, gen):
    """ELBO stats of a batch of candidate single-component removals."""
    P = len(idxs)
    K = kmask.shape[0]
    ar = torch.arange(K, device=kmask.device)
    kmask_try = kmask[None, :] & (ar[None, :] != torch.as_tensor(
        idxs, device=kmask.device)[:, None])                   # (P, K)
    w_try = w[None, :] * kmask_try.to(w.dtype)
    w_try = w_try / w_try.sum(1, keepdim=True).clamp_min(1e-30)
    out = []
    with torch.no_grad():
        for j in range(P):  # each removal has its own component mask
            eta = torch.where(kmask_try[j], torch.log(
                w_try[j].clamp_min(1e-30)), -40.0)
            th = eb.pack_theta(flags, mu[None], sigma[None], lam[None],
                               eta[None])
            out.append(eb.elbo_stats(cfg, th, gp, mu, sigma, lam, w_try[j],
                                     kmask_try[j], flags, ns_fine_k, 1, gen))
    return {k: torch.cat([o[k] for o in out]) for k in out[0]}


def vpoptimize(gen: torch.Generator, cfg: GPConfig, vp: VariationalPosterior,
               gp: GP, K_new: int, options, *, warmup: bool,
               entropy_switch: bool, n_fast_opts: int, n_slow_opts: int,
               n_ent=None, n_ent_fine=None, n_ent_fast=None,
               prune: bool = True,
               host_seed: Optional[int] = None) -> VPOptimResult:
    """Optimise the variational posterior to K_new components."""
    D = vp.D
    dev, dt = gp.X.device, gp.X.dtype
    if host_seed is None:
        host_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                      device=gen.device).item())
    rng = np.random.default_rng(host_seed)
    k_max = bucket_k(K_new)

    opt_weights = (not warmup) and options.variable_weights
    opt_mu = options.variable_means if not warmup else True
    flags = eb.VPFlags(opt_mu=opt_mu, opt_sigma=True, opt_lambda=True,
                       opt_weights=opt_weights)

    if n_ent is None:
        n_ent = options.evalopt("ns_ent", K_new)
    if n_ent_fine is None:
        n_ent_fine = options.evalopt("ns_ent_fine", K_new)
    if n_ent_fast is None:
        n_ent_fast = options.evalopt("ns_ent_fast", K_new)
    ns_ent_k = _bucket_ent(int(math.ceil(n_ent / K_new)))
    if entropy_switch or K_new == 1:
        ns_ent_k = 0
    ns_fine_k = 0 if entropy_switch else \
        _bucket_ent(int(math.ceil(n_ent_fine / K_new)))
    ns_fast_k = _bucket_ent(int(math.ceil(n_ent_fast / K_new)))
    if entropy_switch or K_new == 1:
        ns_fast_k = 0

    from vbmc_tpu_torch.gp.fit import get_hpd
    m = to_np(gp.mask).astype(bool)
    X_all = to_np(gp.X)[m]
    y_all = to_np(gp.y)[m]
    X_hpd, y_hpd = get_hpd(X_all, y_all, options.hpd_frac)
    bnd = eb.compute_vp_bounds(gp, options, K_new)
    kmask_np = np.arange(k_max) < K_new
    kmask = torch.as_tensor(kmask_np, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dt)

    if n_fast_opts > 0:
        with span("sieve"):
            n3 = int(math.ceil(n_fast_opts / 3))
            cand, types = [], []
            if n_slow_opts == 1:
                cand.append(vbinit(rng, 1, n_fast_opts, vp, K_new, k_max,
                                   X_hpd, y_hpd, opt_weights))
                types.append(np.ones(n_fast_opts, dtype=int))
            else:
                for ty, n_t in ((1, n3), (2, n3), (3, n_fast_opts - 2 * n3)):
                    if n_t <= 0:
                        continue
                    cand.append(vbinit(rng, ty, n_t, vp, K_new, k_max, X_hpd,
                                       y_hpd, opt_weights))
                    types.append(np.full(n_t, ty, dtype=int))
            mu_c, sg_c, lam_c, w_c = (np.concatenate([c[i] for c in cand])
                                      for i in range(4))
            types = np.concatenate(types)
            thetas_np = _thetas_np(flags, mu_c, sg_c, lam_c, w_c, kmask_np)
            tmpl = VPTemplate(t(mu_c[0]), t(sg_c[0]), t(lam_c[0]), t(w_c[0]),
                              kmask)
            nelcbo = to_np(_sieve(cfg, t(thetas_np), gp, tmpl, flags,
                                  ns_fast_k, gen, bnd))
            order = np.argsort(np.where(np.isfinite(nelcbo), nelcbo, np.inf),
                               kind="stable")
            thetas_np = thetas_np[order]
            types = types[order]
    else:
        mu_p = np.zeros((k_max, D))
        sg_p = np.ones(k_max)
        w_p = np.zeros(k_max)
        K_old = int(to_np(vp.kmask).sum())
        mu_p[:K_old] = to_np(vp.mu)[:K_old]
        sg_p[:K_old] = to_np(vp.sigma)[:K_old]
        w_p[:K_old] = to_np(vp.w)[:K_old]
        lam_np = to_np(vp.lam)
        thetas_np = _thetas_np(flags, mu_p[None], sg_p[None], lam_np[None],
                               w_p[None], kmask_np)
        types = np.array([1])
        tmpl = VPTemplate(t(mu_p), t(sg_p), t(lam_np), t(w_p), kmask)

    # Starts per strategy (`vpoptimize_vbmc.m`): best candidate overall for
    # one slow start; for two, the best of type 1 and the best of 2 or 3.
    taken = np.zeros(len(types), dtype=bool)

    def pick_start(i_opt):
        want = (None if n_slow_opts == 1 else
                ([1] if i_opt == 0 else [2, 3]) if n_slow_opts == 2 else
                [(i_opt % 3) + 1])
        for j in range(len(types)):
            if not taken[j] and (want is None or types[j] in want):
                taken[j] = True
                return thetas_np[j]
        for j in range(len(types)):
            if not taken[j]:
                taken[j] = True
                return thetas_np[j]
        return thetas_np[0]

    with span("optimize"):
        elcbo_beta = options.elcbo_weight
        n_opts = max(n_slow_opts, 1)
        theta0s = t(np.stack([pick_start(i) for i in range(n_opts)]))
        if ns_ent_k == 0:
            sts, mids = _lbfgs_eval_batch(cfg, flags, theta0s, gp, tmpl,
                                          elcbo_beta, bnd, gen,
                                          options.lbfgs_iters, ns_fine_k)
        else:
            step_min = min(options.sgd_step_size, 0.001)
            if warmup or not opt_weights:
                step_max = min(0.1, options.sgd_step_size * 10)
            else:
                step_max = min(0.1, options.sgd_step_size)
            step_max = max(step_min, step_max)
            sts, mids = _adam_eval_batch(
                cfg, flags, theta0s, gp, tmpl, elcbo_beta, bnd, gen, ns_ent_k,
                int(min(options.max_iter_stochastic, 10000)), step_min,
                step_max, options.tol_fun_stochastic,
                bool(options.elcbo_midpoint), ns_fine_k)
        sts = {k: to_np(v) for k, v in sts.items()}

    nelcbo_vals = [-float(sts["elbo"][j]) + elcbo_beta * math.sqrt(
        max(float(sts["varF"][j]), 0.0)) for j in range(mids.shape[0])]
    best = int(np.argmin(nelcbo_vals))
    st_cur = {k: v[best] for k, v in sts.items()}
    w_cur = st_cur["w"]
    elbo_cur = float(st_cur["elbo"])
    elbo_sd_cur = math.sqrt(max(float(st_cur["varF"]), 0.0))

    pruned = 0
    kmask_np = kmask_np.copy()
    if prune and opt_weights:
        with span("prune"):
            pruning_threshold = options.tol_improvement * options.evalopt(
                "pruning_threshold_multiplier", K_new)
            checked = np.zeros(k_max, dtype=bool)
            P = 8
            while True:
                small = np.where((w_cur < options.tol_weight) & kmask_np
                                 & ~checked)[0]
                if small.size == 0 or kmask_np.sum() <= 1:
                    break
                cands = small[:P]
                sts_p = _prune_eval_batch(
                    cfg, gp, t(st_cur["mu"]), t(st_cur["sigma"]),
                    t(st_cur["lam"]), t(w_cur),
                    torch.as_tensor(kmask_np, device=dev), list(cands), flags,
                    ns_fine_k, gen)
                sts_p = {k: to_np(v) for k, v in sts_p.items()}
                sds_p = np.sqrt(np.maximum(sts_p["varF"], 0.0))
                d_elcbo = np.abs(
                    (sts_p["elbo"] - options.elcbo_impro_weight * sds_p)
                    - (elbo_cur - options.elcbo_impro_weight * elbo_sd_cur))
                ok = d_elcbo < pruning_threshold
                if not ok.any():
                    checked[cands] = True
                    continue
                j = int(np.argmin(np.where(ok, d_elcbo, np.inf)))
                kmask_np[int(cands[j])] = False
                st_cur = {k: v[j] for k, v in sts_p.items()}
                w_cur = st_cur["w"]
                elbo_cur = float(sts_p["elbo"][j])
                elbo_sd_cur = float(sds_p[j])
                pruned += 1

    wk = w_cur * kmask_np
    vp_new = vp_from_np(
        vp.trinfo, wk / max(wk.sum(), 1e-30),
        np.where(kmask_np, np.log(np.maximum(w_cur, 1e-30)), -40.0),
        st_cur["mu"], st_cur["sigma"], st_cur["lam"], kmask_np)
    return VPOptimResult(
        vp=vp_new, elbo=elbo_cur, elbo_sd=elbo_sd_cur,
        G=float(st_cur["G"]), H=float(st_cur["H"]),
        varss=float(st_cur["varss"]), varG=float(st_cur["varF"]),
        pruned=pruned, I_sk=st_cur["I_sk"], J_sjk=st_cur["J_sjk"])


def vp_sample_theta(gen: torch.Generator, cfg: GPConfig,
                    vp: VariationalPosterior, gp: GP, n_samples: int, options,
                    *, sampler: Optional[str] = None,
                    scale_lower_bound: bool = True) -> VariationalPosterior:
    """MCMC over the variational parameters (mu, log sigma, log lambda) with
    the negative ELBO (entropy lower bound, soft bounds of ``options``) as
    minus the log density (`misc/vpsample_vbmc.m`; the off-default
    `active_variational_samples` path). Returns the VP at the chain's last
    state. ``sampler``, "mala" or "slice", defaults to
    ``options.variational_sampler``. ``scale_lower_bound`` is unused, as in
    the reference."""
    from vbmc_tpu_torch.samplers.mala import mala_sample
    from vbmc_tpu_torch.samplers.slice import slice_sample_chains

    if sampler is None:
        sampler = {"malasample": "mala", "mala": "mala",
                   "slicesample": "slice", "slice": "slice"}.get(
            getattr(options, "variational_sampler", "malasample"), "mala")
    flags = eb.VPFlags(opt_mu=True, opt_sigma=True, opt_lambda=True,
                       opt_weights=False)
    theta0 = eb.pack_theta(flags, vp.mu[None], vp.sigma[None], vp.lam[None],
                           vp.eta[None])                            # (1, P)
    bnd = eb.compute_vp_bounds(gp, options, int(to_np(vp.kmask).sum()))

    def logp(th):                                         # (B, P) -> (B,)
        F, _ = eb.negelcbo(cfg, th, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                           vp.kmask, flags, 0.0, 0, 0, bnd=bnd,
                           use_bounds=True)
        return -F

    if sampler == "mala":
        def lp_grad(th):
            v, g = value_and_grad(logp, th[None])
            return v[0], g[0]
        samples, _, _ = mala_sample(gen, lp_grad, theta0[0], n_samples,
                                    step0=0.01)
        theta_new = samples[-1]
    else:
        P = theta0.shape[1]
        inf = torch.full((P,), math.inf, dtype=theta0.dtype,
                         device=theta0.device)
        with torch.no_grad():
            buf, _ = slice_sample_chains(gen, logp, theta0,
                                         torch.full_like(inf, 0.1), -inf, inf,
                                         n_samples, 0, 1, max(n_samples, 1))
        theta_new = buf[0, n_samples - 1]
    mu, sigma, lam, _ = eb.unpack_theta(flags, theta_new[None], vp.k_max,
                                        vp.D, vp.mu, vp.sigma, vp.lam, vp.w,
                                        vp.kmask)
    return vp.replace(mu=mu[0].detach(), sigma=sigma[0].detach(),
                      lam=lam[0].detach())


def fractional_ess(gen: torch.Generator, cfg: GPConfig,
                   vp: VariationalPosterior, gp: GP,
                   n_samples: int = 100) -> float:
    """Fractional effective sample size of the VP against the GP posterior
    mean density (`misc/fess_vbmc.m`)."""
    with torch.no_grad():
        Xs = vp_rnd(vp, gen, n_samples, orig_flag=False, balance_flag=True)
        fbar, _, _, _ = gp_predict(cfg, gp, Xs)
        lnw = fbar - vp_log_pdf_trans(vp, Xs)
        lnw = lnw - torch.logsumexp(lnw, 0)
        return float(1.0 / torch.exp(2.0 * lnw).sum() / n_samples)
