"""Per-point full update of active sampling on noisy targets (cf.
`vbmc_tpu/quick_update.py`, `activesample_vbmc.m:46-76, 429-490`).

After each acquired point (but the last) of an iteration near the end of
warm-up or on an unstable run, the GP hyperparameters are re-trained and
the variational posterior re-fitted with the reference's looser
in-iteration tolerances: a short MAP polish and sampler chains started at
the previous hyperparameter samples (the posterior moved by one data
point), then a jitter sieve around the current VP and one Adam (or
L-BFGS) run at the active-sampling entropy sample counts, and an ELCBO
pick between the optimiser's candidates (`vpoptimize_vbmc.m:103-190`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vbmc_tpu_torch import elbo as eb
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import (TrainOptions, assemble_hyp_prior,
                                   hyp_sampler_for, map_sample_assemble_core,
                                   sampler_widths)
from vbmc_tpu_torch.gp.gp import GP, build_gp, pad_training_data
from vbmc_tpu_torch.optim import fminadam, minimize_lbfgs_bounded, \
    value_and_grad
from vbmc_tpu_torch.tracing import span
from vbmc_tpu_torch.utils.math import bucket_ns, to_np
from vbmc_tpu_torch.vp import VariationalPosterior
from vbmc_tpu_torch.vpoptim import _bucket_ent

_N_JITTER = 4


def _sample_chunks(sb: int) -> int:
    """Chains of the warm sampler: at most 8, dividing the buffer."""
    C = max(min(8, sb), 1)
    while sb % C != 0:
        C -= 1
    return C


class QuickUpdater:
    """Per-point update for one `active_sample` call: assembles the padded
    training data, hyperprior and sampler schedule, then re-trains the GP
    and re-fits the VP. Built by the orchestrator, called after each
    acquired point except the last."""

    def __init__(self, cfg: GPConfig, options, topts: TrainOptions,
                 plb_t, pub_t, *, warmup: bool, entropy_switch: bool,
                 K: int, do_gp: bool, do_vp: bool, noise_shaping=None):
        self.cfg = cfg
        self.options = options
        self.topts = topts
        self.plb_t = np.asarray(plb_t)
        self.pub_t = np.asarray(pub_t)
        self.noise_shaping = noise_shaping
        self.do_gp = do_gp
        self.do_vp = do_vp
        self.K = K

        o = options
        opt_weights = (not warmup) and o.variable_weights
        self.flags = eb.VPFlags(opt_mu=(o.variable_means if not warmup
                                        else True),
                                opt_sigma=True, opt_lambda=True,
                                opt_weights=opt_weights)

        def per_k(name):
            return _bucket_ent(int(math.ceil(o.evalopt(name, K) / K)))

        self.ns_ent_k = 0 if (entropy_switch or K == 1) else \
            per_k("ns_ent_active")
        self.ns_fine_k = 0 if entropy_switch else per_k("ns_ent_fine_active")
        self.ns_fast_k = 0 if (entropy_switch or K == 1) else \
            per_k("ns_ent_fast_active")
        self.adam_iters = (int(min(o.max_iter_stochastic, 10000))
                           if self.ns_ent_k > 0 else o.lbfgs_iters)
        self.use_midpoint = bool(o.elcbo_midpoint) and self.ns_ent_k > 0
        step_min = min(o.sgd_step_size, 0.001)
        if warmup or not opt_weights:
            step_max = min(0.1, o.sgd_step_size * 10)
        else:
            step_max = min(0.1, o.sgd_step_size)
        self.step_min = step_min
        self.step_max = max(step_min, step_max)
        self.updates = 0

    def __call__(self, gen: torch.Generator, logger, gp: GP,
                 vp: VariationalPosterior):
        """Returns (gp, vp, gp_length_scale (D,))."""
        cfg, topts, o = self.cfg, self.topts, self.options
        dev, dt = gp.X.device, gp.X.dtype

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev,
                                   dtype=dt)

        X, y, s2 = logger.training_data(
            noise_shaping=self.noise_shaping,
            options=o if self.noise_shaping is not None else None)
        Xp, yp, s2p, mask = pad_training_data(X, y, s2, device=dev, dtype=dt)

        prior, _ = assemble_hyp_prior(cfg, X, y, self.plb_t, self.pub_t,
                                      topts, device=dev, dtype=dt)
        ns = max(int(topts.ns_samples), 1)
        # The sample buffer follows the bucketed sample count, so the
        # sampler may change between calls (ROADMAP Queue 3 e).
        sb = bucket_ns(ns)
        plb_np, pub_np = prior.host_box[2:]
        widths = sampler_widths(prior, topts, np.maximum(pub_np - plb_np,
                                                         1e-3))
        C = _sample_chunks(sb)
        burn = max((topts.thin * 3) // C, topts.thin)

        hyp_prev = gp.hyp
        if hyp_prev.shape[0] != sb:
            hp = to_np(gp.hyp)
            reps = int(np.ceil(sb / hp.shape[0]))
            hyp_prev = t(np.tile(hp, (reps, 1))[:sb])

        self.updates += 1
        return _quick_full_update(self, gen, Xp, yp, s2p, mask, prior,
                                  hyp_prev, t(widths), ns, burn, vp)


def _quick_full_update(upd: QuickUpdater, gen: torch.Generator, Xp, yp, s2p,
                       mask, prior, hyp_prev, widths, ns: int, burn: int,
                       vp: VariationalPosterior):
    """One in-iteration full update of the updater ``upd``. The GP: a short
    MAP polish and sampler chains started at the previous samples
    ``hyp_prev`` (sb, nhyp), then the posterior factorisation. The VP: a
    jitter sieve around the current VP (candidate 0 is the VP itself; the
    others are `vbinit_vbmc.m:111-125` type-1 jitters), one slow
    optimisation from the best, and an ELCBO pick.
    Returns (gp, vp, gp_length_scale (D,))."""
    cfg, o, flags, K = upd.cfg, upd.options, upd.flags, upd.K
    dt, dev = Xp.dtype, Xp.device
    sb = hyp_prev.shape[0]
    with torch.no_grad():
        if upd.do_gp:
            C = _sample_chunks(sb)
            sampler = hyp_sampler_for(cfg, sb)
            starts = hyp_prev if sampler == "ensemble" else hyp_prev[:C]
            buf, hyp_mask, _, _ = map_sample_assemble_core(
                cfg, gen, hyp_prev[:1], starts, widths, prior, Xp, yp, s2p,
                mask, ns, burn, upd.topts.thin, sb // C, True,
                min(upd.topts.lbfgs_iters, 30), sampler=sampler)
        else:
            buf = hyp_prev
            hyp_mask = torch.arange(sb, device=dev) < ns
        with span("build"):
            gp = build_gp(cfg, Xp, yp, s2p, mask, buf, hyp_mask)
            hm = hyp_mask.to(dt)
            gls = torch.exp((buf[:, :cfg.D] * hm[:, None]).sum(0)
                            / hm.sum().clamp_min(1.0))
    if not upd.do_vp:
        return gp, vp, gls

    K_max, D = vp.mu.shape
    km = vp.kmask.to(dt)
    tmpl = (vp.mu, vp.sigma, vp.lam, vp.w, vp.kmask)
    beta = o.elcbo_weight

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    with span("sieve"):
        bnd = eb.compute_vp_bounds(gp, o, K)
        J = _N_JITTER
        scale = (torch.arange(J, device=dev) > 0).to(dt)
        mu = vp.mu[None] + scale[:, None, None] * vp.sigma[None, :, None] \
            * vp.lam[None, None, :] * randn(J, K_max, D)
        sigma = vp.sigma[None] * torch.exp(0.2 * scale[:, None]
                                           * randn(J, K_max))
        lam = vp.lam[None] * torch.exp(0.2 * scale[:, None] * randn(J, D))
        w = vp.w[None].expand(J, K_max)
        if flags.opt_weights:
            w = w * torch.exp(0.2 * scale[:, None] * randn(J, K_max)) * km
            w = w / w.sum(1, keepdim=True).clamp_min(1e-30)
        eta = torch.where(vp.kmask, torch.log(w.clamp_min(1e-30)), -40.0)
        thetas = eb.pack_theta(flags, mu, sigma, lam, eta)
        with torch.no_grad():
            Fs, _ = eb.negelcbo(cfg, thetas, gp, *tmpl, flags, 0.0,
                                upd.ns_fast_k, 0, gen, bnd=bnd,
                                use_bounds=True)
        best = torch.argmin(torch.where(torch.isfinite(Fs), Fs, torch.inf))
        theta0 = thetas[best][None]

    with span("optimize"):
        if upd.ns_ent_k > 0:
            def f_vg(th, _it):
                def f(x):
                    F, _ = eb.negelcbo(cfg, x, gp, *tmpl, flags, beta,
                                       upd.ns_ent_k, 0, gen, bnd=bnd,
                                       use_bounds=True)
                    return F
                return value_and_grad(f, th)

            res = fminadam(f_vg, theta0, tol_fun=o.tol_fun_stochastic,
                           maxiter=upd.adam_iters,
                           step_min=upd.step_min, step_max=upd.step_max)
            cands = res.x
            if upd.use_midpoint:
                # ELCBO-midpoint selection (`vpoptimize_vbmc.m:103-136`).
                T = res.f_trace.shape[1]
                masked = torch.where(torch.arange(T, device=dev)[None, :]
                                     < res.n_iters[:, None], res.f_trace,
                                     torch.inf)
                cands = torch.cat([res.x_trace[0, masked[0].argmin()][None],
                                   res.x])
        else:
            def obj(x):
                F, _ = eb.negelcbo(cfg, x, gp, *tmpl, flags, beta, 0, 0, gen,
                                   bnd=bnd, use_bounds=True)
                return F
            inf = torch.full_like(theta0[0], math.inf)
            cands, _ = minimize_lbfgs_bounded(obj, theta0, -inf, inf,
                                              maxiter=upd.adam_iters)

    with span("pick"):
        with torch.no_grad():
            sts = eb.elbo_stats(cfg, cands, gp, *tmpl, flags,
                                upd.ns_fine_k, 1, gen)
        score = -sts["elbo"] + beta * torch.sqrt(sts["varF"].clamp_min(0.0))
        j = torch.argmin(torch.where(torch.isfinite(score), score,
                                     torch.inf))
        w_new = sts["w"][j] * km
        w_new = w_new / w_new.sum().clamp_min(1e-30)
        vp_new = vp.replace(
            mu=sts["mu"][j].contiguous(), sigma=sts["sigma"][j].contiguous(),
            lam=sts["lam"][j].contiguous(), w=w_new,
            eta=torch.where(vp.kmask, torch.log(w_new.clamp_min(1e-30)),
                            -40.0))
    return gp, vp_new, gls
