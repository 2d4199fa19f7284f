"""Importance-sampling machinery of the information-based acquisitions of
noisy targets (cf. `vbmc_tpu/active_is.py`, `acq/acqviqr_vbmc.m`,
`acq/acqimiqr_vbmc.m`, `private/activeimportancesampling_vbmc.m`): the
importance-sample set, its fESS-gated independent Metropolis-Hastings
refresh, the VIQR / IMIQR evaluation, and the 2^13-candidate sweep (the
CUDA kernel on CUDA tensors); and the kernel-integral cross-covariance of
"eig" (cf. `misc/intkernel.m`)."""

from __future__ import annotations

import dataclasses
import math

import torch

from vbmc_tpu_torch import elbo
from vbmc_tpu_torch.acquisitions import (AcqState, _bound_rejection,
                                         _nearest_noise)
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.predict import gp_predict_full
from vbmc_tpu_torch.kernels import (_U_IQR, _log_sinh, kernel_supports,
                                    viqr_acq, viqr_acq_reference)
from vbmc_tpu_torch.vp import VariationalPosterior, vp_log_pdf_trans, vp_rnd


def int_kernel(cfg: GPConfig, gp: GP, vp: VariationalPosterior,
               Xs: torch.Tensor) -> torch.Tensor:
    """Posterior cross-covariance Cov(f(x_m), int q f) per hyperparameter
    sample, E_q[k(x_m, .)] - k(x_m, X) B^-1 E_q[k(X, .)]
    (`intkernel.m:55-80`): (S, M)."""
    mu, sigma, lam = vp.mu[None], vp.sigma[None], vp.lam[None]
    wk = vp.w * vp.kmask.to(vp.w.dtype)
    z = elbo._z_matrix(cfg, gp, mu, sigma, lam)[0][0]           # (S, K, N)
    zbar = torch.einsum("k,skn->sn", wk, z)
    # E_q[k(x_m, .)]: the same closed form with the candidates as X
    at_cand = dataclasses.replace(
        gp, X=Xs, mask=torch.ones(Xs.shape[0], dtype=torch.bool,
                                  device=Xs.device))
    z_cand = elbo._z_matrix(cfg, at_cand, mu, sigma, lam)[0][0]  # (S, K, M)
    Ez = torch.einsum("k,skm->sm", wk, z_cand)
    ks = kernel_cross(cfg, gp.hyp, gp.X, Xs) \
        * gp.mask.to(Xs.dtype)[None, :, None]                   # (S, N, M)
    return Ez - ((gp.Binv @ zbar[..., None]).transpose(-1, -2) @ ks)[:, 0]


@dataclasses.dataclass
class ISState:
    """Importance-sample set of VIQR / IMIQR.

    Xa: (Na, D) integration points; ln_weights: (S, Na) normalised log
    importance weights; invKzk: (S, N, Na) B^{-1} k(X, Xa) per sample;
    f_s2: (S, Na) predictive variance at Xa."""
    Xa: torch.Tensor
    ln_weights: torch.Tensor
    invKzk: torch.Tensor
    f_s2: torch.Tensor


_SCALES = (1.0, math.sqrt(2.0), 2.0)


def _mixture_log_prop(vp: VariationalPosterior, Xa, lo, hi, n_each: int,
                      n_box: int):
    """Exact log density (Na,) of the stratified proposal mixture at Xa:
    the 3 widened VPs at their draw fractions plus the box-uniform
    component (a misspecified proposal would bias the self-normalised IS
    estimator)."""
    Na = 3 * n_each + max(n_box, 1)
    comps = [math.log(n_each / Na)
             + vp_log_pdf_trans(vp.replace(sigma=vp.sigma * sc), Xa)
             for sc in _SCALES]
    in_box = ((Xa >= lo) & (Xa <= hi)).all(1)
    log_box = math.log(max(n_box, 1) / Na) - torch.log(hi - lo).sum()
    comps.append(torch.where(in_box, log_box, -math.inf))
    return torch.logsumexp(torch.stack(comps), 0)


def _mixture_draw(gen: torch.Generator, vp: VariationalPosterior, lo, hi,
                  n_each: int, n_box: int):
    """One batch from the stratified IS proposal mixture: the variational
    posterior at 3 widening scales (`ais:116-126`, balanced draws) plus
    box-uniform draws around the training inputs (`ais:138-146`). Returns
    (Xa (Na, D), log_prop (Na,))."""
    parts = [vp_rnd(vp.replace(sigma=vp.sigma * sc), gen, n_each,
                    orig_flag=False, balance_flag=True) for sc in _SCALES]
    u = torch.rand((max(n_box, 1), vp.D), generator=gen, device=lo.device,
                   dtype=lo.dtype)
    Xa = torch.cat(parts + [lo + u * (hi - lo)])
    return Xa, _mixture_log_prop(vp, Xa, lo, hi, n_each, n_box)


def build_is_state_core(gen: torch.Generator, cfg: GPConfig, acq_name: str,
                        vp: VariationalPosterior, gp: GP, n_vp: int,
                        n_box: int, n_mcmc: int, mh_steps: int = 0,
                        fess_thresh: float = 0.9) -> ISState:
    """Importance-sample set: stratified proposals around the variational
    posterior and the training inputs, weighted by the current GP.

    When the fractional ESS of retargeting the proposals to the IS base
    density (q(x) 2 sinh(u s(x)) for VIQR, exp(fmu) 2 sinh(u s) for IMIQR,
    `acqviqr_vbmc.m:22-27`) falls below ``fess_thresh``, the set is
    importance-resampled to the base density and refined by ``mh_steps``
    rounds of independent Metropolis-Hastings, each one batched GP predict
    over all Na points (`ais:37-104,153-235`); the weights then become
    log q - log base. Otherwise they stay proposal weights."""
    dt = gp.X.dtype
    big = torch.finfo(dt).max
    Xmin = torch.where(gp.mask[:, None], gp.X, big).amin(0)
    Xmax = torch.where(gp.mask[:, None], gp.X, -big).amax(0)
    diam = Xmax - Xmin
    lo, hi = Xmin - 0.5 * diam, Xmax + 0.5 * diam

    n_each = max((n_vp + n_mcmc) // 3, 1)
    Xa, log_prop = _mixture_draw(gen, vp, lo, hi, n_each, n_box)
    Na = Xa.shape[0]
    fmu, fs2 = gp_predict_full(cfg, gp, Xa)                 # (S, Na)
    hm = gp.hyp_mask.to(dt)
    ns = hm.sum().clamp_min(1.0)

    def lnbase(X, fmu_x, fs2_x):
        s2bar = (fs2_x * hm[:, None]).sum(0) / ns
        ln_sinh = math.log(2.0) + _log_sinh(
            _U_IQR * torch.sqrt(s2bar.clamp_min(1e-30)))
        if acq_name == "viqr":
            return vp_log_pdf_trans(vp, X) + ln_sinh
        return (fmu_x * hm[:, None]).sum(0) / ns + ln_sinh

    need = False
    if mh_steps > 0:
        lnb = lnbase(Xa, fmu, fs2)
        r = lnb - log_prop
        r = torch.where(torch.isfinite(r), r, -math.inf)
        lr = r - torch.logsumexp(r, 0)
        fess = 1.0 / torch.exp(2.0 * lr).sum() / Na
        need = bool(fess < fess_thresh)
    if need:
        idx = torch.multinomial(torch.softmax(r, 0), Na, replacement=True,
                                generator=gen)
        Xa, lnb, lp = Xa[idx], lnb[idx], log_prop[idx]
        fmu, fs2 = fmu[:, idx], fs2[:, idx]
        for _ in range(mh_steps):
            Y, lp_y = _mixture_draw(gen, vp, lo, hi, n_each, n_box)
            fmu_y, fs2_y = gp_predict_full(cfg, gp, Y)
            lnb_y = lnbase(Y, fmu_y, fs2_y)
            u = torch.rand(Na, generator=gen, device=Xa.device, dtype=dt)
            accept = torch.log(u) < (lnb_y - lp_y) - (lnb - lp)
            Xa = torch.where(accept[:, None], Y, Xa)
            lnb = torch.where(accept, lnb_y, lnb)
            lp = torch.where(accept, lp_y, lp)
            fmu = torch.where(accept[None, :], fmu_y, fmu)
            fs2 = torch.where(accept[None, :], fs2_y, fs2)
        # The refreshed set samples the base density.
        if acq_name == "viqr":
            lnw = (vp_log_pdf_trans(vp, Xa) - lnb)[None, :].expand_as(fmu)
        else:
            lnw = fmu - lnb[None, :]
    elif acq_name == "viqr":
        # Weights ~ q(x) / proposal; the f-dependent part enters through
        # the sinh term at evaluation time.
        lnw = (vp_log_pdf_trans(vp, Xa) - log_prop)[None, :].expand_as(fmu)
    else:
        # IMIQR: weights ~ exp(fmu) / proposal (`ais:318-323`).
        lnw = fmu - log_prop[None, :]

    lnw = torch.where(torch.isfinite(lnw), lnw, -math.inf)
    lnw = (lnw - torch.logsumexp(lnw, 1, keepdim=True)).contiguous()
    # B^{-1} k(X, Xa) per sample (ais:247-278).
    ks = kernel_cross(cfg, gp.hyp, gp.X, Xa) * gp.mask.to(dt)[None, :, None]
    return ISState(Xa=Xa.contiguous(), ln_weights=lnw,
                   invKzk=(gp.Binv @ ks).contiguous(), f_s2=fs2.contiguous())


def evaluate_is_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                            vp: VariationalPosterior, gp: GP,
                            state: AcqState, ais: ISState) -> torch.Tensor:
    """VIQR / IMIQR acquisition at candidates Xs (M, D) in plain PyTorch on
    any device (the CMA-ES refinement batches): the negative expected
    reduction of the integrated IQR (`acqviqr_vbmc.m:60-121`) in the log
    domain, with variance regularisation and hard-bound rejection. Lower
    is better."""
    acq = viqr_acq_reference(cfg, Xs, gp, ais,
                             _nearest_noise(cfg, gp, Xs, state),
                             state.tol_var, state.regularize)
    return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                            state.ub_eps_orig, acq)


def sweep_is_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                         vp: VariationalPosterior, gp: GP, state: AcqState,
                         ais: ISState) -> torch.Tensor:
    """The 2^13-candidate VIQR / IMIQR sweep. Where the GP's configuration
    is one that `kernel_supports`: the nearest-noise lookup in plain
    PyTorch, the `viqr_acq` wrapper (the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors), then the hard-bound rejection. Any other
    configuration goes to `evaluate_is_acquisition`; the choice is made
    here, before anything is launched, and a failed launch raises."""
    if not kernel_supports(cfg):
        return evaluate_is_acquisition(cfg, name, Xs, vp, gp, state, ais)
    acq = viqr_acq(cfg, Xs, gp, ais, _nearest_noise(cfg, gp, Xs, state),
                   state.tol_var, state.regularize)
    return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                            state.ub_eps_orig, acq)
