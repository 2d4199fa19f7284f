"""Acquisition functions for active sampling (cf. `vbmc_tpu/acquisitions.py`,
`acq/*.m`); lower is better.

  "prospective"      acqf_vbmc      -vtot exp(fbar - ymax) q(x)
  "prospective_sn2"  acqfsn2_vbmc   noise-corrected variant (noisy targets)
  "prospective_log"  acqflog_vbmc   log-domain variant
  "us"               acqus_vbmc     -vtot q(x)^2
  "eig"              acqeig_vbmc    expected information gain
  "viqr" / "imiqr"   importance-sampling variants (see `active_is.py`)

The 2^13-candidate sweep of "prospective" is a CUDA kernel
(`kernels.prospective_acq`) where the GP's configuration is one the kernel
computes; every other sweep, and the CMA-ES refinement batches, run
`evaluate_acquisition` in plain PyTorch on the tensors' device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.gp.predict import gp_predict, sample_summary
from vbmc_tpu_torch.gp.quad import gp_quad
from vbmc_tpu_torch.kernels import (_LOG_REALMIN, kernel_supports,
                                    prospective_acq)
from vbmc_tpu_torch.transforms import inverse
from vbmc_tpu_torch.vp import VariationalPosterior, vp_log_pdf_trans


def _info(log_flag=False, importance_sampling=False,
          compute_varlogjoint=False):
    return dict(log_flag=log_flag, importance_sampling=importance_sampling,
                compute_varlogjoint=compute_varlogjoint,
                mcmc_importance_sampling=importance_sampling)


ACQ_INFO = {
    "prospective": _info(),
    "prospective_sn2": _info(),
    "prospective_log": _info(log_flag=True),
    "us": _info(),
    "eig": _info(compute_varlogjoint=True),
    "viqr": _info(log_flag=True, importance_sampling=True),
    "imiqr": _info(log_flag=True, importance_sampling=True),
}


@dataclasses.dataclass
class AcqState:
    """State needed by acquisition evaluations."""
    ymax: torch.Tensor           # () max observed log joint (transformed)
    tol_var: torch.Tensor        # () GP variance regularisation threshold
    lb_eps_orig: torch.Tensor    # (D,) hard-bound epsilon box (original)
    ub_eps_orig: torch.Tensor    # (D,)
    regularize: bool = True
    # (D,) geometric-mean GP length scales (the nearest-noise lookup)
    gp_length_scale: Optional[torch.Tensor] = None
    # (S,) variance of the log joint per hyperparameter sample ("eig")
    var_log_joint: Optional[torch.Tensor] = None
    # (D,) bandwidth smoothing SDs, options.bandwidth (PUB - PLB), the
    # vp.delta of `acqwrapper_vbmc.m:12-15`; None when off
    delta: Optional[torch.Tensor] = None


def check_acq(name: str):
    if name not in ACQ_INFO:
        raise ValueError(f"unknown acquisition {name!r}; one of "
                         f"{sorted(ACQ_INFO)}")


def _nearest_noise(cfg: GPConfig, gp: GP, Xs: torch.Tensor,
                   state: AcqState) -> torch.Tensor:
    """Observation-noise estimate at Xs (M,) from the nearest training point
    in length-scale-rescaled coordinates (`acqfsn2_vbmc.m:9-11`)."""
    Xr = Xs / state.gp_length_scale
    Tr = gp.X / state.gp_length_scale
    d2 = ((Xr * Xr).sum(1)[:, None] + (Tr * Tr).sum(1)[None, :]
          - 2.0 * Xr @ Tr.T)
    d2 = torch.where(gp.mask[None, :], d2, torch.finfo(d2.dtype).max)
    pos = torch.argmin(d2, dim=1)
    m = gp.hyp_mask.to(gp.sn2.dtype)
    sn2_mean = (gp.sn2 * m[:, None]).sum(0) / m.sum().clamp_min(1.0)
    return sn2_mean[pos]


def _bound_rejection(trinfo, Xs, lb_eps, ub_eps, acq):
    """+inf where a candidate lies outside the hard-bound epsilon box in
    original space (`acqwrapper_vbmc.m:50-52`)."""
    X_orig = inverse(trinfo, Xs)
    out = ((X_orig < lb_eps[None, :]).any(1)
           | (X_orig > ub_eps[None, :]).any(1))
    return torch.where(out, torch.inf, acq)


def evaluate_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                         vp: VariationalPosterior, gp: GP, state: AcqState,
                         smooth: bool = False) -> torch.Tensor:
    """Batched acquisition values at candidates Xs (M, D) in plain PyTorch
    on any device, with variance regularisation
    (`acqwrapper_vbmc.m:35-45`) and hard-bound rejection (`:50-52`). With
    ``smooth`` the GP's summary comes from Bayesian quadrature against
    N(x, delta^2) smoothing kernels instead of a point prediction
    (`acqwrapper_vbmc.m:12-15`, options.bandwidth > 0)."""
    check_acq(name)
    if ACQ_INFO[name]["importance_sampling"]:
        raise ValueError(f"acquisition {name!r} needs an importance-sampling "
                         "state: use active_is.evaluate_is_acquisition")
    if smooth:
        fmu, fs2 = gp_quad(cfg, gp, Xs, state.delta)
        fbar, vtot = sample_summary(fmu, fs2, gp.hyp_mask)
    else:
        fbar, vtot, fmu, fs2 = gp_predict(cfg, gp, Xs)
    tiny = torch.finfo(vtot.dtype).tiny
    logp = vp_log_pdf_trans(vp, Xs).clamp_min(_LOG_REALMIN)

    if name == "prospective":
        acq = -vtot * torch.exp(fbar - state.ymax + logp)
    elif name == "prospective_sn2":
        sn2 = _nearest_noise(cfg, gp, Xs, state)
        acq = -vtot * (1.0 - sn2 / (vtot + sn2)) * \
            torch.exp(fbar - state.ymax + logp)
    elif name == "prospective_log":
        acq = -(torch.log(vtot.clamp_min(tiny)) + fbar - state.ymax + logp)
    elif name == "us":
        acq = -vtot * torch.exp(2.0 * logp)
    else:  # "eig"
        from vbmc_tpu_torch.active_is import int_kernel
        sn2 = _nearest_noise(cfg, gp, Xs, state)
        intK = int_kernel(cfg, gp, vp, Xs)                      # (S, M)
        rho2 = (intK ** 2 / (state.var_log_joint[:, None]
                             * (fs2 + sn2[None, :]))).clamp_max(1.0)
        m = gp.hyp_mask.to(fbar.dtype)
        acq = 0.5 * (torch.log((1.0 - rho2).clamp_min(tiny))
                     * m[:, None]).sum(0) / m.sum().clamp_min(1.0)

    if state.regularize:
        low = vtot < state.tol_var
        ratio = state.tol_var / vtot.clamp_min(tiny)
        if ACQ_INFO[name]["log_flag"]:
            acq = torch.where(low, acq + ratio - 1.0, acq)
        else:
            acq = torch.where(low, acq * torch.exp(-(ratio - 1.0)), acq)
    acq = acq.clamp_min(-torch.finfo(acq.dtype).max)
    return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                            state.ub_eps_orig, acq)


def sweep_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                      vp: VariationalPosterior, gp: GP, state: AcqState,
                      smooth: bool = False) -> torch.Tensor:
    """The 2^13-candidate sweep. The configuration alone decides the path,
    before anything is launched: the `prospective_acq` wrapper (the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors) for
    "prospective" without smoothing on a GP that `kernel_supports`, and
    `evaluate_acquisition` for everything else. A failed build or launch
    raises."""
    if name == "prospective" and not smooth and kernel_supports(cfg):
        acq = prospective_acq(cfg, Xs, gp, vp, state.ymax, state.tol_var,
                              state.regularize)
        return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                                state.ub_eps_orig, acq)
    return evaluate_acquisition(cfg, name, Xs, vp, gp, state, smooth=smooth)
