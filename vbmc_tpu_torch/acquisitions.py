"""Acquisition functions for active sampling (cf. `vbmc_tpu/acquisitions.py`,
`acq/acqf_vbmc.m`): the "prospective" acquisition of the noiseless path,
-vtot * exp(fbar - ymax) * q(x), lower is better. The importance-sampling
acquisitions of noisy targets ("viqr", "imiqr") live in `active_is.py`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP
from vbmc_tpu_torch.kernels import prospective_acq, prospective_acq_reference
from vbmc_tpu_torch.transforms import inverse
from vbmc_tpu_torch.vp import VariationalPosterior

ACQ_INFO = {
    "prospective": dict(importance_sampling=False),
    "viqr": dict(importance_sampling=True),
    "imiqr": dict(importance_sampling=True),
}
PORTED_ACQS = tuple(ACQ_INFO)


@dataclasses.dataclass
class AcqState:
    """State needed by acquisition evaluations."""
    ymax: torch.Tensor           # () max observed log joint (transformed)
    tol_var: torch.Tensor        # () GP variance regularisation threshold
    lb_eps_orig: torch.Tensor    # (D,) hard-bound epsilon box (original)
    ub_eps_orig: torch.Tensor    # (D,)
    regularize: bool = True
    # (D,) geometric-mean GP length scales (the nearest-noise lookup of
    # the importance-sampling acquisitions).
    gp_length_scale: Optional[torch.Tensor] = None


def check_acq(name: str):
    if name not in PORTED_ACQS:
        raise NotImplementedError(
            f"acquisition {name!r}: only 'prospective', 'viqr' and 'imiqr' "
            "are ported (prospective_sn2, prospective_log, us, eig are "
            "ROADMAP Queue 1, slice 3)")


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


def _check_prospective(name: str):
    check_acq(name)
    if ACQ_INFO[name]["importance_sampling"]:
        raise ValueError(f"acquisition {name!r} needs an importance-sampling "
                         "state: use active_is.evaluate_is_acquisition")


def evaluate_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                         vp: VariationalPosterior, gp: GP,
                         state: AcqState) -> torch.Tensor:
    """Batched acquisition values at candidates Xs (M, D) with variance
    regularisation and hard-bound rejection, in plain PyTorch on any
    device (the CMA-ES refinement batches)."""
    _check_prospective(name)
    acq = prospective_acq_reference(cfg, Xs, gp, vp, state.ymax,
                                    state.tol_var, state.regularize)
    return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                            state.ub_eps_orig, acq)


def sweep_acquisition(cfg: GPConfig, name: str, Xs: torch.Tensor,
                      vp: VariationalPosterior, gp: GP,
                      state: AcqState) -> torch.Tensor:
    """The 2^13-candidate sweep: the `prospective_acq` wrapper (the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors), then the
    hard-bound rejection. The wrapper refuses configurations its kernel
    does not compute."""
    _check_prospective(name)
    acq = prospective_acq(cfg, Xs, gp, vp, state.ymax, state.tol_var,
                          state.regularize)
    return _bound_rejection(vp.trinfo, Xs, state.lb_eps_orig,
                            state.ub_eps_orig, acq)
