"""Build the port's state objects from dicts of NumPy arrays.

The inputs are plain mappings of field name to array, for example what
``jax.device_get(x._asdict())`` gives for the reference's `GP`,
`VariationalPosterior`, `Trinfo`, `HypPrior` and `ISState` named tuples, so
both packages can compute on the same state. Nothing here imports jax;
nested named tuples (a VP's trinfo) are accepted through their ``_asdict``.
"""

from __future__ import annotations

import numpy as np
import torch

from vbmc_tpu_torch.active_is import ISState
from vbmc_tpu_torch.gp.gp import GP, HypPrior
from vbmc_tpu_torch.transforms import Trinfo, trinfo_from_np
from vbmc_tpu_torch.vp import VariationalPosterior, vp_from_np


def _fields(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a, np.float64), device=device,
                           dtype=dtype)


def trinfo_from_dict(d, device="cpu", dtype=torch.float64) -> Trinfo:
    f = _fields(d)
    D = np.asarray(f["type"]).shape[0]
    if f.get("R_mat") is None:
        f["R_mat"] = np.eye(D)
    if f.get("scale") is None:
        f["scale"] = np.ones(D)
    return trinfo_from_np(f, device, dtype)


def vp_from_dict(d, device="cpu", dtype=torch.float64) -> VariationalPosterior:
    f = _fields(d)
    trinfo = trinfo_from_dict(f["trinfo"], device, dtype)
    return vp_from_np(trinfo, f["w"], f["eta"], f["mu"], f["sigma"],
                      f["lam"], np.asarray(f["kmask"], bool))


def gp_from_dict(d, device="cpu", dtype=torch.float64) -> GP:
    f = _fields(d)
    extras = {k: _t(f[k], device, dtype)
              for k in ("betabar", "HBinv", "Ainv") if f.get(k) is not None}
    return GP(X=_t(f["X"], device, dtype), y=_t(f["y"], device, dtype),
              s2=_t(f["s2"], device, dtype),
              mask=torch.as_tensor(np.array(f["mask"], bool), device=device),
              hyp=_t(f["hyp"], device, dtype),
              hyp_mask=torch.as_tensor(np.array(f["hyp_mask"], bool),
                                       device=device),
              alpha=_t(f["alpha"], device, dtype),
              L=_t(f["L"], device, dtype), Binv=_t(f["Binv"], device, dtype),
              sn2=_t(f["sn2"], device, dtype), **extras)


def hyp_prior_from_dict(d, device="cpu", dtype=torch.float64) -> HypPrior:
    f = _fields(d)
    return HypPrior(**{k: _t(f[k], device, dtype)
                       for k in ("mu", "sigma", "df", "lb", "ub", "plb",
                                 "pub")})


def is_state_from_dict(d, device="cpu", dtype=torch.float64) -> ISState:
    f = _fields(d)
    return ISState(**{k: _t(f[k], device, dtype)
                      for k in ("Xa", "ln_weights", "invKzk", "f_s2")})
