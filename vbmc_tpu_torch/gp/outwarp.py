"""GP output warping, "fitness shaping" (cf. `vbmc_tpu/gp/outwarp.py`,
`gplite/outwarp_negpow.m`, `outwarp_negpowc1.m`, `outwarp_negscaledpow.m`).

Monotone warps of the observed log-density that compress the deep tail
below a learned threshold ``y0``, so that the GP does not spend its length
scales on the region of very low density. Each warp is an elementwise
select on ``y < y0`` and autograd differentiates it.

- ``direct``: observation space -> warped (GP) space, identity above y0.
- ``inverse``: warped space -> observation space.
- ``deriv``: d(warped)/dy, for the Jacobian term of nlZ
  (`gplite_core.m:196-198`), the warped user noise s2 g'(y)^2
  (`gplite_core.m:22-26`) and the delta-method prediction variance
  (`gplite_pred.m:130-149`).

Hyperparameters: NEGPOW (1) and NEGPOWC1 (2, C1 at the threshold)
[y0, log k]; NEGSCALEDPOW (3) [y0, log a, log k]. Every function takes
hyp_ow (B, now) and values broadcastable to (B, n), and returns (B, n).
"""

from __future__ import annotations

import numpy as np
import torch

from vbmc_tpu_torch.gp.config import (OUTWARP_NONE, OUTWARP_NEGPOW,
                                      OUTWARP_NEGPOWC1, OUTWARP_NEGSCALEDPOW)

N_OUTWARP_HYP = {OUTWARP_NONE: 0, OUTWARP_NEGPOW: 2, OUTWARP_NEGPOWC1: 2,
                 OUTWARP_NEGSCALEDPOW: 3}


def _split(outwarp_id: int, hyp_ow: torch.Tensor):
    if outwarp_id not in (OUTWARP_NEGPOW, OUTWARP_NEGPOWC1,
                          OUTWARP_NEGSCALEDPOW):
        raise ValueError(f"unknown outwarp id {outwarp_id}")
    y0 = hyp_ow[:, 0:1]
    if outwarp_id == OUTWARP_NEGSCALEDPOW:
        return y0, torch.exp(hyp_ow[:, 1:2]), torch.exp(hyp_ow[:, 2:3])
    return y0, torch.ones_like(y0), torch.exp(hyp_ow[:, 1:2])


def outwarp_direct(outwarp_id: int, hyp_ow, y):
    """Warp observations y -> t (identity above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return y
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = y < y0
    if outwarp_id == OUTWARP_NEGPOWC1:
        d = torch.where(below, 1.0 + y0 - y, 1.0)
        t = y0 - (d ** k) / k + 1.0 / k
    else:
        d = torch.where(below, a * (y0 - y), 1.0)
        t = y0 - d ** k
    return torch.where(below, t, y)


def outwarp_inverse(outwarp_id: int, hyp_ow, t):
    """Inverse warp t -> y (identity above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return t
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = t < y0
    if outwarp_id == OUTWARP_NEGPOWC1:
        d = torch.where(below, 1.0 + k * (y0 - t), 1.0)
        y = y0 + 1.0 - d ** (1.0 / k)
    else:
        d = torch.where(below, y0 - t, 1.0)
        y = y0 - (d ** (1.0 / k)) / a
    return torch.where(below, y, t)


def outwarp_deriv(outwarp_id: int, hyp_ow, y):
    """dt/dy at observation-space points y (1 above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return torch.ones_like(y)
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = y < y0
    if outwarp_id == OUTWARP_NEGPOWC1:
        d = torch.where(below, 1.0 + y0 - y, 1.0)
        g = d ** (k - 1.0)
    else:
        d = torch.where(below, a * (y0 - y), 1.0)
        g = a * k * d ** (k - 1.0)
    return torch.where(below, g, 1.0)


def outwarp_info(outwarp_id: int, y: np.ndarray):
    """Bounds / plausible box / x0 of the warp hyperparameters (host NumPy;
    cf. the 'info' branches of the three reference files)."""
    now = N_OUTWARP_HYP[outwarp_id]
    lb = np.full(now, -np.inf)
    ub = np.full(now, np.inf)
    plb = np.full(now, -np.inf)
    pub = np.full(now, np.inf)
    x0 = np.full(now, np.nan)
    if now == 0:
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
    if y.size <= 1:
        y = np.array([0.0, 1.0])
    lb[0] = plb[0] = y.min()                        # the threshold y0
    ub[0] = pub[0] = y.max()
    if outwarp_id == OUTWARP_NEGSCALEDPOW:
        plb[1], pub[1], x0[1] = -2.0, 2.0, 0.0      # log a
        plb[2], pub[2], x0[2] = -3.0, 3.0, 0.0      # log k
    else:
        plb[1], pub[1], x0[1] = -3.0, 3.0, 0.0      # log k
    nan = np.isnan(x0)
    x0[nan] = 0.5 * (plb[nan] + pub[nan])
    return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
