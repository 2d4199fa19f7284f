"""Prior toolbox (cf. `vbmc_tpu/priors.py`): box-type priors over bounded
and unbounded variables (`shared/munifbox*.m`, `mtrapez*.m`,
`msplinetrapez*.m`, `msmoothbox*.m`), plus `log_post_fun` (`lpostfun.m`)
to compose a log likelihood with a log prior.

Every density is separable across dimensions and vectorised over points.
The log densities take tensors or NumPy arrays (M, D) and return a tensor
(M,) on the input's device (float64 on the CPU for NumPy input); the
samplers draw from a `torch.Generator` on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT2PI = 2.5066282746310002


def _x(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float64))
    return torch.atleast_2d(x)


def _bc(a, D, like: torch.Tensor) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(a, np.float64) if not isinstance(
        a, torch.Tensor) else a, device=like.device, dtype=like.dtype)
    return torch.broadcast_to(torch.atleast_1d(a), (D,))


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float64)


def _dims(a, D):
    return np.atleast_1d(np.asarray(a, float)).shape[0] if D is None else D


# ----------------------------------------------------------------------
# Uniform box
# ----------------------------------------------------------------------

def unifbox_logpdf(x, a, b) -> torch.Tensor:
    """Uniform over the box [a, b] (cf. `munifboxpdf.m`)."""
    x = _x(x)
    D = x.shape[1]
    a, b = _bc(a, D, x), _bc(b, D, x)
    inside = ((x >= a) & (x <= b)).all(1)
    return torch.where(inside, -torch.log(b - a).sum(), -math.inf)


def unifbox_rnd(gen: torch.Generator, n, a, b, D=None) -> torch.Tensor:
    D = _dims(a, D)
    u = _rand(gen, (n, D))
    a, b = _bc(a, D, u), _bc(b, D, u)
    return a + u * (b - a)


# ----------------------------------------------------------------------
# Trapezoidal
# ----------------------------------------------------------------------

def trapez_logpdf(x, a, u, v, b) -> torch.Tensor:
    """Trapezoidal density: 0 at a and b, flat on [u, v]
    (cf. `mtrapezpdf.m`)."""
    x = _x(x)
    D = x.shape[1]
    a, u, v, b = (_bc(t, D, x) for t in (a, u, v, b))
    # normaliser per dimension: h (v - u + (u - a) / 2 + (b - v) / 2) = 1
    h = 1.0 / (0.5 * (u - a) + (v - u) + 0.5 * (b - v))
    lp_flat = torch.log(h)
    lp_up = torch.log(h) + torch.log(((x - a) / (u - a)).clamp_min(0.0))
    lp_dn = torch.log(h) + torch.log(((b - x) / (b - v)).clamp_min(0.0))
    lp = torch.where(x < u, lp_up, torch.where(x > v, lp_dn, lp_flat))
    lp = torch.where((x >= a) & (x <= b), lp, -math.inf)
    return lp.sum(1)


def trapez_rnd(gen: torch.Generator, n, a, u, v, b, D=None) -> torch.Tensor:
    """Per dimension: a mixture of the rising ramp, the flat top and the
    falling ramp, each drawn by inversion."""
    D = _dims(a, D)
    like = torch.empty(0, device=gen.device, dtype=torch.float64)
    a, u, v, b = (_bc(t, D, like) for t in (a, u, v, b))
    w = torch.stack([0.5 * (u - a), v - u, 0.5 * (b - v)], 1)     # (D, 3)
    cum = (w / w.sum(1, keepdim=True)).cumsum(1)
    r = _rand(gen, (n, D))
    lo = _rand(gen, (n, D))
    comp = (r[..., None] >= cum[None, :, :2]).sum(-1)
    tri_up = a + (u - a) * torch.sqrt(lo)
    flat = u + (v - u) * lo
    tri_dn = b - (b - v) * torch.sqrt(lo)
    return torch.where(comp == 0, tri_up, torch.where(comp == 1, flat, tri_dn))


# ----------------------------------------------------------------------
# Smooth box (flat top with Gaussian tails)
# ----------------------------------------------------------------------

def smoothbox_logpdf(x, a, b, sigma) -> torch.Tensor:
    """Flat on [a, b], Gaussian falloff with scale sigma outside
    (cf. `msmoothboxpdf.m`)."""
    x = _x(x)
    D = x.shape[1]
    a, b, sigma = _bc(a, D, x), _bc(b, D, x), _bc(sigma, D, x)
    lnZ = torch.log(b - a + sigma * _SQRT2PI)
    lo = -0.5 * ((x - a) / sigma) ** 2
    hi = -0.5 * ((x - b) / sigma) ** 2
    lp = torch.where(x < a, lo, torch.where(x > b, hi, 0.0)) - lnZ
    return lp.sum(1)


def smoothbox_rnd(gen: torch.Generator, n, a, b, sigma,
                  D=None) -> torch.Tensor:
    D = _dims(a, D)
    like = torch.empty(0, device=gen.device, dtype=torch.float64)
    a, b, s = (_bc(t, D, like) for t in (a, b, sigma))
    p_flat = (b - a) / (b - a + s * _SQRT2PI)
    u = _rand(gen, (n, D))
    flat = a + _rand(gen, (n, D)) * (b - a)
    z = torch.randn((n, D), generator=gen, device=gen.device,
                    dtype=torch.float64).abs() * s
    side = _rand(gen, (n, D)) < 0.5
    tail = torch.where(side, a - z, b + z)
    return torch.where(u < p_flat, flat, tail)


# ----------------------------------------------------------------------
# Spline-smoothed trapezoid (cubic easing on the ramps)
# ----------------------------------------------------------------------

def splinetrapez_logpdf(x, a, u, v, b) -> torch.Tensor:
    """Trapezoid with cubic-spline (smoothstep) ramps instead of linear
    (cf. `msplinetrapezpdf.m`)."""
    x = _x(x)
    D = x.shape[1]
    a, u, v, b = (_bc(t, D, x) for t in (a, u, v, b))
    # smoothstep s(t) = 3t^2 - 2t^3 integrates to 1/2 on [0, 1]: the same
    # normaliser as the linear trapezoid
    h = 1.0 / (0.5 * (u - a) + (v - u) + 0.5 * (b - v))
    t_up = ((x - a) / (u - a)).clamp(0.0, 1.0)
    t_dn = ((b - x) / (b - v)).clamp(0.0, 1.0)
    s_up = t_up * t_up * (3.0 - 2.0 * t_up)
    s_dn = t_dn * t_dn * (3.0 - 2.0 * t_dn)
    val = torch.where(x < u, s_up, torch.where(x > v, s_dn, 1.0))
    inside = (x >= a) & (x <= b)
    lp = torch.where(inside & (val > 0),
                     torch.log(val.clamp_min(1e-300)) + torch.log(h),
                     -math.inf)
    return lp.sum(1)


# ----------------------------------------------------------------------
# Log-joint composition
# ----------------------------------------------------------------------

def log_post_fun(x, log_likelihood, log_prior=None):
    """Compose an unnormalised log posterior (cf. `lpostfun.m`)."""
    ll = log_likelihood(x)
    if log_prior is not None:
        ll = ll + log_prior(x)
    return ll
