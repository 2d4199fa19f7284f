"""Parameter-space transforms (constrained <-> unconstrained)
(cf. `vbmc_tpu/transforms.py`, `shared/warpvars_vbmc.m`).

Transform types per dimension: 0 unbounded (affine), 1 lower-bounded
(log), 2 upper-bounded (log), 3 bounded logit, 12 bounded probit,
13 bounded Student-t4. Every family is evaluated on safe inputs and the
result selected per dimension with ``torch.where``. A rotoscale stage
y' = (y @ R) / scale follows; R and scale are always present (identity
until an input warp installs a real one).

The ``*_np`` twins do the same math in NumPy for host-side consumers (the
function logger, the warp code).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

LOGIT, PROBIT, STUDENT4 = 3, 12, 13

_TINY = 1e-300


@dataclasses.dataclass
class Trinfo:
    """Transform description: per-dimension tensors on one device."""

    type: torch.Tensor       # (D,) int64 type codes
    lb_orig: torch.Tensor    # (D,) original-space lower bounds
    ub_orig: torch.Tensor    # (D,) original-space upper bounds
    mu: torch.Tensor         # (D,) affine centre (types 0, 3, 12, 13)
    delta: torch.Tensor      # (D,) affine scale
    R_mat: torch.Tensor      # (D, D) rotation (identity until a warp)
    scale: torch.Tensor      # (D,) post-rotation scaling
    _host: dict = dataclasses.field(default=None, init=False, repr=False,
                                    compare=False)

    @property
    def ndim(self) -> int:
        return self.type.shape[0]

    def host(self) -> dict:
        """NumPy copies of the fields, made once per Trinfo."""
        if self._host is None:
            self._host = {f.name: np.asarray(
                getattr(self, f.name).detach().cpu().numpy(),
                int if f.name == "type" else float)
                for f in dataclasses.fields(self) if f.init}
        return self._host

    def replace(self, **kw) -> "Trinfo":
        return dataclasses.replace(self, **kw)


def trinfo_from_np(fields: dict, device, dtype) -> Trinfo:
    """Build a Trinfo on ``device`` from host arrays."""
    kw = {}
    for name in ("type", "lb_orig", "ub_orig", "mu", "delta", "R_mat",
                 "scale"):
        v = np.asarray(fields[name])
        if name == "type":
            kw[name] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            kw[name] = torch.as_tensor(v.astype(np.float64), device=device,
                                       dtype=dtype)
    return Trinfo(**kw)


def _t4_cdf(u):
    s = u / torch.sqrt(u * u + 4.0)
    return 0.5 + 0.25 * s * (3.0 - s * s)


def _t4_icdf(p):
    p = p.clamp(_TINY, 1.0 - 1e-16)
    sqrt_alpha = torch.sqrt(4.0 * p * (1.0 - p))
    q = torch.cos(torch.arccos(sqrt_alpha) / 3.0) / sqrt_alpha
    return torch.sign(p - 0.5) * 2.0 * torch.sqrt(q - 1.0)


def create_trinfo(lb, ub, plb=None, pub=None, bounded_type: int = LOGIT, *,
                  device="cpu", dtype=torch.float64) -> Trinfo:
    """Build a Trinfo from bounds (cf. `warpvars_vbmc.m:856-920`): types from
    bound finiteness, affine recentring from the transformed plausible box."""
    lb = np.asarray(lb, dtype=np.float64).ravel()
    ub = np.asarray(ub, dtype=np.float64).ravel()
    D = lb.shape[0]
    plb = lb.copy() if plb is None else np.asarray(plb, np.float64).ravel()
    pub = ub.copy() if pub is None else np.asarray(pub, np.float64).ravel()
    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")

    types = np.zeros(D, dtype=np.int64)
    types[np.isfinite(lb) & ~np.isfinite(ub)] = 1
    types[~np.isfinite(lb) & np.isfinite(ub)] = 2
    types[np.isfinite(lb) & np.isfinite(ub)] = bounded_type
    fields = dict(type=types, lb_orig=lb, ub_orig=ub, mu=np.zeros(D),
                  delta=np.ones(D), R_mat=np.eye(D), scale=np.ones(D))

    tplb = _direct_np_fields(fields, plb[None, :])[0]
    tpub = _direct_np_fields(fields, pub[None, :])[0]
    ok = np.isfinite(tplb) & np.isfinite(tpub)
    fields["mu"][ok] = 0.5 * (tplb[ok] + tpub[ok])
    fields["delta"][ok] = tpub[ok] - tplb[ok]
    return trinfo_from_np(fields, device, dtype)


def _safe_bounds(trinfo: Trinfo):
    a = torch.where(torch.isfinite(trinfo.lb_orig), trinfo.lb_orig, 0.0)
    b = torch.where(torch.isfinite(trinfo.ub_orig), trinfo.ub_orig, 1.0)
    b = torch.where(b > a, b, a + 1.0)
    return trinfo.type, a, b


def _rotate(y, R):
    """y @ R for rows with all-finite entries; other rows pass through
    (inf * 0 in the product would turn them into NaN)."""
    finite = torch.isfinite(y).all(dim=-1, keepdim=True)
    return torch.where(finite, torch.where(finite, y, 0.0) @ R, y)


def direct(trinfo: Trinfo, x: torch.Tensor) -> torch.Tensor:
    """Map original-space points x (..., D) to unconstrained space."""
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta
    y0 = (x - mu) / delta
    y1 = torch.log(torch.clamp_min(x - a, _TINY))
    y2 = torch.log(torch.clamp_min(b - x, _TINY))
    z = ((x - a) / (b - a)).clamp(_TINY, 1.0 - 1e-16)
    u = torch.where(t == LOGIT, torch.log(z) - torch.log1p(-z),
                    torch.where(t == PROBIT, torch.special.ndtri(z),
                                _t4_icdf(z)))
    y3 = (u - mu) / delta
    y = torch.where(t == 0, y0, torch.where(t == 1, y1,
                                            torch.where(t == 2, y2, y3)))
    return _rotate(y, trinfo.R_mat) / trinfo.scale


def _unrotate(trinfo: Trinfo, y):
    return _rotate(y * trinfo.scale, trinfo.R_mat.T)


def inverse(trinfo: Trinfo, y: torch.Tensor) -> torch.Tensor:
    """Map unconstrained points y (..., D) back to original space."""
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta
    y = _unrotate(trinfo, y)
    x0 = mu + delta * y
    x1 = a + torch.exp(y)
    x2 = b - torch.exp(y)
    u = y * delta + mu
    z = torch.where(t == LOGIT, torch.sigmoid(u),
                    torch.where(t == PROBIT, torch.special.ndtr(u),
                                _t4_cdf(u)))
    x3 = a + (b - a) * z
    x = torch.where(t == 0, x0, torch.where(t == 1, x1,
                                            torch.where(t == 2, x2, x3)))
    bounded = (t == LOGIT) | (t == PROBIT) | (t == STUDENT4)
    return torch.where(bounded, torch.minimum(torch.maximum(x, a), b), x)


def log_abs_det_jacobian(trinfo: Trinfo, y: torch.Tensor) -> torch.Tensor:
    """log |dx/dy| summed over dimensions at unconstrained y (the reference
    'logprob' correction, `warpvars_vbmc.m:463-503`)."""
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta
    y_s = _unrotate(trinfo, y)
    p0 = torch.log(delta) * torch.ones_like(y_s)
    u = y_s * delta + mu
    lab = torch.log(b - a)
    p_logit = lab - F.softplus(u) - F.softplus(-u) + torch.log(delta)
    p_probit = lab - 0.5 * math.log(2 * math.pi) - 0.5 * u * u \
        + torch.log(delta)
    p_t4 = (lab + math.log(3.0 / 8.0) - 2.5 * torch.log1p(u * u / 4.0)
            + torch.log(delta))
    p3 = torch.where(t == LOGIT, p_logit,
                     torch.where(t == PROBIT, p_probit, p_t4))
    p = torch.where(t == 0, p0, torch.where((t == 1) | (t == 2), y_s, p3))
    return (p + torch.log(trinfo.scale)).sum(-1)


# ----------------------------------------------------------------------
# Host (NumPy) twins.
# ----------------------------------------------------------------------

def _host_fields(h: dict):
    t = h["type"]
    lb, ub = h["lb_orig"], h["ub_orig"]
    a = np.where(np.isfinite(lb), lb, 0.0)
    b = np.where(np.isfinite(ub), ub, 1.0)
    b = np.where(b > a, b, a + 1.0)
    return t, a, b, h["mu"], h["delta"], h["R_mat"], h["scale"]


def _t4_cdf_np(u):
    s = u / np.sqrt(u * u + 4.0)
    return 0.5 + 0.25 * s * (3.0 - s * s)


def _t4_icdf_np(p):
    p = np.clip(p, _TINY, 1.0 - 1e-16)
    sqrt_alpha = np.sqrt(4.0 * p * (1.0 - p))
    q = np.cos(np.arccos(sqrt_alpha) / 3.0) / sqrt_alpha
    return np.sign(p - 0.5) * 2.0 * np.sqrt(q - 1.0)


def _rotate_np(y, R):
    finite = np.all(np.isfinite(y), axis=-1, keepdims=True)
    return np.where(finite, np.where(finite, y, 0.0) @ R, y)


def _direct_np_fields(h: dict, x: np.ndarray) -> np.ndarray:
    from scipy.special import ndtri
    t, a, b, mu, delta, R, s = _host_fields(h)
    x = np.asarray(x, float)
    y0 = (x - mu) / delta
    with np.errstate(divide="ignore", invalid="ignore"):
        y1 = np.log(np.maximum(x - a, _TINY))
        y2 = np.log(np.maximum(b - x, _TINY))
        z = np.clip((x - a) / (b - a), _TINY, 1.0 - 1e-16)
        u = np.where(t == LOGIT, np.log(z) - np.log1p(-z),
                     np.where(t == PROBIT, ndtri(z), _t4_icdf_np(z)))
    y3 = (u - mu) / delta
    y = np.where(t == 0, y0, np.where(t == 1, y1, np.where(t == 2, y2, y3)))
    return _rotate_np(y, R) / s


def direct_np(trinfo: Trinfo, x: np.ndarray) -> np.ndarray:
    return _direct_np_fields(trinfo.host(), x)


def inverse_np(trinfo: Trinfo, y: np.ndarray) -> np.ndarray:
    from scipy.special import ndtr
    t, a, b, mu, delta, R, s = _host_fields(trinfo.host())
    y = _rotate_np(np.asarray(y, float) * s, R.T)
    x0 = mu + delta * y
    with np.errstate(over="ignore"):
        x1 = a + np.exp(y)
        x2 = b - np.exp(y)
    u = y * delta + mu
    with np.errstate(over="ignore"):
        z = np.where(t == LOGIT, 1.0 / (1.0 + np.exp(-u)),
                     np.where(t == PROBIT, ndtr(u), _t4_cdf_np(u)))
    x3 = a + (b - a) * z
    x = np.where(t == 0, x0, np.where(t == 1, x1, np.where(t == 2, x2, x3)))
    bounded = (t == LOGIT) | (t == PROBIT) | (t == STUDENT4)
    return np.where(bounded, np.clip(x, a, b), x)


def log_abs_det_jacobian_np(trinfo: Trinfo, y: np.ndarray) -> np.ndarray:
    t, a, b, mu, delta, R, s = _host_fields(trinfo.host())
    y_s = _rotate_np(np.asarray(y, float) * s, R.T)
    # delta is negative for type-2 dims; the NaN it gives in unselected
    # lanes is discarded by the where-select.
    with np.errstate(invalid="ignore", divide="ignore"):
        p0 = np.log(delta) * np.ones_like(y_s)
        u = y_s * delta + mu
        lab = np.log(b - a)
        p_logit = (lab - np.logaddexp(0.0, u) - np.logaddexp(0.0, -u)
                   + np.log(delta))
        p_probit = lab - 0.5 * np.log(2 * np.pi) - 0.5 * u * u + np.log(delta)
        p_t4 = (lab + np.log(3.0 / 8.0) - 2.5 * np.log1p(u * u / 4.0)
                + np.log(delta))
        p3 = np.where(t == LOGIT, p_logit,
                      np.where(t == PROBIT, p_probit, p_t4))
    p = np.where(t == 0, p0, np.where((t == 1) | (t == 2), y_s, p3))
    return np.sum(p + np.log(s), axis=-1)


def real_to_int(trinfo: Trinfo, y: torch.Tensor,
                integer_mask) -> torch.Tensor:
    """Round integer dimensions through the transform
    (cf. `misc/real2int_vbmc.m`): map to original space, round the flagged
    dimensions, map back."""
    if integer_mask is None or not bool(np.any(np.asarray(integer_mask))):
        return y
    x = inverse(trinfo, y)
    mask = torch.as_tensor(np.asarray(integer_mask, bool), device=y.device)
    return direct(trinfo, torch.where(mask[None, :], torch.round(x), x))
