"""Ensemble slice sampling (cf. `vbmc_tpu/samplers/ensemble.py`,
`utils/eissample_lite.m`): W walkers, each moved by slice sampling along the
difference of two other walkers.

`ensemble_slice_final` is the GP hyperparameter sampler for nhyp > 20: the
walkers split into two halves, each half moves along directions drawn from
the other half, every mover in lock-step, so each shrinkage step is one
batched log-density evaluation. `ensemble_slice_sample` (the GP-surrogate
sampler of `gp/sample.py`) moves the walkers one after the other and keeps
every sweep.
"""

from __future__ import annotations

import torch

_MAX_SHRINK = 60


def _slice_direction_batch(gen, logpdf, xs, lps, dirs, lb, ub):
    """Slice sample every row of xs along its row of dirs."""
    H = xs.shape[0]
    dev, dt = xs.device, xs.dtype

    def rand():
        return torch.rand(H, generator=gen, device=dev, dtype=dt)

    log_u = lps + torch.log(rand())
    r = rand()
    lo, hi = -r, 1.0 - r
    t = torch.zeros(H, dtype=dt, device=dev)
    lp = log_u.clone()
    done = torch.zeros(H, dtype=torch.bool, device=dev)
    for _ in range(_MAX_SHRINK):
        if bool(done.all()):
            break
        prop_t = lo + (hi - lo) * rand()
        rows = torch.nonzero(~done).flatten()
        prop = xs[rows] + prop_t[rows, None] * dirs[rows]
        inside = ((prop >= lb) & (prop <= ub)).all(-1)
        lpr = logpdf(prop)
        lpr = torch.where(inside & torch.isfinite(lpr), lpr, -torch.inf)
        lp_p = torch.full_like(lps, -torch.inf)
        lp_p[rows] = lpr
        ok = (lp_p > log_u) & ~done
        lo = torch.where(ok | (prop_t >= 0), lo, prop_t)
        hi = torch.where(ok | (prop_t < 0), hi, prop_t)
        t = torch.where(ok, prop_t, t)
        lp = torch.where(ok, lp_p, lp)
        done = done | ok
    x_new = torch.where(done[:, None], xs + t[:, None] * dirs, xs)
    return x_new, torch.where(done, lp, lps)


def ensemble_slice_final(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                         lb, ub, n_steps: int, mu_scale: float = 1.0):
    """Advance W walkers (rows of x0s) ``n_steps`` sweeps; return the final
    population (W, D) and its log densities (W,)."""
    W, D = x0s.shape
    H = W // 2
    if H < 2:
        raise ValueError("the ensemble sampler needs at least 4 walkers")
    dev = x0s.device

    def half_move(movers, lps_m, others):
        n_oth = others.shape[0]
        i = torch.randint(0, n_oth, (H,), generator=gen, device=dev)
        j = torch.randint(0, n_oth - 1, (H,), generator=gen, device=dev)
        j = torch.where(j >= i, j + 1, j)
        dirs = mu_scale * (others[i] - others[j])
        return _slice_direction_batch(gen, logpdf, movers, lps_m, dirs, lb, ub)

    xs = x0s.clone()
    lps = logpdf(xs)
    for _ in range(n_steps):
        a, la = half_move(xs[:H], lps[:H], xs[H:])
        xs = torch.cat([a, xs[H:]])
        lps = torch.cat([la, lps[H:]])
        b, lb_ = half_move(xs[H:], lps[H:], xs[:H])
        xs = torch.cat([xs[:H], b])
        lps = torch.cat([lps[:H], lb_])
    return xs, lps


def ensemble_slice_sample(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                          lb, ub, n_steps: int, mu_scale: float = 1.0):
    """Advance W walkers (rows of x0s) ``n_steps`` sweeps, each sweep moving
    the walkers in turn along the difference of two distinct other walkers
    of the current population. ``logpdf`` maps (B, D) -> (B,). Returns
    (walkers (n_steps, W, D), logps (n_steps, W)); thin and flatten at the
    caller."""
    W, D = x0s.shape
    dev = x0s.device
    xs = x0s.clone()
    lps = logpdf(xs)
    walkers, logps = [], []
    for _ in range(n_steps):
        for w in range(W):
            i = int(torch.randint(0, W - 1, (), generator=gen, device=dev))
            j = int(torch.randint(0, W - 2, (), generator=gen, device=dev))
            i = i + 1 if i >= w else i
            j = j + 1 if j >= min(i, w) else j
            j = j + 1 if j >= max(i, w) else j
            direction = mu_scale * (xs[i] - xs[j])
            x_new, lp_new = _slice_direction_batch(
                gen, logpdf, xs[w:w + 1], lps[w:w + 1], direction[None, :],
                lb, ub)
            xs = torch.cat([xs[:w], x_new, xs[w + 1:]])
            lps = torch.cat([lps[:w], lp_new, lps[w + 1:]])
        walkers.append(xs)
        logps.append(lps)
    return torch.stack(walkers), torch.stack(logps)
