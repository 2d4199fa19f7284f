"""Bounded coordinate-wise slice sampling over a batch of chains (cf.
`vbmc_tpu/samplers/slice.py`, `gplite/private/slicesamplebnd.m`).

The reference vmaps one chain's `lax.while_loop`s over chains. Here the
chains are rows of one batch: the stepping-out and shrinkage loops run
while any chain is still active, and each step evaluates the batched
log density only at the rows that still need it.
"""

from __future__ import annotations

import torch

_MAX_STEPOUT = 16
_MAX_SHRINK = 64


def _rand(gen, n, like):
    return torch.rand(n, generator=gen, device=like.device, dtype=like.dtype)


def _slice_coord(gen, logpdf, x, d, logp_x, width, lb, ub):
    """One slice update of coordinate d for every chain (rows of x)."""
    C = x.shape[0]
    xd = x[:, d]
    log_u = logp_x + torch.log(_rand(gen, C, x))
    r = _rand(gen, C, x)
    left = torch.clamp_min(xd - r * width, lb[d])
    right = torch.clamp_max(xd + (1.0 - r) * width, ub[d])

    def logp_at(rows, vals):
        xs = x[rows].clone()
        xs[:, d] = vals
        return logpdf(xs)

    # Stepping out: left and right brackets of all active chains in one
    # batched evaluation.
    go_l = torch.ones(C, dtype=torch.bool, device=x.device)
    go_r = go_l.clone()
    for _ in range(_MAX_STEPOUT):
        if not bool((go_l | go_r).any()):
            break
        new_left = torch.clamp_min(left - width, lb[d])
        new_right = torch.clamp_max(right + width, ub[d])
        il = torch.nonzero(go_l).flatten()
        ir = torch.nonzero(go_r).flatten()
        lp = logp_at(torch.cat([il, ir]), torch.cat([left[il], right[ir]]))
        lp_l = torch.full_like(left, -torch.inf)
        lp_r = torch.full_like(right, -torch.inf)
        lp_l[il] = lp[:il.shape[0]]
        lp_r[ir] = lp[il.shape[0]:]
        go_l = go_l & (lp_l > log_u) & (left > lb[d])
        go_r = go_r & (lp_r > log_u) & (right < ub[d])
        left = torch.where(go_l, new_left, left)
        right = torch.where(go_r, new_right, right)

    # Shrinkage.
    accepted = torch.zeros(C, dtype=torch.bool, device=x.device)
    new_xd = xd.clone()
    new_lp = logp_x.clone()
    for _ in range(_MAX_SHRINK):
        if bool(accepted.all()):
            break
        prop = left + (right - left) * _rand(gen, C, x)
        rows = torch.nonzero(~accepted).flatten()
        lp_prop = torch.full_like(left, -torch.inf)
        lp_prop[rows] = logp_at(rows, prop[rows])
        ok = (lp_prop > log_u) & ~accepted
        left = torch.where(ok | (prop >= xd), left, prop)
        right = torch.where(ok | (prop < xd), right, prop)
        new_xd = torch.where(ok, prop, new_xd)
        new_lp = torch.where(ok, lp_prop, new_lp)
        accepted = accepted | ok
    # A chain whose shrinkage failed (pathological target) stays put.
    x = x.clone()
    x[:, d] = new_xd
    return x, new_lp


def slice_sample_chains(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                        widths, lb, ub, n_keep: int, burn: int, thin: int,
                        n_keep_max: int):
    """Run C chains (rows of x0s (C, D)) for burn + n_keep * thin sweeps and
    keep every thin-th state after the burn-in. ``logpdf`` maps (B, D) to
    (B,). Returns (samples (C, n_keep_max, D), logps (C, n_keep_max)); slots
    beyond n_keep hold zeros and -inf."""
    C, D = x0s.shape
    buf = x0s.new_zeros((C, n_keep_max, D))
    logbuf = torch.full((C, n_keep_max), -torch.inf, dtype=x0s.dtype,
                        device=x0s.device)
    x = x0s.clone()
    logp_x = logpdf(x)
    for i in range(burn + n_keep * thin):
        for d in range(D):
            x, logp_x = _slice_coord(gen, logpdf, x, d, logp_x, widths[d],
                                     lb, ub)
        if i >= burn and (i - burn + 1) % thin == 0:
            # past n_keep_max kept states the last slot takes each new one
            idx = min((i - burn + 1) // thin - 1, n_keep_max - 1)
            buf[:, idx] = x
            logbuf[:, idx] = logp_x
    return buf, logbuf


def slice_sample_chain(gen: torch.Generator, logpdf, x0: torch.Tensor,
                       widths, lb, ub, n_keep, burn, thin, n_keep_max: int):
    """One chain from x0 (D,) for a log density of one point ``logpdf``
    (D,) -> (), written in torch operations and applied to the batch's
    rows by `torch.func.vmap` (the reference's `vmap`). Returns (samples
    (n_keep_max, D), logps (n_keep_max,)); slots from n_keep on hold zeros
    and -inf."""
    buf, logbuf = slice_sample_chains(gen, torch.func.vmap(logpdf),
                                      x0[None], widths, lb, ub, int(n_keep),
                                      int(burn), int(thin), n_keep_max)
    return buf[0], logbuf[0]


def slice_sample_ensemble(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                          widths, lb, ub, n_keep_per_chain, burn, thin,
                          n_keep_max_per_chain: int):
    """C chains from the rows of x0s (C, D), advanced together, for a log
    density of one point as in `slice_sample_chain`. Returns (samples
    (C, n_keep_max_per_chain, D), logps (C, n_keep_max_per_chain))."""
    return slice_sample_chains(gen, torch.func.vmap(logpdf), x0s, widths,
                               lb, ub, int(n_keep_per_chain), int(burn),
                               int(thin), n_keep_max_per_chain)
