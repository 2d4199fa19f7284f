"""Inner optimisers over a batch of independent starts (cf.
`vbmc_tpu/optim.py`): a bounded L-BFGS and the tolerance-windowed Adam of
`utils/fminadam.m`.

The reference runs optax L-BFGS (zoom line search) vmapped over starts for
a fixed number of steps. Here each row of the batch is one start: the
objective maps (B, P) -> (B,), gradients come from autograd of the summed
values (rows are independent), and a row stops when its gradient vanishes
or its line search fails. The minima reached, not the trajectories, match
the reference. The rows advance by fixed-shape trips, one line-search trial
each (`LBFGSStarts`), which the card captures as one CUDA graph a call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from vbmc_tpu_torch.graphs import Graph
from vbmc_tpu_torch.tracing import span


def _to_unbounded(x, lb, ub):
    """Scaled logit on dimensions with both bounds finite."""
    both = torch.isfinite(lb) & torch.isfinite(ub)
    span = torch.where(both, ub - lb, 1.0)
    t = ((x - torch.where(both, lb, 0.0)) / span).clamp(1e-12, 1 - 1e-12)
    return torch.where(both, torch.log(t) - torch.log1p(-t), x)


def _to_bounded(z, lb, ub):
    both = torch.isfinite(lb) & torch.isfinite(ub)
    span = torch.where(both, ub - lb, 1.0)
    return torch.where(both, torch.where(both, lb, 0.0)
                       + span * torch.sigmoid(z), z)


def value_and_grad(f: Callable, x: torch.Tensor):
    """(f(x) (B,), df/dx (B, P)) for a row-separable batched objective."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        v = f(x)
        (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach(), g.detach()


def _two_loop(g, S, Y, rho):
    """Batched L-BFGS two-loop recursion over a history ring: S, Y
    (B, H, P) and rho (B, H), oldest pair first. A slot with rho 0 (empty,
    or a pair with s.y <= 1e-10) adds exact zeros; the initial scaling
    s.y / y.y is the newest pair's with rho > 0, 1 where a row has none."""
    H = S.shape[1]
    q = g
    alphas = []
    for i in reversed(range(H)):
        a = rho[:, i] * (S[:, i] * q).sum(-1)
        q = q - a[:, None] * Y[:, i]
        alphas.append(a)
    slots = torch.arange(H, device=g.device)
    newest = torch.where(rho > 0, slots, -1).amax(-1, keepdim=True)
    scale = (S * Y).sum(-1) / (Y * Y).sum(-1).clamp_min(1e-300)
    gamma = torch.where(newest >= 0, scale.gather(1, newest.clamp_min(0)),
                        1.0)
    q = q * gamma
    for i, a in zip(range(H), reversed(alphas)):
        b = rho[:, i] * (Y[:, i] * q).sum(-1)
        q = q + S[:, i] * (a - b)[:, None]
    return q


def _direction(g, S, Y, rho):
    """The L-BFGS direction d and g.d of each row; steepest descent where
    the recursion gives no descent direction."""
    d = -_two_loop(g, S, Y, rho)
    gd = (g * d).sum(-1)
    bad = ~(gd < 0)
    return (torch.where(bad[:, None], -g, d),
            torch.where(bad, -(g * g).sum(-1), gd))


# Line-search trials an iteration before a row gives up.
_MAX_TRIALS = 30


class LBFGSStarts:
    """Bounded L-BFGS from each row of x0 (B, P), advanced by trips. Each
    row (start) keeps its state in fixed tensors, updated in place: its
    point ``z`` (logit space), value ``v``, gradient ``g``, direction ``d``
    and ``gd`` = g.d, step ``t``, trials in this iteration and iterations
    so far, whether it is still ``searching``, its best point and value,
    and a history ring ``S``, ``Y`` (B, history, P), ``rho`` (B, history).

    A `trip` evaluates the objective and its gradient at z + t d for every
    row and applies each row's Armijo test. A row that accepts pushes its
    pair into its ring (rho 0 where s.y <= 1e-10), moves, stops on ``gtol``
    or at ``maxiter`` iterations, and otherwise takes its next direction
    and a step of 1 (its first step is 1 / |g|_1, at most 1); a row that
    rejects halves its step, and stops after 30 trials without a move.
    Rows are independent: each takes the iterates it takes alone. A row
    that is done is still evaluated and nothing of it changes, so a trip
    has one shape and a trip past every row's end changes nothing.
    ``busy`` is the device flag that some row is searching; ``trips``
    counts the trips run."""

    def __init__(self, f: Callable, x0: torch.Tensor, lb, ub, maxiter: int,
                 history: int = 10, gtol: float = 1e-9):
        B, P = x0.shape
        dt, dev = x0.dtype, x0.device
        lb = torch.as_tensor(lb, dtype=dt, device=dev).expand_as(x0)
        ub = torch.as_tensor(ub, dtype=dt, device=dev).expand_as(x0)
        self.lb, self.ub = lb, ub
        self.maxiter, self.gtol = maxiter, gtol

        def obj(z):
            return f(_to_bounded(z, lb, ub))

        self.obj = obj
        self.z = _to_unbounded(torch.minimum(torch.maximum(x0, lb), ub),
                               lb, ub)
        v, g = value_and_grad(obj, self.z)
        ok = torch.isfinite(v) & torch.isfinite(g).all(-1)
        self.v = torch.where(ok, v, math.inf)
        self.g = torch.where(ok[:, None], g, 0.0)
        self.zbest, self.fbest = self.z.clone(), self.v.clone()
        self.S = self.z.new_zeros((B, history, P))
        self.Y = torch.zeros_like(self.S)
        self.rho = self.z.new_zeros((B, history))
        self.n_iter, self.n_trial = (torch.zeros(B, dtype=torch.long,
                                                 device=dev)
                                     for _ in range(2))
        self.searching = ok & (maxiter > 0)
        self.d, self.gd = _direction(self.g, self.S, self.Y, self.rho)
        self.t = (1.0 / self.g.abs().sum(-1).clamp_min(1e-300)).clamp(
            max=1.0)
        self.busy = self.searching.any()
        self.trips = 0
        self._graph = None

    def trip(self):
        """One line-search trial of every row, in place; no host read."""
        z_try = self.z + self.t[:, None] * self.d
        v_try, g_try = value_and_grad(self.obj, z_try)
        ok = (torch.isfinite(v_try) & torch.isfinite(g_try).all(-1)
              & (v_try <= self.v + 1e-4 * self.t * self.gd))
        acc = self.searching & ok
        rej = self.searching & ~ok
        s, y = z_try - self.z, g_try - self.g
        sy = (s * y).sum(-1)
        r = torch.where(sy > 1e-10, 1.0 / sy.clamp_min(1e-300), 0.0)
        for ring, new in ((self.S, s[:, None]), (self.Y, y[:, None]),
                          (self.rho, r[:, None])):
            pushed = torch.cat([ring[:, 1:], new], 1)
            ring.copy_(torch.where(acc.view((-1,) + (1,) * (ring.dim() - 1)),
                                   pushed, ring))
        better = acc & (v_try < self.fbest)
        self.zbest.copy_(torch.where(better[:, None], z_try, self.zbest))
        self.fbest.copy_(torch.where(better, v_try, self.fbest))
        self.z.copy_(torch.where(acc[:, None], z_try, self.z))
        self.v.copy_(torch.where(acc, v_try, self.v))
        self.g.copy_(torch.where(acc[:, None], g_try, self.g))
        self.n_iter.add_(acc.long())
        self.n_trial.copy_(torch.where(acc, 0, self.n_trial + rej.long()))
        stop = acc & ((self.n_iter >= self.maxiter)
                      | ~(self.g.abs().amax(-1) > self.gtol))
        fail = rej & (self.n_trial >= _MAX_TRIALS)
        self.searching.logical_and_(~(stop | fail))
        d, gd = _direction(self.g, self.S, self.Y, self.rho)
        self.d.copy_(torch.where(acc[:, None], d, self.d))
        self.gd.copy_(torch.where(acc, gd, self.gd))
        self.t.copy_(torch.where(acc, 1.0,
                                 torch.where(rej, 0.5 * self.t, self.t)))
        self.busy.copy_(self.searching.any())

    def capture(self):
        """On the card: the first trip, run for real, then captured as a
        graph and instantiated."""
        self._graph = Graph(self.trip, self.z.device)
        self.trips = 1

    def run(self):
        """Trips until no row searches: the graph's replays once captured,
        the trip itself otherwise; one flag read a trip."""
        step = self.trip if self._graph is None else self._graph.replay
        while bool(self.busy):
            step()
            self.trips += 1

    def result(self):
        """(x_best (B, P) inside the box, f_best (B,))."""
        return _to_bounded(self.zbest, self.lb, self.ub), self.fbest


def minimize_lbfgs_bounded(f: Callable, x0: torch.Tensor, lb, ub,
                           maxiter: int = 100, history: int = 10,
                           gtol: float = 1e-9):
    """Minimise the row-separable f over the box [lb, ub] from each row of
    x0 (B, P), by L-BFGS with a backtracking Armijo line search on a logit
    reparameterisation (`LBFGSStarts`). Returns (x_best (B, P), f_best
    (B,)); non-finite values count as +inf. On CUDA tensors a trip is
    captured once a call as a CUDA graph, in the span "capture" with the
    starts' first evaluation, and replayed while a row searches; f must
    then read nothing from the host, or the capture raises."""
    with span("capture"):
        starts = LBFGSStarts(f, x0, lb, ub, maxiter, history, gtol)
        if x0.device.type == "cuda":
            starts.capture()
    starts.run()
    return starts.result()


@dataclasses.dataclass
class AdamResult:
    x: torch.Tensor         # (B, P) average over the last window
    f: torch.Tensor         # (B,) average recent objective
    x_trace: torch.Tensor   # (B, maxiter, P) iterates
    f_trace: torch.Tensor   # (B, maxiter) objective values
    n_iters: torch.Tensor   # (B,) iteration at which the row converged


def fminadam(f_value_and_grad: Callable, x0: torch.Tensor, lb=None, ub=None,
             tol_fun: float = 1e-3, maxiter: int = 1000,
             step_min: float = 0.001, step_max: float = 0.1,
             step_decay: float = 200.0, batch_size: int = 20):
    """Adam with the reference's decayed step size and slope-based stopping
    (`utils/fminadam.m`), over a batch of starts x0 (B, P). Each row freezes
    at its own convergence; the loop ends when all rows have.

    ``f_value_and_grad(x (B, P), it) -> (value (B,), grad (B, P))``; ``it``
    lets stochastic objectives draw fresh noise per step.
    """
    B, P = x0.shape
    dt, dev = x0.dtype, x0.device
    beta1, beta2 = 0.9, 0.999
    eps = math.sqrt(torch.finfo(dt).eps)
    tol_x, tol_x_max = 0.001, 0.1
    tol_fun_max = tol_fun * 100.0
    min_iter = batch_size * 2
    lb = torch.full((P,), -math.inf, dtype=dt, device=dev) if lb is None else lb
    ub = torch.full((P,), math.inf, dtype=dt, device=dev) if ub is None else ub

    xxp = torch.linspace(-(batch_size - 1) / 2.0, (batch_size - 1) / 2.0,
                         batch_size, dtype=dt, device=dev)
    sxx = (xxp * xxp).sum()
    xtab = torch.zeros((B, maxiter, P), dtype=dt, device=dev)
    ftab = torch.full((B, maxiter), math.inf, dtype=dt, device=dev)
    x = x0.clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    n_frozen = torch.full((B,), maxiter, dtype=torch.long, device=dev)

    for it in range(maxiter):
        value, grad = f_value_and_grad(x, it)
        m_new = beta1 * m + (1 - beta1) * grad
        v_new = beta2 * v + (1 - beta2) * grad * grad
        t = it + 1
        mhat = m_new / (1 - beta1 ** t)
        vhat = v_new / (1 - beta2 ** t)
        stepsize = step_min + (step_max - step_min) * math.exp(-t / step_decay)
        x_new = x - stepsize * mhat / (torch.sqrt(vhat) + eps)
        x_new = torch.minimum(torch.maximum(x_new, lb), ub)
        xtab[:, it] = torch.where(frozen[:, None], xtab[:, it], x_new)
        ftab[:, it] = torch.where(frozen, ftab[:, it], value)

        newly = torch.zeros_like(frozen)
        if (it + 1) % batch_size == 0 and it + 1 >= min_iter:
            fw = ftab[:, it - batch_size + 1:it + 1]
            fc = fw - fw.mean(1, keepdim=True)
            slope = (xxp * fc).sum(1) / sxx
            resid = fc - slope[:, None] * xxp
            se2 = (resid * resid).sum(1) / max(batch_size - 2, 1) / sxx
            slope_err = torch.sqrt(se2 + tol_fun ** 2)
            slope_err_max = torch.sqrt(se2 + tol_fun_max ** 2)
            xw_now = xtab[:, it - batch_size + 1:it + 1].mean(1)
            xw_prev = xtab[:, it - 2 * batch_size + 1:it - batch_size + 1].mean(1)
            dx = torch.sqrt(((xw_now - xw_prev) ** 2).sum(-1) / batch_size)
            conv = (((dx < tol_x) & (slope.abs() < slope_err_max))
                    | ((slope.abs() < slope_err) & (dx < tol_x_max)))
            newly = conv & ~frozen
            n_frozen = torch.where(newly, it + 1, n_frozen)
        keep = frozen & ~newly
        x = torch.where(keep[:, None], x, x_new)
        m = torch.where(keep[:, None], m, m_new)
        v = torch.where(keep[:, None], v, v_new)
        frozen = frozen | newly
        if (it + 1) % batch_size == 0 and bool(frozen.all()):
            break

    last = n_frozen.clamp(max=maxiter)
    idx = torch.arange(maxiter, device=dev)
    in_window = (idx[None, :] >= (last - batch_size)[:, None]) & \
        (idx[None, :] < last[:, None])
    wgt = in_window.to(dt)
    wgt = wgt / wgt.sum(1, keepdim=True).clamp_min(1.0)
    x_avg = (xtab * wgt[:, :, None]).sum(1)
    f_avg = torch.where(in_window, ftab, 0.0).sum(1) / \
        in_window.sum(1).clamp_min(1)
    return AdamResult(x=x_avg, f=f_avg, x_trace=xtab, f_trace=ftab,
                      n_iters=last)
