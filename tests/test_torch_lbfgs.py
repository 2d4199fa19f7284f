"""The port's bounded L-BFGS as trips (`vbmc_tpu_torch/optim.py`,
`LBFGSStarts`) on the CPU: the batch against the loop it replaced (a
list history, every row waiting for the slowest line search), each row of a
batch against the same row alone, rows that stop at different iterations,
use up their 30 trials or start non-finite, the ring's two-loop recursion
against a list history, a trip past every row's end, the span, and the
Cholesky that the GP objective differentiates through without a host read
(`gp/core._factor_or_identity`). The comparison with the JAX package's
optimiser is in `tests/test_torch_samplers.py`; the captured graph's
tests, on the card, in `tests/test_torch_lbfgs_graph.py`."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import tracing
from vbmc_tpu_torch.gp import core
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, _objective, \
    assemble_hyp_prior
from vbmc_tpu_torch.optim import (LBFGSStarts, _to_bounded, _to_unbounded,
                                  _two_loop, minimize_lbfgs_bounded,
                                  value_and_grad)
from vbmc_tpu_torch.utils.math import pad_to

torch.set_num_threads(1)


# ------------------------------------------------ the loop it replaced

def _list_two_loop(g, S_h, Y_h, rho):
    """The two-loop recursion over a list history (oldest first) that the
    ring replaced."""
    q = g.clone()
    alphas = []
    for s, y, r in zip(reversed(S_h), reversed(Y_h), reversed(rho)):
        a = r * (s * q).sum(-1)
        q = q - a[:, None] * y
        alphas.append(a)
    gamma = torch.ones_like(g[:, 0])
    for s, y, r in zip(reversed(S_h), reversed(Y_h), reversed(rho)):
        cand = (s * y).sum(-1) / (y * y).sum(-1).clamp_min(1e-300)
        unset = gamma == 1.0
        gamma = torch.where(unset & (r > 0), cand, gamma)
    q = q * gamma[:, None]
    for (s, y, r), a in zip(zip(S_h, Y_h, rho), reversed(alphas)):
        b = r * (y * q).sum(-1)
        q = q + s * (a - b)[:, None]
    return q


def _list_lbfgs(f, x0, lb, ub, maxiter, history=10, gtol=1e-9):
    """The loop the trips replaced: one iteration of every row at a time,
    each line search waiting for the slowest row's, the history in lists."""
    lb, ub = lb.expand_as(x0), ub.expand_as(x0)

    def g_obj(z):
        return f(_to_bounded(z, lb, ub))

    z = _to_unbounded(torch.minimum(torch.maximum(x0, lb), ub), lb, ub)
    v, g = value_and_grad(g_obj, z)
    ok0 = torch.isfinite(v) & torch.isfinite(g).all(-1)
    v = torch.where(ok0, v, math.inf)
    g = torch.where(ok0[:, None], g, 0.0)
    active = ok0.clone()
    zbest, fbest = z.clone(), v.clone()
    S_h, Y_h, rho = [], [], []
    for _ in range(maxiter):
        if not bool(active.any()):
            break
        d = -_list_two_loop(g, S_h, Y_h, rho)
        gd = (g * d).sum(-1)
        bad_dir = ~(gd < 0)
        d = torch.where(bad_dir[:, None], -g, d)
        gd = torch.where(bad_dir, -(g * g).sum(-1), gd)
        t = torch.ones_like(v) if S_h else \
            (1.0 / g.abs().sum(-1).clamp_min(1e-300)).clamp(max=1.0)
        accept = ~active
        z_new, v_new, g_new = z.clone(), v.clone(), g.clone()
        for _ls in range(30):
            z_try = z + t[:, None] * d
            v_try, g_try = value_and_grad(g_obj, z_try)
            ok = (torch.isfinite(v_try) & torch.isfinite(g_try).all(-1)
                  & (v_try <= v + 1e-4 * t * gd))
            newly = ok & ~accept
            z_new = torch.where(newly[:, None], z_try, z_new)
            v_new = torch.where(newly, v_try, v_new)
            g_new = torch.where(newly[:, None], g_try, g_new)
            accept = accept | newly
            if bool(accept.all()):
                break
            t = torch.where(accept, t, 0.5 * t)
        moved = accept & active
        s = torch.where(moved[:, None], z_new - z, 0.0)
        y = torch.where(moved[:, None], g_new - g, 0.0)
        sy = (s * y).sum(-1)
        S_h.append(s)
        Y_h.append(y)
        rho.append(torch.where(moved & (sy > 1e-10),
                               1.0 / sy.clamp_min(1e-300), 0.0))
        if len(S_h) > history:
            S_h.pop(0), Y_h.pop(0), rho.pop(0)
        z, v, g = z_new, v_new, g_new
        improved = moved & (v < fbest)
        zbest = torch.where(improved[:, None], z, zbest)
        fbest = torch.where(improved, v, fbest)
        active = moved & (g.abs().amax(-1) > gtol)
    return _to_bounded(zbest, lb, ub), fbest


# ------------------------------------------------------------ problems

def _rosenbrock(x):
    """A 4-D Rosenbrock function of each row: separable by rows, and each
    row's value and gradient are the same in any batch."""
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
            + (1.0 - x[:, :-1]) ** 2).sum(-1)


def _rosen_problem():
    rng = np.random.default_rng(11)
    x0 = torch.as_tensor(rng.uniform(-1.5, 1.5, (5, 4)))
    lb = torch.full((4,), -2.0, dtype=torch.float64)
    ub = torch.tensor([2.0, 2.0, math.inf, math.inf], dtype=torch.float64)
    lb[3] = -math.inf
    return _rosenbrock, x0, lb, ub


def _gp_problem(D=3, n=40, nb=64, user_noise=1):
    """GP training's MAP objective (`gp.fit._objective`) on a noisy D-dim
    training set padded to nb, from the prior's start and three draws in
    its plausible box."""
    rng = np.random.default_rng(D)
    cfg = GPConfig(D=D, user_noise=user_noise)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.1 * rng.standard_normal(n)
    prior, x0 = assemble_hyp_prior(
        cfg, X, y, np.full(D, -2.0), np.full(D, 2.0),
        TrainOptions(uncertainty_level=2 if user_noise else 0), device="cpu")

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64)

    s2 = t(np.full(nb, 0.01)) if user_noise else None
    obj = _objective(cfg, prior, t(pad_to(X, nb)), t(pad_to(y, nb)), s2,
                     torch.arange(nb) < n)
    plb, pub = prior.plb.numpy(), prior.pub.numpy()
    starts = t(np.stack([x0] + [plb + rng.random(cfg.nhyp) * (pub - plb)
                                for _ in range(3)]))
    return obj, starts, prior.lb, prior.ub


PROBLEMS = {"rosenbrock_box": _rosen_problem, "gp_map": _gp_problem}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("maxiter", [7, 80])
def test_the_trips_give_the_loops_iterates(problem, maxiter):
    """Rows that advance on their own reach the points the loop with a
    list history and a shared line search reached, to the last bit."""
    f, x0, lb, ub = PROBLEMS[problem]()
    want = _list_lbfgs(f, x0, lb, ub, maxiter)
    got = minimize_lbfgs_bounded(f, x0, lb, ub, maxiter=maxiter)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_each_row_gives_what_it_gives_alone():
    """A row's point and value do not depend on the other rows of its
    batch, whose searches take other numbers of trials and iterations. To
    rounding only: the CPU's vector loops and their scalar tails round a
    few elementwise functions differently, so a row's last bits depend on
    where it sits in the batch."""
    f, x0, lb, ub = _rosen_problem()
    st = LBFGSStarts(f, x0, lb, ub, 80)
    st.run()
    x, fx = st.result()
    assert len(set(st.n_iter.tolist())) > 1
    for i in range(x0.shape[0]):
        xi, fi = minimize_lbfgs_bounded(f, x0[i:i + 1], lb, ub, maxiter=80)
        torch.testing.assert_close(xi[0], x[i], rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(fi[0], fx[i], rtol=1e-10, atol=1e-20)


def _stubborn(x0):
    """A quadratic whose every point but the row's start is +inf: the
    row's line search fails 30 times and it stays at its start."""
    def f(x):
        at_start = (x == x0).all(-1)
        return torch.where(at_start, 0.0, math.inf) + (x * x).sum(-1)
    return f


def _mixed(x):
    """Row 0 a quadratic (stops on gtol within a few iterations), row 1
    Rosenbrock (runs to maxiter), row 2 stubborn (30 trials), row 3 NaN
    at its start (never searches)."""
    q = ((x - 0.25) ** 2).sum(-1)
    r = _rosenbrock(x)
    x0 = torch.tensor([0.5, -0.5, 0.5, -0.5], dtype=x.dtype)
    stub = _stubborn(x0)(x)
    rows = torch.arange(x.shape[0])
    out = torch.where(rows == 0, q, torch.where(rows == 1, r, stub))
    return torch.where(rows == 3, math.nan, out)


def test_rows_stop_at_their_own_ends():
    """Rows stopping on gtol, at maxiter, after 30 failed trials and at a
    non-finite start, in one batch; the trips are as many as the longest
    row needs, and a trip past every row's end changes nothing."""
    x0 = torch.tensor([[1.0, 1.0, -1.0, 0.0], [-1.2, 1.0, 0.3, 0.1],
                       [0.5, -0.5, 0.5, -0.5], [0.1, 0.2, 0.3, 0.4]],
                      dtype=torch.float64)
    inf = torch.full((4,), math.inf, dtype=torch.float64)
    st = LBFGSStarts(_mixed, x0, -inf, inf, maxiter=25)
    assert st.searching.tolist() == [True, True, True, False]
    st.run()
    assert not bool(st.busy) and not st.searching.any()
    n_iter, n_trial = st.n_iter.tolist(), st.n_trial.tolist()
    assert 0 < n_iter[0] < 25 and n_iter[1] == 25
    assert n_iter[2] == 0 and n_trial[2] == 30
    assert n_iter[3] == 0
    assert st.trips >= 30 and st.trips >= n_iter[1]
    x, f = st.result()
    torch.testing.assert_close(x[0], torch.full((4,), 0.25,
                                                dtype=torch.float64))
    torch.testing.assert_close(x[2], x0[2], rtol=0, atol=0)
    assert f[2] == 1.0 and f[3] == math.inf
    torch.testing.assert_close(x[3], x0[3], rtol=0, atol=0)
    torch.testing.assert_close(f[1], _rosenbrock(x[1:2])[0], rtol=0, atol=0)
    # the same rows, one at a time
    for i in range(4):
        xi, fi = minimize_lbfgs_bounded(_mixed_row(i), x0[i:i + 1], -inf,
                                        inf, maxiter=25)
        torch.testing.assert_close(xi[0], x[i], rtol=0, atol=0)
        torch.testing.assert_close(fi[0], f[i], rtol=0, atol=0)
    # a trip past every row's end
    before = {k: v.clone() for k, v in vars(st).items()
              if isinstance(v, torch.Tensor)}
    st.trip()
    for k, v in before.items():
        torch.testing.assert_close(getattr(st, k), v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def _mixed_row(i):
    def f(x):
        full = x.new_zeros((4, x.shape[1]))
        full[i] = x[0]
        return _mixed(full)[i:i + 1]
    return f


@pytest.mark.parametrize("filled", [(0, 0, 0), (1, 4, 10), (10, 3, 7)])
def test_the_rings_two_loop_equals_a_list_history(filled):
    """Seeded pairs, some with rho 0, in rings filled to different depths
    (empty slots first): the ring's recursion gives the list history's
    direction."""
    B, H, P = 3, 10, 6
    gen = torch.Generator().manual_seed(sum(filled) + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    g = randn(B, P)
    S, Y = randn(B, H, P), randn(B, H, P)
    Y = Y + 2.0 * S                       # mostly s.y > 0
    sy = (S * Y).sum(-1)
    rho = torch.where(sy > 1e-10, 1.0 / sy.clamp_min(1e-300), 0.0)
    rho[:, 2] = 0.0                       # a pair kept with rho 0
    depth = torch.tensor(filled)[:, None]
    empty = torch.arange(H)[None, :] < H - depth
    S = torch.where(empty[..., None], 0.0, S)
    Y = torch.where(empty[..., None], 0.0, Y)
    rho = torch.where(empty, 0.0, rho)
    got = _two_loop(g, S, Y, rho)
    for b in range(B):
        k = H - filled[b]
        want = _list_two_loop(g[b:b + 1],
                              [S[b:b + 1, i] for i in range(k, H)],
                              [Y[b:b + 1, i] for i in range(k, H)],
                              [rho[b:b + 1, i] for i in range(k, H)])
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-13, atol=0)
    assert torch.equal(got[0], g[0]) or filled[0] > 0


def test_a_call_opens_capture_and_keeps_its_trips(monkeypatch):
    """The span "capture" (on the CPU the starts' first evaluation), and
    the trips of the call on the object."""
    f, x0, lb, ub = _rosen_problem()
    made = []
    real = LBFGSStarts.__init__

    def keep(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(LBFGSStarts, "__init__", keep)
    tr = tracing.Tracer()
    with tr.current(), tracing.span("map"):
        minimize_lbfgs_bounded(f, x0, lb, ub, maxiter=12)
    assert {"map", "map.capture"} == set(tr.totals())
    (st,) = made
    assert st.trips >= int(st.n_iter.max()) and int(st.n_iter.max()) == 12


# ------------------------------------- the Cholesky without a host read

def _spd_batch(n=6, bad=(1, 3)):
    gen = torch.Generator().manual_seed(4)
    A = torch.randn((5, n, n), generator=gen, dtype=torch.float64)
    B = A @ A.mT + n * torch.eye(n, dtype=torch.float64)
    for i in bad:
        B[i, 0, 0] = -1.0                 # not positive definite
    return B


def _logdet_and_solve(L, r):
    a = torch.cholesky_solve(r[..., None], L)[..., 0]
    return (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * (r * a).sum(-1))


def test_factor_or_identity_differentiates_like_cholesky():
    """Rows that factor give torch.linalg.cholesky's value and gradient to
    1e-12; failed rows the identity, no NaN, and a zero gradient; the
    no-gradient branch the same factors."""
    B = _spd_batch().requires_grad_(True)
    r = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64).expand(5, 6)
    L, ok = core._factor_or_identity(B)
    assert ok.tolist() == [True, False, True, False, True]
    v = torch.where(ok, _logdet_and_solve(L, r), math.inf)
    (gB,) = torch.autograd.grad(v.sum(), B)
    good = ok.nonzero()[:, 0]
    Bg = B.detach()[good].requires_grad_(True)
    v_ref = _logdet_and_solve(torch.linalg.cholesky(Bg), r[good])
    (g_ref,) = torch.autograd.grad(v_ref.sum(), Bg)
    torch.testing.assert_close(v[good], v_ref.detach(), rtol=1e-12, atol=0)
    torch.testing.assert_close(gB[good], g_ref, rtol=1e-12, atol=1e-15)
    assert torch.isinf(v[~ok]).all()
    assert torch.equal(gB[~ok], torch.zeros_like(gB[~ok]))
    eye = torch.eye(6, dtype=torch.float64)
    assert torch.equal(L.detach()[~ok], eye.expand(2, 6, 6))
    L0, ok0 = core._factor_or_identity(B.detach())
    assert torch.equal(L0, L.detach()) and torch.equal(ok0, ok)


def test_the_nll_gradient_is_zero_where_the_factor_fails():
    """GP training's objective on a batch where one row's system matrix
    cannot be factored: that row's value is the objective's cap and its
    gradient zero; the other rows are as they are alone."""
    f, starts, lb, ub = _gp_problem(user_noise=0)
    h = starts.clone()
    h[1, :3] = 5.0                        # long length scales and almost
    h[1, 4] = -30.0                       # no noise: a singular matrix
    v, g = value_and_grad(f, h)
    assert v[1] == 1e12 and torch.equal(g[1], torch.zeros_like(g[1]))
    for i in (0, 2, 3):
        vi, gi = value_and_grad(f, h[i:i + 1])
        torch.testing.assert_close(vi[0], v[i], rtol=1e-12, atol=0)
        torch.testing.assert_close(gi[0], g[i], rtol=1e-12, atol=1e-15)
