"""The bounded L-BFGS's CUDA graph on the card (`optim.LBFGSStarts`): each
test is marked `cuda` and skips without a GPU. At the shapes of GP
training in `d10k50.late` (D=10, the negquad mean's 33 hyperparameters, N in
the 256 bucket, one start, 80 iterations) and of the full update's polish
in `ibs3.late` (D=3, user noise, 30 iterations), the replayed trip gives
the eager trip's point and value, with one capture a call and one flag
read a trip; an objective that reads the host makes the capture raise (in
a process of its own); another thread's copies to and from the card
neither break a capture nor fail; the variational fit's objective, `vp_mode`'s and
`gp_fmin`'s capture; and the Cholesky that GP training differentiates
through captures with a failed row in its batch. No JAX here: the comparison is with the port's
own eager trips on the card, on the same linear algebra library."""

from __future__ import annotations

import math
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions, optim, tracing
from vbmc_tpu_torch.gp import core
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, _objective, \
    assemble_hyp_prior
from vbmc_tpu_torch.graphs import Graph, _cusolver
from vbmc_tpu_torch.optim import LBFGSStarts, minimize_lbfgs_bounded, \
    value_and_grad
from vbmc_tpu_torch.utils.math import pad_to


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m cuda "
                    "tests/test_torch_lbfgs_graph.py` on the card")
    return torch.device("cuda")


# GP training's MAP in d10k50.late and the full update's polish in ibs3.late
SHAPES = {"d10k50_map": dict(D=10, n=230, user_noise=0, maxiter=80),
          "ibs3_polish": dict(D=3, n=210, user_noise=1, maxiter=30)}


def _problem(dev, D, n, user_noise, maxiter, nb=256):
    """GP training's MAP objective (`gp.fit._objective`) on n points of a
    D-dim Gaussian log density (with user noise of SD 0.3 where
    ``user_noise``) padded to nb, from the prior's starting point."""
    rng = np.random.default_rng(D)
    cfg = GPConfig(D=D, user_noise=user_noise)
    X = rng.uniform(-3, 3, (n, D))
    sd = np.linspace(0.5, 2.0, D)
    y = -0.5 * np.sum((X / sd) ** 2, 1)
    if user_noise:
        y = y + 0.3 * rng.standard_normal(n)
    prior, x0 = assemble_hyp_prior(
        cfg, X, y, np.full(D, -3.0), np.full(D, 3.0),
        TrainOptions(uncertainty_level=2 if user_noise else 0), device=dev)

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    s2 = t(np.full(nb, 0.09)) if user_noise else None
    obj = _objective(cfg, prior, t(pad_to(X, nb)), t(pad_to(y, nb)), s2,
                     torch.arange(nb, device=dev) < n)
    return obj, t(x0)[None], prior.lb, prior.ub, maxiter


def _kept(monkeypatch):
    """Every `LBFGSStarts` and every `Graph` the L-BFGS makes, in order."""
    made = dict(starts=[], graphs=[])
    init = LBFGSStarts.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made["starts"].append(self)

    def graph(*args, **kwargs):
        made["graphs"].append(Graph(*args, **kwargs))
        return made["graphs"][-1]

    monkeypatch.setattr(LBFGSStarts, "__init__", keep)
    monkeypatch.setattr(optim, "Graph", graph)
    return made


def _eager(monkeypatch, *args, **kwargs):
    """The same call with nothing captured: the trips run eagerly."""
    with monkeypatch.context() as mp:
        mp.setattr(LBFGSStarts, "capture", lambda self: None)
        return minimize_lbfgs_bounded(*args, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_graph_gives_the_eager_trips_point(monkeypatch, shape):
    """The graph, captured once, replayed until no row searches, against
    the eager trips; both run their solves through cuSOLVER, as a capture
    does, the starts' first evaluation too, so that they run the same
    kernels. The span "capture" opens
    inside the call's."""
    dev = _card()
    f, x0, lb, ub, maxiter = _problem(dev, **SHAPES[shape])
    with _cusolver():
        want = _eager(monkeypatch, f, x0, lb, ub, maxiter=maxiter)
    made = _kept(monkeypatch)
    tr = tracing.Tracer()
    with tr.current(), tracing.span("map"), _cusolver():
        got = minimize_lbfgs_bounded(f, x0, lb, ub, maxiter=maxiter)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)
    assert torch.isfinite(got[1]).all()
    assert len(made["graphs"]) == 1
    (st,) = made["starts"]
    assert st.trips > int(st.n_iter.max()) > 1
    assert set(tr.totals()) == {"map", "map.capture"}


@pytest.mark.cuda
def test_a_call_reads_one_flag_a_trip(monkeypatch):
    """After the capture, the call reads the device once a trip and
    nothing else: no `item`, no `nonzero`, no copy to the host."""
    dev = _card()
    f, x0, lb, ub, maxiter = _problem(dev, **SHAPES["ibs3_polish"])
    st = LBFGSStarts(f, x0, lb, ub, maxiter)
    st.capture()
    reads = []
    real_bool = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real_bool(self)

    def boom(*args, **kwargs):
        raise AssertionError("a host read")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "__bool__", counted)
        for name in ("item", "tolist", "cpu", "__float__"):
            mp.setattr(torch.Tensor, name, boom)
        mp.setattr(torch, "nonzero", boom)
        st.run()
    assert len(reads) == st.trips > 1


def _a_host_read_breaks_the_capture():
    """A host read in the objective makes the capture raise; the eager
    trips take such an objective."""
    f, x0, lb, ub, maxiter = _problem(torch.device("cuda"),
                                      **SHAPES["ibs3_polish"])

    def syncing(h):
        v = f(h)
        if v.max().item() > 1e300:
            return v * 0.0
        return v

    with pytest.raises(RuntimeError):
        minimize_lbfgs_bounded(syncing, x0, lb, ub, maxiter=maxiter)
    capture = LBFGSStarts.capture
    LBFGSStarts.capture = lambda self: None
    try:
        x, fx = minimize_lbfgs_bounded(syncing, x0, lb, ub, maxiter=maxiter)
    finally:
        LBFGSStarts.capture = capture
    assert torch.isfinite(fx).all()


@pytest.mark.cuda
def test_an_objective_that_reads_the_host_makes_the_capture_raise():
    """In a process of its own: a capture that a host read breaks off
    leaves the allocator recording into the graph pool that every capture
    of the process shares, so no later capture there would succeed."""
    _card()
    child = ("import importlib.util, sys; "
             "spec = importlib.util.spec_from_file_location('t', sys.argv[1]); "
             "m = importlib.util.module_from_spec(spec); "
             "spec.loader.exec_module(m); m._a_host_read_breaks_the_capture()")
    done = subprocess.run([sys.executable, "-c", child, __file__],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr


@pytest.mark.cuda
def test_another_threads_copies_leave_the_capture_whole():
    """While another thread copies to and from the card in a loop, as a
    sweep's thread that loads its runs' results does, every call captures
    its graph and reaches a finite minimum, and every copy succeeds."""
    dev = _card()
    f, x0, lb, ub, maxiter = _problem(dev, **SHAPES["ibs3_polish"])
    stop = threading.Event()
    errors, copies = [], [0]
    a = np.arange(4096.0)

    def copier():
        try:
            while not stop.is_set():
                t = torch.as_tensor(a, device=dev)
                if not np.array_equal(t.cpu().numpy(), a):
                    raise AssertionError("a copy came back changed")
                copies[0] += 1
        except Exception as e:
            errors.append(e)

    thread = threading.Thread(target=copier)
    thread.start()
    try:
        for _ in range(6):
            _, fx = minimize_lbfgs_bounded(f, x0, lb, ub, maxiter=maxiter)
            assert torch.isfinite(fx).all()
    finally:
        stop.set()
        thread.join()
    assert not errors, errors
    assert copies[0] > 0


@pytest.mark.cuda
def test_the_variational_and_query_objectives_capture(monkeypatch):
    """The variational fit's L-BFGS (`vpoptim._lbfgs_eval_batch`, the
    negative ELCBO with the entropy's lower bound), `vp_mode` and
    `gp_fmin` each capture one graph and move their starts."""
    from vbmc_tpu_torch import bench_kernels as tbk
    from vbmc_tpu_torch import elbo as eb
    from vbmc_tpu_torch.gp.sample import gp_fmin
    from vbmc_tpu_torch.vp import vp_mode
    from vbmc_tpu_torch.vpoptim import VPTemplate, _lbfgs_eval_batch

    dev = _card()
    inp = tbk.build_inputs(32, 4, 4, 256, dev)
    vp, gp = inp.vp, inp.gp
    flags = eb.VPFlags(opt_weights=True)
    eta = torch.where(vp.kmask, torch.log(vp.w), -40.0)
    theta0s = eb.pack_theta(flags, vp.mu[None], vp.sigma[None],
                            vp.lam[None], eta[None]).repeat(2, 1)
    theta0s[1] = theta0s[1] + 0.05
    tmpl = VPTemplate(vp.mu, vp.sigma, vp.lam, vp.w, vp.kmask)
    bnd = eb.compute_vp_bounds(gp, VBMCOptions().resolve(tbk.D), inp.K)
    gen = torch.Generator(device=dev).manual_seed(0)

    def negelcbo(th):
        return eb.negelcbo(inp.cfg, th, gp, *tmpl, flags, 0.0, 0, 0, gen,
                           bnd=bnd, use_bounds=True)[0]

    made = _kept(monkeypatch)
    _, thetas = _lbfgs_eval_batch(inp.cfg, flags, theta0s, gp, tmpl, 0.0,
                                  bnd, gen, 20, 0)
    with torch.no_grad():
        assert (negelcbo(thetas) < negelcbo(theta0s)).all()
    x_mode = vp_mode(vp)
    x_min, f_min = gp_fmin(inp.cfg, gp)
    assert len(made["graphs"]) == 3
    assert torch.isfinite(x_mode).all() and torch.isfinite(x_min).all()
    assert math.isfinite(f_min)


@pytest.mark.cuda
def test_the_cholesky_gradient_captures_with_a_failed_row():
    """`gp.core._factor_or_identity`'s autograd branch inside a graph: the
    replay gives the eager value and gradient, +inf and a zero gradient on
    the row whose matrix is not positive definite."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    A = torch.randn((4, 64, 64), generator=gen, dtype=torch.float64,
                    device=dev)
    B0 = A @ A.mT + 64 * torch.eye(64, dtype=torch.float64, device=dev)
    B0[2, 0, 0] = -1.0
    r = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64, device=dev)

    def f(B):
        L, ok = core._factor_or_identity(B)
        a = torch.cholesky_solve(r.expand(4, 64)[..., None], L)[..., 0]
        v = (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
             + 0.5 * (r * a).sum(-1))
        return torch.where(ok, v, math.inf)

    def vg(B):
        with torch.enable_grad():
            Bg = B.detach().requires_grad_(True)
            v = f(Bg)
            (g,) = torch.autograd.grad(v.sum(), Bg)
        return v.detach(), g

    with _cusolver():
        v_want, g_want = vg(B0)
    out = {}

    def step():
        out["v"], out["g"] = vg(B0)

    graph = Graph(step, dev)
    graph.replay()
    torch.testing.assert_close(out["v"], v_want, rtol=1e-12, atol=0)
    torch.testing.assert_close(out["g"], g_want, rtol=1e-12, atol=1e-15)
    assert out["v"][2] == math.inf
    assert torch.equal(out["g"][2], torch.zeros_like(out["g"][2]))
    assert torch.isfinite(out["g"]).all()
