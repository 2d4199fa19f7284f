"""The slice sampler's CUDA graph on the card (`samplers/slice.py`): each
test is marked `cuda` and skips without a GPU. At the full update's shape
in the noisy cell (8 chains, 12 hyperparameters, N in the 256 bucket), and
at that N for every other GP configuration whose training the slice
sampler runs, the replayed graph gives the plain loop's samples and log
densities from one seed, with one capture a call and one flag read a
replay; a log density that reads the host makes the capture raise; and
the variational parameters' slice sampler captures its log density too.
No JAX here: the comparison is with the port's own plain loop on the
card, on the same linear algebra library."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions, tracing
from vbmc_tpu_torch.gp import core
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, assemble_hyp_prior
from vbmc_tpu_torch.graphs import _cusolver
from vbmc_tpu_torch.samplers import slice as slice_mod
from vbmc_tpu_torch.samplers.slice import SliceChains, slice_sample_chains
from vbmc_tpu_torch.utils.math import pad_to


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m cuda "
                    "tests/test_torch_slice_graph.py` on the card")
    return torch.device("cuda")


# The GP configurations, besides the full update's, whose training the
# slice sampler runs (nhyp <= 20): each integrated mean, an output warp,
# output-dependent noise and a fitted user-noise scale.
GP_VARIANTS = {"full_update": {}, "intmean1": dict(intmean=1),
               "intmean2": dict(intmean=2), "intmean3": dict(intmean=3),
               "outwarp": dict(outwarp=1), "output_noise": dict(output_noise=1),
               "user_noise2": dict(user_noise=2)}


def _full_update(dev, C=8, D=3, n=210, nb=256, **cfg_kw):
    """GP training's log density as `gp.fit.map_sample_assemble_core`
    samples it, on a noisy D=3 training set of n points padded to nb (the
    negquad mean and user noise: 12 hyperparameters, unless ``cfg_kw``
    sets more of the `GPConfig`), C chain starts around the prior's
    starting point, and the widths of its plausible box."""
    rng = np.random.default_rng(3)
    cfg = GPConfig(D=D, **{"user_noise": 1, **cfg_kw})
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.3 * rng.standard_normal(n)
    prior, x0 = assemble_hyp_prior(cfg, X, y, np.full(D, -2.0),
                                   np.full(D, 2.0),
                                   TrainOptions(uncertainty_level=2),
                                   device=dev)

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    Xp, yp, s2 = t(pad_to(X, nb)), t(pad_to(y, nb)), t(np.full(nb, 0.09))
    mask = torch.arange(nb, device=dev) < n
    widths = torch.clamp_min(torch.where(
        torch.isfinite(prior.pub - prior.plb), prior.pub - prior.plb,
        prior.ub - prior.lb), 1e-3)
    starts = t(x0)[None] + 0.01 * widths * t(rng.standard_normal(
        (C, cfg.nhyp)))
    starts = torch.minimum(torch.maximum(starts, prior.lb + 1e-10),
                           prior.ub - 1e-10)

    def logpdf(h):
        lp = core.gp_log_posterior(cfg, prior, h, Xp, yp, s2, mask)
        inside = ((h >= prior.lb) & (h <= prior.ub)).all(-1)
        return torch.where(inside & torch.isfinite(lp), lp, -torch.inf)

    assert cfg.nhyp == 12 or cfg_kw
    return logpdf, starts, widths, prior


def _sample(dev, problem, seed=5):
    logpdf, starts, widths, prior = problem
    with torch.no_grad():
        return slice_sample_chains(
            torch.Generator(device=dev).manual_seed(seed), logpdf, starts,
            widths, prior.lb, prior.ub, n_keep=2, burn=1, thin=1,
            n_keep_max=2)


def _plain(dev, problem, monkeypatch):
    """The same call with nothing captured: the plain loop on the card."""
    with monkeypatch.context() as mp:
        mp.setattr(SliceChains, "capture", lambda self: None)
        return _sample(dev, problem)


def _same(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(GP_VARIANTS))
def test_graph_gives_the_plain_loops_samples(monkeypatch, variant):
    """The graph, captured once, replayed as often as the chains need,
    against the plain loop on the same uniforms: the span "tail" holds the
    replays after each update's first, since an update takes two trips at
    least. Both run their batched solves through cuSOLVER, as a capture
    does, so that they run the same kernels."""
    dev = _card()
    problem = _full_update(dev, **GP_VARIANTS[variant])
    with _cusolver():
        want = _plain(dev, problem, monkeypatch)
    graphs = []
    real = slice_mod.Graph

    def counted(*args, **kwargs):
        graphs.append(real(*args, **kwargs))
        return graphs[-1]

    monkeypatch.setattr(slice_mod, "Graph", counted)
    tr = tracing.Tracer()
    with tr.current(), tracing.span("sample"), _cusolver():
        got = _sample(dev, problem)
    _same(got, want)
    assert torch.isfinite(got[1]).all()
    assert len(graphs) == 1
    spans = tr.totals()
    assert "sample.capture" in spans and "sample.tail" in spans


@pytest.mark.cuda
def test_an_update_reads_one_flag_a_replay(monkeypatch):
    """Each coordinate update reads the device once a replay and nothing
    else: no `item`, no `nonzero`, no copy to the host."""
    dev = _card()
    logpdf, starts, widths, prior = _full_update(dev)
    with torch.no_grad():
        ch = SliceChains(torch.Generator(device=dev).manual_seed(2), logpdf,
                         starts, widths, prior.lb, prior.ub, 24)
        ch.capture()
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
            for _ in range(24):
                ch.coordinate()
    assert sum(reads) == sum(ch.counts) and max(ch.counts) > 1
    assert int(ch.k) == 23


@pytest.mark.cuda
def test_the_variational_slice_sampler_captures():
    """`vp_sample_theta` with the slice sampler runs its negative ELBO as
    the graph's log density."""
    from vbmc_tpu_torch import bench_kernels as tbk
    from vbmc_tpu_torch.vpoptim import vp_sample_theta

    dev = _card()
    inp = tbk.build_inputs(32, 4, 4, 256, dev)
    out = vp_sample_theta(torch.Generator(device=dev).manual_seed(0),
                          inp.cfg, inp.vp, inp.gp, 2,
                          VBMCOptions().resolve(tbk.D), sampler="slice")
    assert torch.isfinite(out.mu).all() and torch.isfinite(out.sigma).all()
    assert not torch.equal(out.mu, inp.vp.mu)


@pytest.mark.cuda
def test_a_log_density_that_reads_the_host_makes_the_capture_raise(
        monkeypatch):
    dev = _card()
    logpdf, starts, widths, prior = _full_update(dev)

    def syncing(h):
        lp = logpdf(h)
        if lp.max().item() > 1e300:
            return lp * 0.0
        return lp

    with pytest.raises(RuntimeError):
        _sample(dev, (syncing, starts, widths, prior))
    # the card still works, and the plain loop takes such a density
    _plain(dev, (syncing, starts, widths, prior), monkeypatch)
