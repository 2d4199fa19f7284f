"""The port's user surface against the JAX reference on the same inputs:
serialization across the two packages, the multi-run diagnostics, the
priors, the IBS estimator, the MALA and ensemble samplers, the GP queries
(`gp/sample.py`), the pre-evaluated starting points of `initial_design`,
the command line, the self-test blocks and the package's exports."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vbmc_tpu
import vbmc_tpu_torch
from vbmc_tpu import transforms as jtr
from vbmc_tpu import vp as jvp
from vbmc_tpu_torch import vp as tvp
from vbmc_tpu_torch.convert import gp_from_dict, vp_from_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _vp_pair(seed=0, K=4, D=3, shift=0.0):
    rng = np.random.default_rng(seed)
    jt = jtr.create_trinfo([-np.inf, 0.0, -1.0][:D], [np.inf, np.inf, 3.0][:D],
                           [-2.0, 0.5, -0.5][:D], [2.0, 4.0, 2.5][:D])
    w = rng.random(K) + 0.2
    jv = jvp.make_vp(jt, rng.uniform(-1, 1, (K, D)) + shift,
                     0.3 + 0.3 * rng.random(K), np.ones(D), w=w / w.sum(),
                     k_max=8)
    return jv, vp_from_dict(jax.device_get(jv._asdict()))


# ----------------------------------------------------------------------
# Serialization across the packages
# ----------------------------------------------------------------------

def _pts(n=30, seed=3):
    return np.random.default_rng(seed).uniform([-2, 0.5, -0.5], [2, 4, 2.5],
                                               (n, 3))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_vp_loads_in_the_other_package(writer, tmp_path):
    from vbmc_tpu import serialize as jser
    from vbmc_tpu_torch import serialize as tser
    jv, tv = _vp_pair()
    path = str(tmp_path / "vp.npz")
    if writer == "jax":
        jser.save_vp(path, jv, metadata={"note": "from jax"})
        tv2, meta = tser.load_vp(path, device="cpu")
        jv2 = jv
    else:
        tser.save_vp(path, tv, metadata={"note": "from torch"})
        jv2, meta = jser.load_vp(path)
        tv2 = tv
    assert meta["note"] == f"from {writer}"
    X = _pts()
    np.testing.assert_allclose(
        tvp.vp_pdf(tv2, X, log_flag=True).numpy(),
        np.asarray(jvp.vp_pdf(jv2, jnp.asarray(X), log_flag=True)),
        rtol=1e-12)
    # the port's own round trip, and its dtype on load
    tv3, _ = tser.load_vp(path, device="cpu", dtype=torch.float32)
    assert tv3.mu.dtype == torch.float32 and tv3.trinfo.mu.dtype == torch.float32


def test_load_vp_without_rotoscale_is_the_identity(tmp_path):
    from vbmc_tpu_torch import serialize as tser
    jv, tv = _vp_pair()
    path = str(tmp_path / "vp.npz")
    tser.save_vp(path, tv)
    data = dict(np.load(path))
    del data["tr_R"], data["tr_scale"]
    np.savez(path, **data)
    tv2, meta = tser.load_vp(path, device="cpu")
    assert meta == {}
    np.testing.assert_array_equal(tv2.trinfo.R_mat.numpy(), np.eye(3))
    np.testing.assert_array_equal(tv2.trinfo.scale.numpy(), np.ones(3))
    X = _pts()
    np.testing.assert_allclose(tvp.vp_pdf(tv2, X).numpy(),
                               tvp.vp_pdf(tv, X).numpy(), rtol=1e-14)


def _short_run(pkg, tmp_path):
    """A 12-evaluation run of a package, saved with its `save_result`."""
    D = 2

    def logp(x):
        return float(-0.5 * np.sum(x ** 2))

    kw = dict(x0=np.zeros(D), plb=np.full(D, -2.0), pub=np.full(D, 2.0))
    path = str(tmp_path / f"{pkg}.npz")
    if pkg == "jax":
        from vbmc_tpu.serialize import save_result
        res = vbmc_tpu.vbmc(logp, options=vbmc_tpu.VBMCOptions(
            display="off", max_fun_evals=12, seed=1, min_final_components=2),
            **kw)
    else:
        from vbmc_tpu_torch.serialize import save_result
        res = vbmc_tpu_torch.vbmc(logp, options=vbmc_tpu_torch.VBMCOptions(
            display="off", max_fun_evals=12, seed=1, min_final_components=2),
            device="cpu", **kw)
    save_result(path, res)
    return res, path


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_result_loads_in_the_other_package(writer, tmp_path):
    from vbmc_tpu import serialize as jser
    from vbmc_tpu_torch import serialize as tser
    res, path = _short_run(writer, tmp_path)
    jv, jev, jmeta = jser.load_checkpoint(path)
    tv, tev, tmeta = tser.load_checkpoint(path, device="cpu")
    assert jmeta == tmeta
    assert tmeta["func_count"] == res.func_count
    assert set(jev) == set(tev)
    for k in jev:
        np.testing.assert_array_equal(tev[k], jev[k])
    n = res.logger.Xn
    np.testing.assert_array_equal(tev["X_orig"], res.logger.X_orig[:n])
    np.testing.assert_array_equal(tev["y_orig"], res.logger.y_orig[:n])
    X = np.random.default_rng(0).uniform(-2, 2, (25, 2))
    np.testing.assert_allclose(
        tvp.vp_pdf(tv, X, log_flag=True).numpy(),
        np.asarray(jvp.vp_pdf(jv, jnp.asarray(X), log_flag=True)), rtol=1e-12)


# ----------------------------------------------------------------------
# Diagnostics
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["agree", "disagree", "one"])
def test_vbmc_diagnostics_matches_reference(case):
    from vbmc_tpu.diagnostics import vbmc_diagnostics as jdiag
    from vbmc_tpu_torch.diagnostics import vbmc_diagnostics as tdiag
    if case == "one":
        jv, tv = _vp_pair(0)
        jt, tt = [(jv, -1.0, 0.1)], [(tv, -1.0, 0.1)]
    else:
        shift = 0.05 if case == "agree" else 2.0
        pairs = [_vp_pair(0), _vp_pair(0, shift=shift), _vp_pair(0)]
        elbos = [-1.0, -1.1, -0.95]
        jt = [(p[0], e, 0.1) for p, e in zip(pairs, elbos)]
        tt = [(p[1], e, 0.1) for p, e in zip(pairs, elbos)]
    ref = jdiag(jt)
    got = tdiag(tt)
    assert got.exitflag == ref.exitflag
    assert got.best == ref.best
    assert got.message == ref.message
    np.testing.assert_array_equal(got.elbos, ref.elbos)
    # sKL by Gaussianised moments of 1e5 draws: about 1e-3 of MC error
    # where the runs agree, some percent of values in the hundreds where
    # they do not (heavy tails of the bounded dimension); MTV by KDEs of
    # 1e5 draws
    np.testing.assert_allclose(got.skl_matrix, ref.skl_matrix, atol=0.02,
                               rtol=0.2)
    np.testing.assert_allclose(got.mtv_matrix, ref.mtv_matrix, atol=0.05)


# ----------------------------------------------------------------------
# Priors
# ----------------------------------------------------------------------

PRIORS = {
    "unifbox": ((-1.0, [2.0, 3.0]), ),
    "trapez": ((-1.0, [-0.5, 0.0], [1.0, 2.0], [2.0, 3.0]), ),
    "smoothbox": ((-1.0, [1.0, 2.0], [0.3, 0.6]), ),
    "splinetrapez": ((-1.0, [-0.5, 0.0], [1.0, 2.0], [2.0, 3.0]), ),
}


@pytest.mark.parametrize("name", sorted(PRIORS))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_prior_logpdfs_match_reference(name, as_tensor):
    from vbmc_tpu import priors as jp
    from vbmc_tpu_torch import priors as tp
    (args,) = PRIORS[name]
    x = np.random.default_rng(1).uniform(-1.5, 3.5, (200, 2))
    x[:4] = [[-1.0, 0.0], [2.0, 3.0], [-0.5, 1.0], [1.0, 2.0]]   # edges
    ref = np.asarray(getattr(jp, f"{name}_logpdf")(jnp.asarray(x), *args))
    got = getattr(tp, f"{name}_logpdf")(torch.tensor(x) if as_tensor else x,
                                        *args)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["unifbox", "trapez", "smoothbox"])
def test_prior_samplers_by_moments(name):
    """Both packages' draws against the density's own mean and variance
    (numerical quadrature of the port's log density), within 5 standard
    errors."""
    from vbmc_tpu import priors as jp
    from vbmc_tpu_torch import priors as tp
    (args,) = PRIORS[name]
    n = 40000
    got = getattr(tp, f"{name}_rnd")(torch.Generator().manual_seed(0), n,
                                     *args, D=2).numpy()
    ref = np.asarray(getattr(jp, f"{name}_rnd")(jax.random.PRNGKey(0), n,
                                                *args, D=2))
    g = np.linspace(-4.0, 6.0, 20001)
    for d in range(2):
        pts = np.zeros((g.size, 2))
        pts[:, d] = g
        # the density is separable: the marginal of dimension d up to a
        # constant, from the joint at a fixed point of the other dimension
        fix = 0.5 if d == 0 else 1.5
        pts[:, 1 - d] = fix
        p = np.exp(getattr(tp, f"{name}_logpdf")(pts, *args).numpy())
        p = p / np.trapezoid(p, g)
        mean = np.trapezoid(g * p, g)
        var = np.trapezoid((g - mean) ** 2 * p, g)
        se = np.sqrt(var / n)
        assert abs(got[:, d].mean() - mean) < 5 * se, (d, got[:, d].mean(), mean)
        assert abs(ref[:, d].mean() - mean) < 5 * se
        assert abs(got[:, d].var() - var) < 0.05 * var


def test_log_post_fun_composes():
    from vbmc_tpu import priors as jp
    from vbmc_tpu_torch import priors as tp
    x = np.random.default_rng(2).uniform(-0.5, 1.5, (10, 2))

    def ll(z):
        return -0.5 * (z ** 2).sum(1)

    got = tp.log_post_fun(torch.tensor(x), ll,
                          lambda z: tp.smoothbox_logpdf(z, 0.0, 1.0, 0.2))
    ref = jp.log_post_fun(jnp.asarray(x), ll,
                          lambda z: jp.smoothbox_logpdf(z, 0.0, 1.0, 0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    np.testing.assert_allclose(tp.log_post_fun(x, ll), ll(x))


# ----------------------------------------------------------------------
# IBS, MALA, ensemble slice sampling
# ----------------------------------------------------------------------

def test_ibs_unbiased():
    """`tests/test_aux.py:71` on the port's copy, and the same estimates as
    the reference from the same generator."""
    from vbmc_tpu.utils.ibs import ibs_loglike as j_ibs
    from vbmc_tpu_torch.utils.ibs import ibs_loglike, ibs_loglike_and_sd
    p_true = 0.3
    rng = np.random.default_rng(0)
    responses = (rng.random(50) < p_true).astype(int)

    def sim(params, stimuli, r):
        return (r.random(len(np.atleast_1d(stimuli))) < params[0]).astype(int)

    lls = []
    for i in range(60):
        ll, var = ibs_loglike(sim, [p_true], responses,
                              rng=np.random.default_rng(100 + i))
        lls.append(ll)
        if i < 3:
            assert (ll, var) == j_ibs(sim, [p_true], responses,
                                      rng=np.random.default_rng(100 + i))
    exact = np.sum(np.where(responses == 1, np.log(p_true),
                            np.log(1 - p_true)))
    se = np.std(lls) / np.sqrt(len(lls))
    assert abs(np.mean(lls) - exact) < 4 * se + 1.0
    ll, sd = ibs_loglike_and_sd(sim, [p_true], responses, n_reps=2,
                                rng=np.random.default_rng(7))
    assert np.isfinite(ll) and sd > 0


def test_mala_samples_gaussian():
    """`tests/test_aux.py:28`: a standard 2-D Gaussian, the gradient by
    autograd."""
    from vbmc_tpu_torch.optim import value_and_grad
    from vbmc_tpu_torch.samplers.mala import mala_sample

    def lp_grad(x):
        v, g = value_and_grad(lambda z: -0.5 * (z ** 2).sum(-1), x[None, :])
        return v[0], g[0]

    samples, lps, step = mala_sample(torch.Generator().manual_seed(0),
                                     lp_grad, torch.zeros(2,
                                                          dtype=torch.float64),
                                     4000, step0=0.5, burn=500)
    s = samples.numpy()
    assert samples.shape == (4000, 2) and lps.shape == (4000,)
    assert abs(s.mean()) < 0.1
    assert abs(s.std() - 1.0) < 0.12
    assert 1e-6 <= float(step) <= 1e3
    np.testing.assert_allclose(lps.numpy(), -0.5 * (s ** 2).sum(1))


def test_mala_thinning_selects_the_reference_steps():
    from vbmc_tpu_torch.samplers.mala import mala_sample

    def lp_grad(x):
        return -0.5 * (x ** 2).sum(), -x

    x0 = torch.zeros(1, dtype=torch.float64)
    full, _, _ = mala_sample(torch.Generator().manual_seed(3), lp_grad, x0,
                             30, burn=4)
    thin, _, _ = mala_sample(torch.Generator().manual_seed(3), lp_grad, x0,
                             10, burn=4, thin=3)
    # the same chain: steps burn + 3 i + 2
    np.testing.assert_array_equal(thin.numpy(), full.numpy()[2::3][:10])


def test_ensemble_slice_samples_gaussian():
    """`tests/test_aux.py:42`: 8 walkers on a standard 2-D Gaussian, every
    sweep kept. 1200 sweeps where the reference's test takes 400: eight
    walkers move slowly, and over 400 sweeps either package's mean
    wanders by up to 0.16 between seeds (0.04 over 3000)."""
    from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_sample
    D, W = 2, 8
    x0s = torch.tensor(np.random.default_rng(42).standard_normal((W, D)))
    lo = torch.full((D,), -20.0, dtype=torch.float64)
    walkers, logps = ensemble_slice_sample(
        torch.Generator().manual_seed(1), lambda x: -0.5 * (x ** 2).sum(-1),
        x0s, lo, -lo, n_steps=1200)
    assert walkers.shape == (1200, W, D) and logps.shape == (1200, W)
    s = walkers[100:].reshape(-1, D).numpy()
    assert abs(s.mean()) < 0.1
    assert abs(s.std() - 1.0) < 0.12
    np.testing.assert_allclose(logps.numpy(),
                               -0.5 * (walkers.numpy() ** 2).sum(-1))


# ----------------------------------------------------------------------
# GP queries on a GP carried across by convert.py
# ----------------------------------------------------------------------

def _gp_pair(S=2, n=40, D=2):
    from vbmc_tpu.gp import GPConfig
    from vbmc_tpu.gp.gp import gp_from_host
    from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
    rng = np.random.default_rng(42)
    cfg = GPConfig(D=D)
    X = rng.uniform(-3, 3, (n, D))
    y = -0.5 * np.sum((X - 0.5) ** 2, 1)
    hyp = np.zeros((S, cfg.nhyp))
    hyp[:, :D] = np.log(1.0) + 0.05 * rng.standard_normal((S, D))
    hyp[:, cfg.ncov] = np.log(0.05)
    hyp[:, cfg.ncov + cfg.nnoise + 1 + D:] = np.log(1.5)
    jgp = gp_from_host(cfg, X, y, None, hyp, n_bucket=64, s_bucket=4)
    return cfg, jgp, TGPConfig(D=D), gp_from_dict(jax.device_get(jgp._asdict()))


def test_gp_quantile_pred_matches_reference():
    from vbmc_tpu.gp.sample import gp_quantile_pred as jq
    from vbmc_tpu_torch.gp.sample import gp_quantile_pred as tq
    cfg, jgp, tcfg, tgp = _gp_pair()
    Xs = np.random.default_rng(1).uniform(-4, 4, (30, 2))
    qs = (0.025, 0.25, 0.5, 0.975)
    ref = jq(cfg, jgp, Xs, quantiles=qs)
    got = tq(tcfg, tgp, Xs, quantiles=qs).numpy()
    assert got.shape == (4, 30)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_gp_fmin_matches_reference():
    """The maximum of the mean is inside the box: both packages reach the
    same point. The minimum lies on the box's edge, which the logit
    reparameterisation of either optimiser only approaches: both end below
    their best start, inside the box."""
    from vbmc_tpu.gp.predict import gp_predict
    from vbmc_tpu.gp.sample import gp_fmin as jf
    from vbmc_tpu_torch.gp.sample import gp_fmin as tf
    cfg, jgp, tcfg, tgp = _gp_pair()
    xr, fr = jf(cfg, jgp, maximize=True)
    x, f = tf(tcfg, tgp, maximize=True)
    np.testing.assert_allclose(f, fr, rtol=1e-8)
    np.testing.assert_allclose(x.numpy(), xr, atol=1e-5)
    assert np.linalg.norm(x.numpy() - 0.5) < 0.3
    xr, fr = jf(cfg, jgp, maximize=False)
    x, f = tf(tcfg, tgp, maximize=False)
    X = np.asarray(jgp.X)[np.asarray(jgp.mask)]
    f_start = float(np.min(np.asarray(gp_predict(cfg, jgp, jnp.asarray(X))[0])))
    span = X.max(0) - X.min(0)
    for xx, ff in ((x.numpy(), f), (xr, fr)):
        assert ff < f_start
        assert np.all(xx >= X.min(0) - 0.5 * span - 1e-9)
        assert np.all(xx <= X.max(0) + 0.5 * span + 1e-9)
    np.testing.assert_allclose(f, fr, rtol=0.05)


@pytest.mark.parametrize("posterior", [True, False])
def test_gp_rnd_matches_reference_by_moments(posterior):
    """Joint draws from the first hyperparameter sample (ROADMAP Queue 3
    d): the mean and covariance of 20000 draws in both packages within
    their Monte-Carlo error of each other."""
    from vbmc_tpu.gp.sample import gp_rnd as jr
    from vbmc_tpu_torch.gp.sample import gp_rnd as tr
    cfg, jgp, tcfg, tgp = _gp_pair()
    Xs = np.random.default_rng(2).uniform(-3, 3, (5, 2))
    n = 20000
    ref = jr(cfg, jgp, Xs, key=jax.random.PRNGKey(0), n_draws=n,
             posterior=posterior)
    got = tr(tcfg, tgp, Xs, gen=torch.Generator().manual_seed(0), n_draws=n,
             posterior=posterior).numpy()
    assert got.shape == (n, 5)
    sd = np.sqrt(np.maximum(ref.var(0), 1e-12))
    assert np.all(np.abs(got.mean(0) - ref.mean(0)) < 6 * sd / np.sqrt(n)
                  + 1e-6)
    np.testing.assert_allclose(np.cov(got.T), np.cov(ref.T),
                               atol=0.06 * np.max(np.var(ref, 0)) + 1e-8)


def test_gp_sample_matches_reference_by_moments():
    """Draws from exp(GP mean) by ensemble slice sampling, both packages
    from the same HPD start: they concentrate at the mode (0.5, 0.5), and
    their means and SDs agree within the chains' error."""
    from vbmc_tpu.gp.sample import gp_sample as js
    from vbmc_tpu_torch.gp.sample import gp_sample as ts
    cfg, jgp, tcfg, tgp = _gp_pair()
    ref = js(cfg, jgp, 4000, key=jax.random.PRNGKey(0))
    got = ts(tcfg, tgp, 4000, gen=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == ref.shape == (4000, 2)
    assert np.linalg.norm(got.mean(0) - 0.5) < 0.3
    np.testing.assert_allclose(got.mean(0), ref.mean(0), atol=0.25)
    np.testing.assert_allclose(got.std(0), ref.std(0), rtol=0.25)


# ----------------------------------------------------------------------
# initial_design with pre-evaluated values
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_cache", [7, 40])
def test_initial_design_with_fvals_equals_reference(n_cache):
    """ROADMAP Queue 3 q: with ``fvals`` covering the cache, k-means keeps the
    best member of each cluster, the leftover keeps its values, and the
    target is called at no pre-evaluated point."""
    from vbmc_tpu.active_sample import initial_design as j_init
    from vbmc_tpu.function_logger import FunctionLogger as JL
    from vbmc_tpu_torch.active_sample import initial_design as t_init
    from vbmc_tpu_torch.function_logger import FunctionLogger as TL
    from vbmc_tpu_torch.transforms import create_trinfo
    D, n_evals = 2, 10
    rng = np.random.default_rng(0)
    cache = rng.uniform(-2, 2, (n_cache, D))
    fvals = -0.5 * np.sum(cache ** 2, 1)
    plb, pub = np.full(D, -3.0), np.full(D, 3.0)
    calls = []

    def fun(x):
        calls.append(np.array(x))
        return float(-0.5 * np.sum(x ** 2))

    jl = JL(fun, D, jtr.create_trinfo([-10.0] * D, [10.0] * D, plb, pub))
    left_r, left_y_r = j_init(jax.random.PRNGKey(0), jl, n_evals, plb, pub,
                              x0_cache=cache, fvals_cache=fvals)
    n_jax_calls = len(calls)
    calls.clear()
    tl = TL(fun, D, create_trinfo([-10.0] * D, [10.0] * D, plb, pub))
    left, left_y = t_init(torch.Generator().manual_seed(0), tl, n_evals, plb,
                          pub, x0_cache=cache, fvals_cache=fvals)
    np.testing.assert_array_equal(left, left_r)
    np.testing.assert_array_equal(left_y, left_y_r)
    n_pre = min(n_cache, n_evals)
    np.testing.assert_array_equal(tl.X[:n_pre], jl.X[:n_pre])
    np.testing.assert_array_equal(tl.y_orig[:n_pre], jl.y_orig[:n_pre])
    assert len(calls) == n_jax_calls == n_evals - n_pre
    assert tl.func_count == n_evals - n_pre and tl.cache_count == n_pre
    pre = {tuple(x) for x in cache}
    assert not any(tuple(c) in pre for c in calls)


# ----------------------------------------------------------------------
# Command line, self-test blocks, examples, exports
# ----------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["version"], ["defaults"], ["defaults", "3"],
                                  ["all"], [], ["bogus"]])
def test_command_line_matches_reference(argv):
    def run(pkg):
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        return subprocess.run([sys.executable, "-m", pkg, *argv], cwd=ROOT,
                              capture_output=True, text=True, timeout=300,
                              env=env)
    ref, got = run("vbmc_tpu"), run("vbmc_tpu_torch")
    assert got.returncode == ref.returncode
    if argv:
        assert got.stdout == ref.stdout
    else:
        assert got.returncode == 2 and "version" in got.stdout


def test_self_test_blocks_equal_bench_blocks():
    sys.path.insert(0, str(ROOT))
    import bench
    from vbmc_tpu_torch import selftest
    ref, got = bench._blocks(), selftest._blocks()
    assert [b["name"] for b in got] == [b["name"] for b in ref]
    rng = np.random.default_rng(0)
    for b, r in zip(got, ref):
        for k in ("D", "lnz", "noisy"):
            assert b[k] == r[k]
        for k in ("mean", "x0", "lb", "ub", "plb", "pub"):
            np.testing.assert_array_equal(b[k], r[k])
        fb = b["make_fun"](3) if "make_fun" in b else b["fun"]
        fr = r["make_fun"](3) if "make_fun" in r else r["fun"]
        for x in rng.uniform(-2.5, 2.5, (20, b["D"])):
            if b["lb"] is not None:
                x = np.abs(x)
            assert fb(x) == fr(x)
    # the port's `test` command never imports the bench module (jax)
    src = inspect.getsource(importlib.import_module("vbmc_tpu_torch.__main__"))
    assert "bench" not in {n.id for n in ast.walk(ast.parse(src))
                           if isinstance(n, ast.Name)}


def test_examples_targets_equal_reference():
    from vbmc_tpu import examples as je
    from vbmc_tpu_torch import examples as te
    assert sorted(te.EXAMPLES) == sorted(je.EXAMPLES) == [1, 2, 3, 4, 5, 6]
    for k in te.EXAMPLES:
        assert te.EXAMPLES[k].__name__ == je.EXAMPLES[k].__name__
        assert inspect.signature(te.EXAMPLES[k]).parameters["device"].default \
            == "cuda"
    for x in np.random.default_rng(0).uniform(-2, 2, (10, 3)):
        assert te.rosenbrock_test(x) == je.rosenbrock_test(x)
        np.testing.assert_array_equal(
            te.psycho_gen(x, np.linspace(-3, 3, 50), np.random.default_rng(1)),
            je.psycho_gen(x, np.linspace(-3, 3, 50), np.random.default_rng(1)))


def test_every_reference_export_resolves_in_the_port():
    for name in vbmc_tpu.__all__:
        assert hasattr(vbmc_tpu_torch, name), name
    assert sorted(vbmc_tpu_torch.__all__) == sorted(vbmc_tpu.__all__)
    for mod in ("diagnostics", "serialize", "plotting", "priors", "examples",
                "__main__", "selftest", "gp.sample", "samplers.mala",
                "samplers.ensemble", "utils.ibs", "utils.kde",
                "parallel.launch", "parallel.worker"):
        importlib.import_module(f"vbmc_tpu_torch.{mod}")
    from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_sample  # noqa
    from vbmc_tpu_torch.vp import vp_train2real  # noqa
    from vbmc_tpu_torch.main import vbmc_sweep  # noqa


def test_no_module_of_the_port_imports_matplotlib_at_import():
    code = ("import importlib, pkgutil, sys, vbmc_tpu_torch\n"
            "for m in pkgutil.walk_packages(vbmc_tpu_torch.__path__,"
            " 'vbmc_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'matplotlib' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_the_only_try_in_main_surrounds_the_plot_call():
    """No `except` keeps a first result when the retry fails, and none
    hides a failed kernel build or launch: the one `try` of `main.py` holds
    the plot call alone."""
    from vbmc_tpu_torch import main
    tree = ast.parse(inspect.getsource(main))
    tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert len(tries) == 1
    body = tries[0].body
    assert len(body) == 1 and isinstance(body[0], ast.Expr)
    assert body[0].value.func.id == "iteration_plot"
