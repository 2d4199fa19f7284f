"""The host-side search path of the port against the JAX reference: the
k-means thinning of a starting cache and `real_to_int` (exact), the
composition of `get_search_points` (counts, bounds and moments of each
part: the draws come from another generator, so they are held
statistically), the per-point variance of the log joint that "eig" needs,
and `active_sample` with integer variables, a search cache and repeated
observations on a fixed GP."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.utils.kmeans import kmeans as j_kmeans
from vbmc_tpu.transforms import (create_trinfo as j_create_trinfo,
                                 real_to_int as j_real_to_int)
from vbmc_tpu.active_sample import initial_design as j_initial_design
from vbmc_tpu.function_logger import FunctionLogger as JFunctionLogger
from vbmc_tpu.elbo import gplogjoint as j_gplogjoint
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu.vp import make_vp as j_make_vp
from vbmc_tpu_torch import active_sample as tas
from vbmc_tpu_torch import kernels
from vbmc_tpu_torch import state as tst
from vbmc_tpu_torch.convert import gp_from_dict, vp_from_dict
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.options import VBMCOptions
from vbmc_tpu_torch.transforms import create_trinfo, inverse, real_to_int
from vbmc_tpu_torch.utils.kmeans import kmeans
from vbmc_tpu_torch.vp import make_vp, vp_moments

from test_torch_gp_problems import gp_problem, tcfg_of

torch.set_num_threads(1)


@pytest.mark.parametrize("n,D,k,seed", [(40, 2, 10, 0), (200, 5, 10, 0),
                                        (31, 3, 7, 4), (12, 1, 12, 1)])
def test_kmeans_equals_reference(n, D, k, seed):
    """Same seeding stream and Lloyd iterations: equal assignments, and
    centres to 1e-12."""
    X = np.random.default_rng(100 + seed).uniform(-2, 2, (n, D))
    c_ref, a_ref = j_kmeans(X, k, seed=seed)
    c, a = kmeans(X, k, seed=seed)
    np.testing.assert_array_equal(a, np.asarray(a_ref))
    np.testing.assert_allclose(c, np.asarray(c_ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bounds", [
    ([0.0, -10.0, -np.inf], [10.0, 10.0, np.inf]),
    ([-np.inf] * 3, [np.inf] * 3),
    ([0.0, -np.inf, -5.0], [np.inf, 4.0, 5.0])])
@pytest.mark.parametrize("mask", [(True, False, False), (True, False, True),
                                  (False, False, False)])
def test_real_to_int_equals_reference(bounds, mask):
    """Rounding in original space through the transform; exact to 1e-12."""
    lb, ub = bounds
    plb, pub = [1.0, -3.0, -2.0], [6.0, 3.0, 2.0]
    y = np.random.default_rng(0).uniform(-2, 2, (50, 3))
    ref = np.asarray(j_real_to_int(j_create_trinfo(lb, ub, plb, pub),
                                   jnp.asarray(y), np.array(mask)))
    ti = create_trinfo(lb, ub, plb, pub, device="cpu")
    got = real_to_int(ti, torch.as_tensor(y), np.array(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    x = inverse(ti, got).numpy()[:, np.array(mask)]
    np.testing.assert_allclose(x, np.round(x), atol=1e-9)


def _logger(D=2, n=6, lb=-10.0):
    ti = create_trinfo([lb] * D, [10.0] * D, [-3.0] * D, [3.0] * D,
                       device="cpu")
    logger = FunctionLogger(lambda x: float(-np.sum(x ** 2)), D, ti)
    for i in range(n):
        logger.evaluate(np.array([0.1 * i, -0.1 * i] + [0.0] * (D - 2)))
    return ti, logger


@pytest.mark.parametrize("n_cache,n_evals", [(40, 10), (25, 10), (7, 10)])
def test_initial_design_thinning_equals_reference(n_cache, n_evals):
    """A cache above ``n_evals`` is thinned by k-means to the same points
    as the reference picks (no pre-evaluated values: the first member of
    each cluster), with the same leftover; a smaller one is topped up by
    uniform draws in the plausible box."""
    D = 2
    cache = np.random.default_rng(0).uniform(-2, 2, (n_cache, D))
    plb, pub = np.full(D, -3.0), np.full(D, 3.0)

    def fun(x):
        return float(-0.5 * np.sum(x ** 2))

    jl = JFunctionLogger(fun, D, j_create_trinfo([-10.0] * D, [10.0] * D,
                                                 plb, pub))
    left_ref, left_y_ref = j_initial_design(jax.random.PRNGKey(0), jl,
                                            n_evals, plb, pub, x0_cache=cache)
    tl = FunctionLogger(fun, D, create_trinfo([-10.0] * D, [10.0] * D, plb,
                                              pub, device="cpu"))
    left, left_y = tas.initial_design(torch.Generator().manual_seed(0), tl,
                                      n_evals, plb, pub, x0_cache=cache)
    assert tl.Xn == n_evals
    np.testing.assert_array_equal(left, left_ref)
    np.testing.assert_array_equal(left_y, left_y_ref)
    assert left.shape == (max(n_cache - n_evals, 0), D)
    n_from_cache = min(n_cache, n_evals)
    np.testing.assert_array_equal(tl.X[:n_from_cache], jl.X[:n_from_cache])
    rest = tl.X[n_from_cache:n_evals]
    assert np.all(rest >= plb) and np.all(rest <= pub)


def test_initial_design_narrow_and_unknown():
    D = 2
    plb, pub = np.full(D, -3.0), np.full(D, 3.0)
    _, logger = _logger(n=0)
    tas.initial_design(torch.Generator().manual_seed(1), logger, 10, plb, pub,
                       x0_cache=np.array([[1.0, -1.0]]), init_design="narrow")
    X = logger.X[:10]
    assert np.all(np.abs(X - X[0]) <= 0.05 * (pub - plb) + 1e-12)
    with pytest.raises(ValueError, match="initial design"):
        tas.initial_design(torch.Generator().manual_seed(1), logger, 12, plb,
                           pub, init_design="wide")


def test_search_cache_frac_used():
    """`tests/test_active_features.py:161`: a quarter of 64 search points
    come from the cache."""
    D = 2
    ti, logger = _logger()
    vp = make_vp(ti, np.zeros((2, D)), 0.5, np.ones(D), k_max=4)
    sb = tas.SearchBounds.init(np.full(D, -3.0), np.full(D, 3.0),
                               np.full(D, -10.0), np.full(D, 10.0), 2.0)
    opt = VBMCOptions(search_cache_frac=0.25).resolve(D)
    cache = np.tile(np.array([[1.234, -0.567]]), (50, 1))
    Xs = tas.get_search_points(torch.Generator().manual_seed(1), 64, vp,
                               logger, sb, opt, search_cache=cache).numpy()
    assert Xs.shape == (64, D)
    assert int(np.sum(np.all(np.abs(Xs - cache[0]) < 1e-9, axis=1))) == 16
    assert np.all(np.all(np.abs(Xs[:16] - cache[0]) < 1e-9, axis=1))


def test_get_search_points_parts():
    """The parts in the reference's order, each with its count
    (round(frac n)), inside the search box, and with the moments of the
    distribution it is drawn from (n = 4096 per part: means to 0.1,
    SDs to 10%)."""
    D = 2
    n = 16384
    ti = create_trinfo([-np.inf] * D, [np.inf] * D, [-3.0] * D, [3.0] * D,
                       device="cpu")
    logger = FunctionLogger(lambda x: float(-0.5 * np.sum(x ** 2)), D, ti)
    rng = np.random.default_rng(0)
    for x in rng.uniform(-1, 1, (30, D)):
        logger.evaluate(x)
    vp = make_vp(ti, np.array([[0.5, -0.5], [-0.5, 0.5]]), 0.3, np.ones(D),
                 k_max=4)
    sb = tas.SearchBounds(lb=np.full(D, -6.0), ub=np.full(D, 6.0),
                          lb_hard=np.full(D, -np.inf),
                          ub_hard=np.full(D, np.inf))
    opt = VBMCOptions(search_cache_frac=0.0, heavy_tail_search_frac=0.25,
                      mvn_search_frac=0.25, hpd_search_frac=0.25,
                      box_search_frac=0.25).resolve(D)
    Xs = tas.get_search_points(torch.Generator().manual_seed(3), n, vp,
                               logger, sb, opt).numpy()
    assert Xs.shape == (n, D)
    assert np.all(Xs >= sb.lb) and np.all(Xs <= sb.ub)
    heavy, mvn, hpd, box = np.split(Xs, 4)
    mu, cov = (a.numpy() for a in vp_moments(vp, orig_flag=False))
    sd = np.sqrt(np.diag(cov))
    # heavy tails: the VP's mean, more mass beyond 3 SD than the Gaussian part
    np.testing.assert_allclose(heavy.mean(0), mu, atol=0.1)
    far = lambda X: np.mean(np.any(np.abs(X - mu) > 3 * sd, axis=1))
    assert far(heavy) > 3 * far(mvn)
    np.testing.assert_allclose(mvn.mean(0), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(mvn.T), cov, atol=0.1 * sd.max() ** 2)
    # HPD parts: Gaussians matched to the top hpd_frac/8 .. hpd_frac of the
    # training set, all centred near its best points
    X_tr, y_tr, _ = logger.training_data()
    top = X_tr[np.argsort(-y_tr)[:int(np.ceil(opt.hpd_frac * 30))]]
    assert np.all(np.abs(hpd.mean(0) - top.mean(0)) < 0.2)
    assert np.all(hpd.std(0) < 1.5 * X_tr.std(0))
    # box: uniform on the training box widened by half its diameter
    diam = X_tr.max(0) - X_tr.min(0)
    lo, hi = X_tr.min(0) - 0.5 * diam, X_tr.max(0) + 0.5 * diam
    assert np.all(box >= lo) and np.all(box <= hi)
    np.testing.assert_allclose(box.mean(0), 0.5 * (lo + hi), atol=0.1)
    np.testing.assert_allclose(box.std(0), (hi - lo) / np.sqrt(12), rtol=0.1)
    # with the fractions at their defaults the rest is balanced VP draws
    opt0 = VBMCOptions(heavy_tail_search_frac=0.0, mvn_search_frac=0.0,
                       box_search_frac=0.0).resolve(D)
    Xv = tas.get_search_points(torch.Generator().manual_seed(3), 4096, vp,
                               logger, sb, opt0).numpy()
    np.testing.assert_allclose(Xv.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(Xv.T), cov, atol=0.1 * sd.max() ** 2)


def _fixed_problem(noisy, D=2, seed=5):
    """A trained-looking GP on logged data, its VP and an option set, for
    `active_sample` on CPU tensors."""
    cfg, X, y, s2, hyps = gp_problem(seed, D=D, n=20, S=4, noisy=noisy,
                                     user_noise=1 if noisy else 0)
    tcfg = tcfg_of(cfg)
    ti = create_trinfo([-10.0] * D, [10.0] * D, [-3.0] * D, [3.0] * D,
                       device="cpu")
    noise = np.random.default_rng(seed)

    def fun(x):
        v = float(-0.5 * np.sum(x ** 2))
        return (v + 0.3 * noise.standard_normal(), 0.3) if noisy else v

    logger = FunctionLogger(fun, D, ti, uncertainty_level=2 if noisy else 0)
    from vbmc_tpu_torch.transforms import inverse_np
    for x in inverse_np(ti, X):
        logger.evaluate(x)
    vp = make_vp(ti, np.array([[0.3, -0.3], [-0.3, 0.3]]), 0.5, np.ones(D),
                 k_max=4)
    from vbmc_tpu_torch.gp.gp import gp_from_host
    X_tr, y_tr, s2_tr = logger.training_data()
    gp = gp_from_host(tcfg, X_tr, y_tr, s2_tr, hyps, n_bucket=32, s_bucket=4)
    sb = tas.SearchBounds.init(np.full(D, -3.0), np.full(D, 3.0),
                               np.full(D, -20.0), np.full(D, 20.0), 2.0)
    return tcfg, logger, vp, gp, sb, ti


def _small(**kw):
    return VBMCOptions(ns_search=256, search_max_fun_evals=64, **kw)


def test_var_log_joint_matches_jax():
    """The (S,) variance of the log-joint integral handed to "eig":
    w^T J w per hyperparameter sample, against the reference's lines
    (`vbmc_tpu/active_sample.py:481-487`); rtol 1e-8 as
    `tests/test_torch_elbo.py` holds J."""
    cfg, X, y, s2, hyps = gp_problem(9, D=3, n=25, S=4)
    gp = j_gp_from_host(cfg, X, y, s2, hyps, n_bucket=32, s_bucket=4)
    ti = j_create_trinfo([-np.inf] * 3, [np.inf] * 3, [-2.0] * 3, [2.0] * 3)
    rng = np.random.default_rng(1)
    vp = j_make_vp(ti, rng.uniform(-1, 1, (3, 3)), 0.4 + 0.2 * rng.random(3),
                   np.ones(3), k_max=4)
    J = j_gplogjoint(cfg, gp, vp.mu, vp.sigma, vp.lam, vp.w, vp.kmask,
                     compute_var=1)[4]
    wk = vp.w * vp.kmask.astype(vp.w.dtype)
    ref = np.maximum(np.asarray(jnp.einsum("j,sjk,k->s", wk, J, wk)), 1e-12)
    tgp = gp_from_dict(jax.device_get(gp._asdict()))
    tvp = vp_from_dict(jax.device_get(vp._asdict()))
    got = tas._var_log_joint(tcfg_of(cfg), tgp, tvp).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8)


@pytest.mark.parametrize("acq_name", ["prospective", "eig"])
def test_integer_vars_round_the_acquired_points(acq_name):
    """With ``integer_vars`` every acquired point is integral in that
    original-space dimension and not in the other
    (`tests/test_active_features.py:105`)."""
    cfg, logger, vp, gp, sb, ti = _fixed_problem(noisy=False)
    opt = _small(integer_vars=(0,)).resolve(2)
    n0 = logger.Xn
    gp2, _ = tas.active_sample(torch.Generator().manual_seed(0), cfg, logger,
                               4, vp, gp, sb, opt, acq_name=acq_name,
                               tol_gp_var=1e-4)
    X_new = logger.X_orig[n0:logger.Xn]
    assert X_new.shape[0] == 4
    np.testing.assert_allclose(X_new[:, 0], np.round(X_new[:, 0]), atol=1e-6)
    assert np.any(np.abs(X_new[:, 1] - np.round(X_new[:, 1])) > 1e-3)
    assert int(gp2.mask.sum()) == logger.n_train


@pytest.mark.parametrize("opts", [
    dict(search_optimizer="none"), dict(search_cmaes_vp_init=False),
    dict(hpd_search_frac=0.2), dict(search_cache_frac=0.5)])
def test_host_path_options_run(opts, monkeypatch):
    """Each option that leaves the default composition goes through
    `get_search_points` and acquires points inside the hard bounds; the
    default composition does not."""
    calls = []
    gsp = tas.get_search_points
    monkeypatch.setattr(tas, "get_search_points",
                        lambda *a, **k: calls.append(1) or gsp(*a, **k))
    cfg, logger, vp, gp, sb, ti = _fixed_problem(noisy=False)
    n0 = logger.Xn
    cache = np.random.default_rng(2).uniform(-1, 1, (300, 2))
    tas.active_sample(torch.Generator().manual_seed(0), cfg, logger, 3, vp,
                      gp, sb, _small(**opts).resolve(2),
                      acq_name="prospective", tol_gp_var=1e-4,
                      search_cache=cache)
    assert logger.Xn == n0 + 3 and len(calls) == 3
    assert np.all(np.abs(logger.X_orig[n0:logger.Xn]) < 10.0)
    calls.clear()
    tas.active_sample(torch.Generator().manual_seed(0), cfg, logger, 2, vp,
                      gp, sb, _small().resolve(2), acq_name="prospective",
                      tol_gp_var=1e-4, search_cache=cache)
    assert calls == []


def test_repeated_observations_on_the_host_path(monkeypatch):
    """With ``max_repeated_observations`` a noisy target's host path
    compares the unregularised acquisition at the training inputs with the
    discounted winner. The plain evaluation is shifted by -1000 here, so
    that the refined winner and the training set's values are negative
    whatever the data: with a discount of 1e6 no training point can win
    and nothing repeats; with a discount of -1 every training point wins,
    the streak runs to its limit of two, resets, and the logger merges the
    duplicates. The sweeps go through `sweep_is_acquisition` (on CPU
    tensors its plain version: no launch is counted)."""
    cfg, logger, vp, gp, sb, ti = _fixed_problem(noisy=True)
    state = tst.OptimState()
    regs, sweeps = [], []
    ev, sw = tas.evaluate_is_acquisition, tas.sweep_is_acquisition

    def spy(cfg_, name, xs, vp_, gp_, st, ais):
        regs.append((xs.shape[0], st.regularize))
        return ev(cfg_, name, xs, vp_, gp_, st, ais) - 1000.0

    monkeypatch.setattr(tas, "evaluate_is_acquisition", spy)
    monkeypatch.setattr(tas, "sweep_is_acquisition",
                        lambda *a: sweeps.append(1) or sw(*a))

    def run(discount):
        opt = _small(max_repeated_observations=2,
                     repeated_acq_discount=discount,
                     specify_target_noise=True).resolve(2)
        tas.active_sample(torch.Generator().manual_seed(0), cfg, logger, 3,
                          vp, gp, sb, opt, acq_name="viqr", tol_gp_var=1e-4,
                          optim_state=state)

    before = kernels.viqr_acq.launches
    n0 = logger.Xn
    run(1e6)
    assert logger.Xn == n0 + 3 and state.repeated_obs_streak == 0
    assert np.all(logger.nevals[:logger.Xn] <= 1)
    assert len(sweeps) == 3
    # the training-set evaluations run unregularised, on the padded bucket
    assert (32, False) in regs
    n1 = logger.Xn
    run(-1.0)
    # two repeats, then the streak is at its limit and a new point is taken
    assert logger.Xn == n1 + 1
    assert int(logger.nevals[:logger.Xn].sum()) == n1 + 3
    assert int(logger.nevals[:logger.Xn].max()) >= 2
    assert state.repeated_obs_streak == 0
    assert kernels.viqr_acq.launches == before
