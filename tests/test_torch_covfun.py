"""The port's covariance families against the JAX reference in float64:
`kernel_cross` for seiso, SE-ard and Matérn nu in {1, 3, 5}, the Matérn
length-scale gradient on a Gram matrix with repeated rows, nlZ and its
gradient, the pooled hyperprior of an iso kernel, and `train_gp`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp.fit import (TrainOptions as JTrainOptions,
                             assemble_hyp_prior as j_assemble)
from vbmc_tpu.gp.kernels import kernel_cross as j_kernel_cross
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.fit import (TrainOptions, assemble_hyp_prior,
                                   train_gp)
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.predict import gp_predict

from test_torch_gp_problems import gp_problem, tcfg_of

torch.set_num_threads(1)

COVS = [(0, 5), (1, 5), (3, 1), (3, 3), (3, 5)]


@pytest.mark.parametrize("covfun,nu", COVS)
def test_kernel_cross_matches_jax(covfun, nu):
    """rtol 1e-12: an elementwise transform of one distance product."""
    cfg, X, _, _, hyps = gp_problem(0, covfun=covfun, cov_nu=nu)
    Xb = np.random.default_rng(1).uniform(-2, 2, (7, 3))
    got = kernel_cross(tcfg_of(cfg), torch.tensor(hyps), torch.tensor(X),
                       torch.tensor(Xb)).numpy()
    for s in range(hyps.shape[0]):
        ref = np.asarray(j_kernel_cross(cfg, jnp.asarray(hyps[s]),
                                        jnp.asarray(X), jnp.asarray(Xb)))
        np.testing.assert_allclose(got[s], ref, rtol=1e-12, atol=1e-14)


def test_unknown_covariance_and_degree_raise():
    X = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="nu must be 1, 3 or 5"):
        kernel_cross(TGPConfig(D=2, covfun=3, cov_nu=2), torch.zeros(1, 8),
                     X, X)
    with pytest.raises(ValueError, match="unsupported covfun"):
        kernel_cross(TGPConfig(D=2, covfun=2), torch.zeros(1, 8), X, X)


@pytest.mark.parametrize("nu", [1, 3, 5])
def test_matern_gradient_is_finite_with_repeated_rows(nu):
    """The Gram diagonal and repeated rows have d2 = 0, where the sqrt has
    an infinite derivative: the length-scale gradient stays finite and
    equals the reference's (rtol 1e-8, the nlZ gradient's tolerance: the
    distance of two equal rows comes out of a difference of products as
    about 1e-16, not 0, and the sqrt magnifies its rounding)."""
    cfg, X, _, _, hyps = gp_problem(2, covfun=3, cov_nu=nu, S=1)
    X[5] = X[2]
    X[-1] = X[0]
    th = torch.tensor(hyps, requires_grad=True)
    K = kernel_cross(tcfg_of(cfg), th, torch.tensor(X), torch.tensor(X))
    wts = torch.tensor(np.random.default_rng(3).random(K.shape[1:]))
    (g,) = torch.autograd.grad((K[0] * wts).sum(), th)
    assert torch.isfinite(g).all()
    g_ref = jax.grad(lambda h: jnp.sum(
        j_kernel_cross(cfg, h, jnp.asarray(X), jnp.asarray(X))
        * jnp.asarray(wts.numpy())))(jnp.asarray(hyps[0]))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_ref), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("covfun,nu", COVS)
def test_nlz_and_gradient_match_jax(covfun, nu):
    """rtol 1e-8 on value and gradient, as for the SE-ard kernel. The
    Matérn kernel of degree 1 is exp(-r), not differentiable at r = 0: the
    Gram diagonal's distance is rounding noise of about 1e-16 whose sqrt,
    1e-8, enters K, so both packages carry that noise and agree to 1e-6."""
    rtol = 1e-6 if (covfun, nu) == (3, 1) else 1e-8
    cfg, X, y, _, hyps = gp_problem(4, covfun=covfun, cov_nu=nu)
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    mask = np.arange(32) < X.shape[0]
    th = torch.tensor(hyps, requires_grad=True)
    nlz = tcore.neg_log_marginal_likelihood(
        tcfg_of(cfg), th, torch.tensor(Xp), torch.tensor(yp), torch.zeros(32),
        torch.tensor(mask))
    (g,) = torch.autograd.grad(nlz.sum(), th)
    assert torch.isfinite(g).all()
    for s in range(hyps.shape[0]):
        v_ref, g_ref = jax.value_and_grad(
            lambda h: jcore.neg_log_marginal_likelihood(
                cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.zeros(32),
                jnp.asarray(mask)))(jnp.asarray(hyps[s]))
        np.testing.assert_allclose(nlz[s].item(), float(v_ref), rtol=rtol)
        np.testing.assert_allclose(g[s].numpy(), np.asarray(g_ref),
                                   rtol=rtol, atol=1e-10)


@pytest.mark.parametrize("covfun,nu", [(0, 5), (3, 3)])
@pytest.mark.parametrize("upper", [0.0, 2.0])
def test_hyp_prior_matches_jax(covfun, nu, upper):
    """An iso kernel takes statistics pooled over the dimensions: every
    field of the prior and x0 equal the reference's (rtol 1e-12)."""
    cfg, X, y, _, _ = gp_problem(5, covfun=covfun, cov_nu=nu)
    plb, pub = np.full(3, -2.0), np.array([2.0, 3.0, 1.5])
    jp, jx0 = j_assemble(cfg, X, y, plb, pub,
                         JTrainOptions(upper_length_factor=upper))
    tp, tx0 = assemble_hyp_prior(tcfg_of(cfg), X, y, plb, pub,
                                 TrainOptions(upper_length_factor=upper))
    np.testing.assert_allclose(tx0, jx0, rtol=1e-12)
    for name in ("mu", "sigma", "df", "lb", "ub", "plb", "pub"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("covfun,nu", [(0, 5), (3, 5), (3, 1)])
def test_train_gp_runs_with_iso_and_matern(covfun, nu):
    """MAP training reaches a fit that interpolates a smooth target: the
    prediction at held-out points is within 0.5 of the truth."""
    rng = np.random.default_rng(6)
    X = rng.uniform(-2, 2, (40, 2))
    y = -0.5 * np.sum(X ** 2, 1)
    cfg = TGPConfig(D=2, covfun=covfun, cov_nu=nu)
    gen = torch.Generator().manual_seed(0)
    gp, info = train_gp(gen, cfg, X, y, None, np.full(2, -2.0),
                        np.full(2, 2.0),
                        TrainOptions(ns_samples=0, ninit=256, nopts=1,
                                     lbfgs_iters=30), host_seed=1,
                        device="cpu")
    assert np.isfinite(info["hyp_map"]).all()
    Xs = rng.uniform(-1.5, 1.5, (20, 2))
    fbar, vtot, _, _ = gp_predict(cfg, gp, torch.tensor(Xs))
    assert torch.isfinite(vtot).all()
    assert np.abs(fbar.numpy() + 0.5 * np.sum(Xs ** 2, 1)).max() < 0.5
