"""The port's samplers and optimisers: slice and ensemble sampling judged
by the moments of a Gaussian (as `tests/test_ensemble_hyp.py` does),
CMA-ES on a quadratic, and the batched L-BFGS reaching the minimum the JAX
reference reaches."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp.fit import assemble_hyp_prior as j_prior, \
    TrainOptions as JTrainOptions
from vbmc_tpu.optim import minimize_lbfgs_bounded as j_lbfgs
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu_torch.convert import hyp_prior_from_dict
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, train_gp, hyp_sampler_for
from vbmc_tpu_torch.optim import minimize_lbfgs_bounded, fminadam, \
    value_and_grad
from vbmc_tpu_torch.samplers.cmaes import cmaes_minimize
from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_final
from vbmc_tpu_torch.samplers.slice import slice_sample_chains

torch.set_num_threads(1)

COV = np.array([[1.0, 0.6], [0.6, 0.8]])
PREC = torch.tensor(np.linalg.inv(COV))


def _logp(x):
    return -0.5 * torch.einsum("bi,ij,bj->b", x, PREC, x)


def test_slice_chains_sample_gaussian():
    gen = torch.Generator().manual_seed(0)
    x0 = 0.1 * torch.randn((8, 2), generator=gen, dtype=torch.float64)
    lb = torch.full((2,), -10.0, dtype=torch.float64)
    samples, logps = slice_sample_chains(gen, _logp, x0,
                                         torch.full((2,), 1.0,
                                                    dtype=torch.float64),
                                         lb, -lb, n_keep=150, burn=20, thin=1,
                                         n_keep_max=150)
    pooled = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(pooled.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(pooled.T), COV, atol=0.22)
    np.testing.assert_allclose(logps.reshape(-1).numpy(),
                               _logp(samples.reshape(-1, 2)).numpy(),
                               rtol=1e-12)


def test_slice_chains_respect_bounds():
    gen = torch.Generator().manual_seed(1)
    lb = torch.tensor([0.0, -1.0], dtype=torch.float64)
    ub = torch.tensor([0.5, 1.0], dtype=torch.float64)
    x0 = torch.tensor([[0.25, 0.0]] * 4, dtype=torch.float64)
    samples, _ = slice_sample_chains(gen, _logp, x0,
                                     torch.ones(2, dtype=torch.float64), lb,
                                     ub, n_keep=20, burn=5, thin=1,
                                     n_keep_max=24)
    kept = samples[:, :20].reshape(-1, 2)
    assert bool(((kept >= lb) & (kept <= ub)).all())
    assert bool((samples[:, 20:] == 0).all())


def test_ensemble_final_samples_gaussian():
    W, R = 16, 48
    lb = torch.full((2,), -10.0, dtype=torch.float64)
    pooled = []
    for seed in range(R):
        gen = torch.Generator().manual_seed(seed)
        x0 = 0.1 * torch.randn((W, 2), generator=gen, dtype=torch.float64)
        xs, lps = ensemble_slice_final(gen, _logp, x0, lb, -lb, 60)
        pooled.append(xs.numpy())
    pooled = np.concatenate(pooled)
    np.testing.assert_allclose(pooled.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(pooled.T), COV, atol=0.22)


def test_cmaes_minimizes_ill_conditioned_quadratic():
    D = 4
    scales = torch.tensor([1.0, 10.0, 0.1, 3.0], dtype=torch.float64)
    target = torch.tensor([0.3, -0.2, 1.0, 0.5], dtype=torch.float64)

    def f(xs):
        return (((xs - target) * scales) ** 2).sum(1)

    gen = torch.Generator().manual_seed(0)
    lb = torch.full((D,), -5.0, dtype=torch.float64)
    res = cmaes_minimize(gen, f, torch.zeros(D, dtype=torch.float64),
                         torch.ones(D, dtype=torch.float64), lb, -lb,
                         max_evals=3000, popsize=16)
    assert float(res.f_best) < 1e-6
    np.testing.assert_allclose(res.x_best.numpy(), target.numpy(), atol=1e-3)


def _gp_problem(seed=0, D=2, n=30):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum((X / np.array([1.0, 0.7])[:D]) ** 2, 1)
    return X, y


def test_lbfgs_reaches_jax_map_minimum():
    """GP hyperparameter MAP from the same starts: the batched torch
    L-BFGS reaches the minimum optax L-BFGS reaches (or a lower one)."""
    D = 2
    cfg = GPConfig(D=D)
    X, y = _gp_problem()
    opts = JTrainOptions()
    jp, x0 = j_prior(cfg, X, y, np.full(D, -2.0), np.full(D, 2.0), opts)
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    mask = np.arange(32) < X.shape[0]

    def jobj(h):
        nll = (jcore.neg_log_marginal_likelihood(
            cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.zeros(32),
            jnp.asarray(mask)) - jcore.hyperprior_logpdf(jp, h))
        return jnp.where(jnp.isfinite(nll), nll, 1e12)

    rng = np.random.default_rng(3)
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    plb, pub = np.asarray(jp.plb), np.asarray(jp.pub)
    starts = np.stack([x0] + [plb + rng.random(cfg.nhyp) * (pub - plb)
                              for _ in range(2)])
    f_ref = np.array([float(j_lbfgs(jobj, jnp.asarray(s), jp.lb, jp.ub,
                                    maxiter=80)[1]) for s in starts])

    tp = hyp_prior_from_dict(jax.device_get(jp._asdict()))
    tcfg = TGPConfig(D=D)

    def tobj(h):
        nll = (tcore.neg_log_marginal_likelihood(
            tcfg, h, torch.tensor(Xp), torch.tensor(yp), torch.zeros(32),
            torch.tensor(mask))
            - tcore.hyperprior_logpdf(tp, h))
        return torch.where(torch.isfinite(nll), nll, 1e12)

    x_t, f_t = minimize_lbfgs_bounded(tobj, torch.tensor(starts), tp.lb,
                                      tp.ub, maxiter=80)
    assert bool(((x_t >= tp.lb) & (x_t <= tp.ub)).all())
    np.testing.assert_allclose(tobj(x_t).numpy(), f_t.numpy(), rtol=1e-12)
    # Same basin: the best minimum agrees to 1e-4 nats (or torch is lower).
    assert f_t.min().item() <= f_ref.min() + 1e-4
    assert f_t.min().item() >= f_ref.min() - 0.5


def test_fminadam_converges_on_quadratic_batch():
    target = torch.tensor([[1.0, -2.0], [0.5, 0.5]], dtype=torch.float64)

    def f_vg(x, _it):
        return value_and_grad(lambda z: ((z - target) ** 2).sum(1), x)

    res = fminadam(f_vg, torch.zeros((2, 2), dtype=torch.float64),
                   maxiter=2000, step_max=0.1, tol_fun=1e-6)
    np.testing.assert_allclose(res.x.numpy(), target.numpy(), atol=2e-2)
    assert bool((res.n_iters < 2000).all())


@pytest.mark.parametrize("D", [2, 6])
def test_train_gp_picks_the_reference_sampler(D):
    """nhyp <= 20 runs slice chains, nhyp > 20 the ensemble; both give
    dispersed finite samples and a GP that fits the training data."""
    rng = np.random.default_rng(D)
    X = rng.uniform(-2, 2, (40, D))
    y = -0.5 * np.sum(X ** 2, 1)
    cfg = TGPConfig(D=D)
    opts = TrainOptions(ns_samples=8, ninit=128, nopts=1, thin=2,
                        lbfgs_iters=30, n_chains=4)
    gen = torch.Generator().manual_seed(0)
    gp, info = train_gp(gen, cfg, X, y, None, np.full(D, -2.0),
                        np.full(D, 2.0), opts, host_seed=1, device="cpu")
    assert hyp_sampler_for(cfg, 8) == ("ensemble" if D == 6 else "slice")
    hyp = gp.hyp[gp.hyp_mask].numpy()
    assert np.all(np.isfinite(hyp)) and hyp.shape[0] == 8
    assert hyp.std(axis=0).max() > 1e-4
    from vbmc_tpu_torch.gp.predict import gp_predict
    fbar, _, _, _ = gp_predict(cfg, gp, torch.tensor(X[:8]))
    assert np.sqrt(np.mean((fbar.numpy() - y[:8]) ** 2)) < 0.5
