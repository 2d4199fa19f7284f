"""The port's GP core against the JAX reference on the same float64 inputs:
posterior factorisation, marginal likelihood and its gradient, prediction,
and the Cholesky jitter ladder."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu.gp.predict import gp_predict as j_gp_predict
from vbmc_tpu_torch.convert import gp_from_dict
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.gp import gp_from_host as t_gp_from_host
from vbmc_tpu_torch.gp.predict import gp_predict as t_gp_predict

torch.set_num_threads(1)


def _problem(seed, D=3, n=25, S=4, meanfun=4):
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, meanfun=meanfun)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.05 * rng.standard_normal(n)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.9) + 0.1 * rng.standard_normal((S, D))
    hyps[:, D] = 0.2 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.05)
    i_m = cfg.ncov + cfg.nnoise
    if cfg.nmean:
        hyps[:, i_m] = 0.3
    if meanfun == 4:
        hyps[:, i_m + 1:i_m + 1 + D] = 0.1 * rng.standard_normal((S, D))
        hyps[:, i_m + 1 + D:] = np.log(1.2)
    return cfg, X, y, hyps


@pytest.mark.parametrize("meanfun", [0, 1, 4])
def test_build_gp_matches_jax(meanfun):
    cfg, X, y, hyps = _problem(0, meanfun=meanfun)
    jgp = j_gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=4)
    tgp = t_gp_from_host(TGPConfig(D=3, meanfun=meanfun), X, y, None, hyps,
                         n_bucket=32, s_bucket=4)
    for name in ("alpha", "Binv", "L", "sn2"):
        np.testing.assert_allclose(getattr(tgp, name).numpy(),
                                   np.asarray(getattr(jgp, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_nlz_and_gradient_match_jax():
    cfg, X, y, hyps = _problem(1)
    from vbmc_tpu.utils.math import pad_to
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    mask = np.arange(32) < X.shape[0]

    def jf(h):
        return jcore.neg_log_marginal_likelihood(
            cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.zeros(32),
            jnp.asarray(mask))

    tcfg = TGPConfig(D=3)
    th = torch.tensor(hyps, requires_grad=True)
    nlz_t = tcore.neg_log_marginal_likelihood(
        tcfg, th, torch.tensor(Xp), torch.tensor(yp), torch.zeros(32),
        torch.tensor(mask))
    (g_t,) = torch.autograd.grad(nlz_t.sum(), th)
    for s in range(hyps.shape[0]):
        v, g = jax.value_and_grad(jf)(jnp.asarray(hyps[s]))
        np.testing.assert_allclose(nlz_t[s].item(), float(v), rtol=1e-8)
        np.testing.assert_allclose(g_t[s].numpy(), np.asarray(g), rtol=1e-8,
                                   atol=1e-10)


def test_hyperprior_matches_jax():
    rng = np.random.default_rng(2)
    nh = 8
    mu = rng.standard_normal(nh)
    sigma = np.abs(rng.standard_normal(nh)) + 0.2
    sigma[1] = np.inf                      # flat
    df = np.full(nh, 3.0)
    df[2] = 0.0                            # Gaussian
    h = rng.standard_normal((5, nh))

    from vbmc_tpu.gp.gp import HypPrior as JPrior
    jp = JPrior(mu=jnp.asarray(mu), sigma=jnp.asarray(sigma),
                df=jnp.asarray(df), lb=None, ub=None, plb=None, pub=None)
    from vbmc_tpu_torch.gp.gp import HypPrior as TPrior
    tp = TPrior(mu=torch.tensor(mu), sigma=torch.tensor(sigma),
                df=torch.tensor(df), lb=None, ub=None, plb=None, pub=None)
    got = tcore.hyperprior_logpdf(tp, torch.tensor(h)).numpy()
    ref = np.array([float(jcore.hyperprior_logpdf(jp, jnp.asarray(r)))
                    for r in h])
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_gp_predict_matches_jax():
    cfg, X, y, hyps = _problem(3)
    jgp = j_gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=4)
    tgp = gp_from_dict(jax.device_get(jgp._asdict()))
    Xs = np.random.default_rng(4).uniform(-2.5, 2.5, (50, 3))
    ref = [np.asarray(a) for a in j_gp_predict(cfg, jgp, jnp.asarray(Xs))]
    got = [a.numpy() for a in t_gp_predict(TGPConfig(D=3), tgp,
                                           torch.tensor(Xs))]
    for g, r, name in zip(got, ref, ("fbar", "vtot", "fmu", "fs2")):
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-12, err_msg=name)


def test_cholesky_jitter_ladder_on_near_singular_matrix():
    """A singular PSD batch element fails the plain factorisation; the
    ladder repairs it with the first jitter that succeeds, while the
    healthy element keeps its exact factor, as in the reference."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 3))
    sing = A @ A.T                               # rank 3: not PD
    sing[5, 5] -= 1e-3                           # slightly indefinite
    good = sing + 6.0 * np.eye(6)
    B = np.stack([good, sing])
    L, first_ok = tcore.robust_cholesky(torch.tensor(B))
    assert first_ok.tolist() == [True, False]
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(L[0].numpy(), np.linalg.cholesky(good),
                               rtol=1e-12)
    Lj0, ok0 = jcore.robust_cholesky(jnp.asarray(good))
    Lj1, ok1 = jcore.robust_cholesky(jnp.asarray(sing))
    assert (bool(ok0), bool(ok1)) == (True, False)
    np.testing.assert_allclose(L[1].numpy(), np.asarray(Lj1), rtol=1e-8,
                               atol=1e-10)
