"""The float32 lane of `tests/test_float32.py` through the port on CPU
tensors: the Bayesian-quadrature variance in float32 (`gplogjoint`'s J,
where the prior and data terms cancel), the guard floor that keeps that
variance and the ELCBO's square root finite where the cancellation goes
below zero, and a reduced whole run with ``dtype=torch.float32``. The port
has no process-global precision switch, so no subprocess is needed."""

import numpy as np
import jax.numpy as jnp
import torch

from vbmc_tpu.elbo import gplogjoint as j_gplogjoint
from vbmc_tpu.gp.config import GPConfig, MEAN_NEGQUAD
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu_torch import VBMCOptions, vbmc
from vbmc_tpu_torch import elbo as teb
from vbmc_tpu_torch.gp.gp import gp_from_host
from vbmc_tpu_torch.optim import value_and_grad
from vbmc_tpu_torch.vp import vp_moments

from test_torch_gp_problems import tcfg_of

torch.set_num_threads(1)

D, N, K = 2, 24, 3


def _problem(log_noise):
    """The inputs of `tests/test_float32.py:30-46`, with the constant
    noise's log SD ``log_noise`` (the reference's is log 1e-2)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    y = -0.5 * np.sum(X ** 2, 1)
    nhyp = D + 1 + 1 + 1 + 2 * D
    hyp = np.tile(np.concatenate([
        np.zeros(D), [0.0], [log_noise], [0.5], np.zeros(D),
        np.zeros(D)]), (3, 1)) + 0.05 * rng.standard_normal((3, nhyp))
    cfg = GPConfig(D=D, meanfun=MEAN_NEGQUAD, const_noise=1)
    mu = rng.standard_normal((K, D))
    return cfg, X, y, hyp, mu


def _vp_args(mu, sigma, dtype):
    return (torch.tensor(mu[None], dtype=dtype),
            torch.full((1, K), sigma, dtype=dtype),
            torch.ones((1, D), dtype=dtype),
            torch.full((1, K), 1.0 / K, dtype=dtype),
            torch.ones(K, dtype=torch.bool))


def test_bq_variance_in_float32():
    """`gplogjoint` with the full K x K covariance on the reference's
    inputs in float32: J finite, varG >= 0, and G and varG against the
    reference's float64 values on the same inputs (float32 rounding: G to
    1e-5, varG to 1e-3 relative)."""
    cfg, X, y, hyp, mu = _problem(np.log(1e-2))
    gp = gp_from_host(tcfg_of(cfg), X, y, None, hyp, n_bucket=32,
                      s_bucket=4, dtype=torch.float32)
    assert gp.Binv.dtype == torch.float32
    G, varG, _, _, J = teb.gplogjoint(tcfg_of(cfg), gp,
                                      *_vp_args(mu, 0.5, torch.float32),
                                      compute_var=1)
    assert G.dtype == torch.float32
    assert bool(torch.isfinite(J[:, :3]).all())
    assert float(varG) >= 0.0
    jgp = j_gp_from_host(cfg, X, y, None, hyp, n_bucket=32, s_bucket=4)
    Gr, varGr, _, _, _ = j_gplogjoint(
        cfg, jgp, jnp.asarray(mu), jnp.full(K, 0.5), jnp.ones(D),
        jnp.full(K, 1.0 / K), jnp.ones(K, bool), compute_var=1)
    np.testing.assert_allclose(float(G), float(Gr), rtol=1e-5)
    np.testing.assert_allclose(float(varG), float(varGr), rtol=1e-3)


def test_float32_guard_floor():
    """With a noise SD of 1e-4 and components on the data the prior and data
    terms of J cancel, and in float32 its diagonal goes below zero. The
    floor at float32's eps keeps varG positive, and the ELCBO's square root
    of it (floored at 1e-30, which float32 holds, where 1e-300 would round
    to 0) keeps the value and the gradient finite."""
    cfg, X, y, hyp, _ = _problem(np.log(1e-4))
    tcfg = tcfg_of(cfg)
    gp = gp_from_host(tcfg, X, y, None, hyp, n_bucket=32, s_bucket=4,
                      dtype=torch.float32)
    mu, sigma, lam, w, kmask = _vp_args(X[:K], 1e-3, torch.float32)
    _, varG, _, _, J = teb.gplogjoint(tcfg, gp, mu, sigma, lam, w, kmask,
                                      compute_var=1)
    eps = torch.finfo(torch.float32).eps
    assert float(torch.diagonal(J[:, :3], dim1=-2, dim2=-1).min()) < 0.0
    assert float(varG) >= eps and bool(torch.isfinite(varG).all())
    assert torch.tensor(1e-30, dtype=torch.float32) > 0
    flags = teb.VPFlags()
    theta = teb.pack_theta(flags, mu, sigma, lam, torch.log(w))
    F, g = value_and_grad(lambda th: teb.negelcbo(
        tcfg, th, gp, mu[0], sigma[0], lam[0], w[0], kmask, flags, 1.0, 0,
        1)[0], theta)
    assert F.dtype == torch.float32
    assert bool(torch.isfinite(F).all()) and bool(torch.isfinite(g).all())


def test_float32_whole_run():
    """The reduced run of `tests/test_float32.py:48-62` in float32, held to
    that file's gate (|ELBO| < 0.6, RMSE < 0.5) with a float32 posterior."""
    sd = np.array([1.0, 0.8])

    def logp(x):
        return float(-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
                     - np.sum(np.log(sd)))

    opts = VBMCOptions(display="off", max_fun_evals=28, seed=1,
                       min_final_components=8)
    res = vbmc(logp, x0=np.zeros(2), plb=np.full(2, -3.0),
               pub=np.full(2, 3.0), options=opts, device="cpu",
               dtype=torch.float32)
    assert res.vp.mu.dtype == torch.float32
    assert res.stats.iterations[-1].gp.Binv.dtype == torch.float32
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 4,
                         gen=torch.Generator().manual_seed(0))
    assert abs(res.elbo) < 0.6, res.elbo
    rmse = float(np.sqrt(np.mean(mean.double().numpy() ** 2)))
    assert rmse < 0.5, rmse
