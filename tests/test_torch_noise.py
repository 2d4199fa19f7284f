"""The port's noisy-target GP against the JAX reference on the same float64
inputs: the per-point noise variance, the posterior factorisation, nlZ and
its gradient with user noise (``user_noise`` 1: the target's own SD;
``user_noise`` 2: rescaled by a hyperparameter), the hyperprior at
uncertainty levels 1 and 2, and noise shaping."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp.noise import noise_variance as j_noise_variance
from vbmc_tpu.gp.fit import TrainOptions as JTrainOptions, \
    assemble_hyp_prior as j_prior
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu.main import _noise_shaping as j_noise_shaping
from vbmc_tpu.options import VBMCOptions as JVBMCOptions
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, assemble_hyp_prior
from vbmc_tpu_torch.gp.gp import gp_from_host as t_gp_from_host
from vbmc_tpu_torch.gp.noise import noise_variance
from vbmc_tpu_torch.main import _noise_shaping

torch.set_num_threads(1)

D, N, NB, S = 2, 20, 32, 3


def _problem(seed, user_noise):
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, user_noise=user_noise)
    X = rng.uniform(-2, 2, (N, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.3 * rng.standard_normal(N)
    s2 = rng.uniform(0.05, 0.5, N)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.9) + 0.1 * rng.standard_normal((S, D))
    hyps[:, D] = 0.2 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.1)
    if user_noise == 2:
        hyps[:, cfg.ncov + 1] = 0.3 * rng.standard_normal(S)
    i_m = cfg.ncov + cfg.nnoise
    hyps[:, i_m] = 0.3
    hyps[:, i_m + 1:i_m + 1 + D] = 0.1 * rng.standard_normal((S, D))
    hyps[:, i_m + 1 + D:] = np.log(1.2)
    return cfg, X, y, s2, hyps


@pytest.mark.parametrize("user_noise", [1, 2])
def test_noise_variance_matches_jax(user_noise):
    cfg, X, y, s2, hyps = _problem(0, user_noise)
    tcfg = TGPConfig(D=D, user_noise=user_noise)
    got = noise_variance(tcfg, torch.tensor(hyps[:, cfg.sl_noise]), N,
                         torch.tensor(s2)).numpy()
    for s in range(S):
        ref = np.asarray(j_noise_variance(
            cfg, jnp.asarray(hyps[s, cfg.sl_noise]), jnp.asarray(X),
            s2=jnp.asarray(s2)))
        np.testing.assert_allclose(got[s], ref, rtol=1e-12)


@pytest.mark.parametrize("user_noise", [1, 2])
def test_build_gp_with_user_noise_matches_jax(user_noise):
    cfg, X, y, s2, hyps = _problem(1, user_noise)
    jgp = j_gp_from_host(cfg, X, y, s2, hyps, n_bucket=NB, s_bucket=S)
    tgp = t_gp_from_host(TGPConfig(D=D, user_noise=user_noise), X, y, s2,
                         hyps, n_bucket=NB, s_bucket=S)
    for name in ("alpha", "Binv", "L", "sn2", "s2"):
        np.testing.assert_allclose(getattr(tgp, name).numpy(),
                                   np.asarray(getattr(jgp, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("user_noise", [1, 2])
def test_nlz_and_gradient_with_user_noise_match_jax(user_noise):
    cfg, X, y, s2, hyps = _problem(2, user_noise)
    Xp, yp, s2p = pad_to(X, NB), pad_to(y, NB), pad_to(s2, NB)
    mask = np.arange(NB) < N

    def jf(h):
        return jcore.neg_log_marginal_likelihood(
            cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(s2p),
            jnp.asarray(mask))

    th = torch.tensor(hyps, requires_grad=True)
    nlz_t = tcore.neg_log_marginal_likelihood(
        TGPConfig(D=D, user_noise=user_noise), th, torch.tensor(Xp),
        torch.tensor(yp), torch.tensor(s2p), torch.tensor(mask))
    (g_t,) = torch.autograd.grad(nlz_t.sum(), th)
    for s in range(S):
        v, g = jax.value_and_grad(jf)(jnp.asarray(hyps[s]))
        np.testing.assert_allclose(nlz_t[s].item(), float(v), rtol=1e-9)
        np.testing.assert_allclose(g_t[s].numpy(), np.asarray(g), rtol=1e-9,
                                   atol=1e-11)


@pytest.mark.parametrize("level,noise_size", [(1, None), (2, None),
                                              (1, 0.3), (2, 0.3)])
def test_hyp_prior_at_uncertainty_levels_matches_jax(level, noise_size):
    """Level 1 (noise inferred) maps to user_noise 2, level 2 (noise SD
    given) to user_noise 1, as in the orchestrator."""
    user_noise = {1: 2, 2: 1}[level]
    cfg, X, y, _, _ = _problem(3, user_noise)
    plb, pub = np.full(D, -2.0), np.full(D, 2.0)
    jp, jx0 = j_prior(cfg, X, y, plb, pub,
                      JTrainOptions(uncertainty_level=level,
                                    noise_size=noise_size))
    tp, tx0 = assemble_hyp_prior(TGPConfig(D=D, user_noise=user_noise), X, y,
                                 plb, pub,
                                 TrainOptions(uncertainty_level=level,
                                              noise_size=noise_size))
    np.testing.assert_array_equal(tx0, np.asarray(jx0))
    for name in ("mu", "sigma", "df", "lb", "ub", "plb", "pub"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


@pytest.mark.parametrize("with_s2", [True, False])
def test_noise_shaping_matches_jax(with_s2):
    rng = np.random.default_rng(4)
    y = rng.uniform(-60.0, 0.0, 30)
    s2 = rng.uniform(0.1, 1.0, 30) if with_s2 else None
    opts = VBMCOptions(noise_shaping=True).resolve(D)
    jopts = JVBMCOptions(noise_shaping=True).resolve(D)
    np.testing.assert_array_equal(_noise_shaping(s2, y, opts),
                                  j_noise_shaping(s2, y, jopts))
