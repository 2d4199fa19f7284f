"""The port's Bayesian-quadrature ELBO against the JAX reference at the same
theta: negelcbo value and gradient, the entropy estimators and the precise
elbo_stats."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu import elbo as jeb
from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp.gp import gp_from_host
from vbmc_tpu.options import VBMCOptions as JVBMCOptions
from vbmc_tpu.transforms import create_trinfo
from vbmc_tpu.vp import make_vp
from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch import elbo as teb
from vbmc_tpu_torch.convert import gp_from_dict
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig

torch.set_num_threads(1)

D, K, KMAX, S = 3, 5, 8, 4


def _setup(seed=0, meanfun=4):
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, meanfun=meanfun)
    X = rng.uniform(-2, 2, (30, D))
    y = -0.5 * np.sum(X ** 2, 1)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.9) + 0.1 * rng.standard_normal((S, D))
    hyps[:, D] = 0.1 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.05)
    i_m = cfg.ncov + cfg.nnoise
    if cfg.nmean:
        hyps[:, i_m] = 0.2
    if meanfun == 4:
        hyps[:, i_m + 1 + D:] = np.log(1.3)
    gp = gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=S)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D, [2.0] * D)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)), 0.3 + 0.2 * rng.random(K),
                 np.exp(0.1 * rng.standard_normal(D)), w=w / w.sum(),
                 k_max=KMAX)
    return cfg, gp, vp


def _theta(flags, vp):
    return np.asarray(jeb.pack_theta(flags, vp.mu, vp.sigma, vp.lam, vp.eta))


def _torch_args(vp):
    return (torch.tensor(np.asarray(vp.mu)), torch.tensor(np.asarray(vp.sigma)),
            torch.tensor(np.asarray(vp.lam)), torch.tensor(np.asarray(vp.w)),
            torch.tensor(np.asarray(vp.kmask)))


@pytest.mark.parametrize("opt_weights", [False, True])
@pytest.mark.parametrize("compute_var", [0, 1])
def test_negelcbo_value_and_gradient_match_jax(opt_weights, compute_var):
    cfg, gp, vp = _setup()
    opts, jopts = VBMCOptions().resolve(D), JVBMCOptions().resolve(D)
    flags = jeb.VPFlags(opt_weights=opt_weights)
    theta = _theta(flags, vp)
    jbnd = jeb.compute_vp_bounds(gp, jopts, K)
    beta = 0.5 if compute_var else 0.0

    def jf(th):
        F, _ = jeb.negelcbo(cfg, th, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                            vp.kmask, flags, beta, 0, compute_var,
                            jax.random.PRNGKey(0), bnd=jbnd, use_bounds=True)
        return F

    v_ref, g_ref = jax.value_and_grad(jf)(jnp.asarray(theta))

    tgp = gp_from_dict(jax.device_get(gp._asdict()))
    tflags = teb.VPFlags(opt_weights=opt_weights)
    tbnd = teb.compute_vp_bounds(tgp, opts, K)
    th = torch.tensor(theta[None, :], requires_grad=True)
    F, _ = teb.negelcbo(TGPConfig(D=D), th, tgp, *_torch_args(vp), tflags,
                        beta, 0, compute_var, bnd=tbnd, use_bounds=True)
    (g,) = torch.autograd.grad(F.sum(), th)
    np.testing.assert_allclose(F.item(), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_ref), rtol=1e-7,
                               atol=1e-9)


def test_entropy_lower_bound_matches_jax():
    _, _, vp = _setup(1)
    ref = float(jeb.entropy_lower_bound(vp.mu, vp.sigma, vp.lam, vp.w,
                                        vp.kmask))
    mu, sigma, lam, w, kmask = _torch_args(vp)
    got = teb.entropy_lower_bound(mu[None], sigma[None], lam[None], w[None],
                                  kmask)
    np.testing.assert_allclose(got.item(), ref, rtol=1e-12)


def test_entropy_mc_matches_jax_on_the_same_normals():
    _, _, vp = _setup(2)
    key = jax.random.PRNGKey(4)
    n_per_k = 64
    ref = float(jeb.entropy_mc(key, vp.mu, vp.sigma, vp.lam, vp.w, vp.kmask,
                               n_per_k))
    eps = np.asarray(jax.random.normal(key, (KMAX, n_per_k // 2, D)))
    mu, sigma, lam, w, kmask = _torch_args(vp)
    got = teb.entropy_mc(mu[None], sigma[None], lam[None], w[None], kmask,
                         torch.tensor(eps)[None])
    np.testing.assert_allclose(got.item(), ref, rtol=1e-10)


@pytest.mark.parametrize("meanfun", [0, 1, 4])
def test_elbo_stats_match_jax(meanfun):
    cfg, gp, vp = _setup(3, meanfun=meanfun)
    flags = jeb.VPFlags(opt_weights=True)
    theta = _theta(flags, vp)
    ref = jax.device_get(jeb.elbo_stats(cfg, jnp.asarray(theta), gp, vp.mu,
                                        vp.sigma, vp.lam, vp.w, vp.kmask,
                                        flags, 0, 1, jax.random.PRNGKey(0)))
    tgp = gp_from_dict(jax.device_get(gp._asdict()))
    got = teb.elbo_stats(TGPConfig(D=D, meanfun=meanfun),
                         torch.tensor(theta[None]), tgp, *_torch_args(vp),
                         teb.VPFlags(opt_weights=True), 0, 1)
    for name in ("elbo", "G", "H", "varF", "varss", "I_sk", "J_sjk", "w"):
        np.testing.assert_allclose(got[name][0].numpy(), np.asarray(ref[name]),
                                   rtol=1e-8, atol=1e-12, err_msg=name)


def test_batched_rows_are_independent():
    """A batch of thetas gives each row the value it has alone."""
    cfg, gp, vp = _setup(4)
    tgp = gp_from_dict(jax.device_get(gp._asdict()))
    flags = teb.VPFlags()
    th0 = torch.tensor(_theta(jeb.VPFlags(), vp))
    ths = torch.stack([th0, th0 + 0.05, th0 - 0.1])
    F, _ = teb.negelcbo(TGPConfig(D=D), ths, tgp, *_torch_args(vp), flags,
                        0.0, 0, 1)
    for i in range(3):
        Fi, _ = teb.negelcbo(TGPConfig(D=D), ths[i:i + 1], tgp,
                             *_torch_args(vp), flags, 0.0, 0, 1)
        np.testing.assert_allclose(F[i].item(), Fi.item(), rtol=1e-12)
