"""The port's GP extras against the JAX reference in float64: output warps,
the integrated mean, output-dependent noise, every mean family, through
nlZ and its gradient, `build_gp` and `gp_predict`; and `gp_quad`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp import outwarp as jow
from vbmc_tpu.gp.fit import (TrainOptions as JTrainOptions,
                             assemble_hyp_prior as j_assemble)
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu.gp.predict import gp_predict as j_gp_predict
from vbmc_tpu.gp.quad import gp_quad as j_gp_quad
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu_torch.convert import gp_from_dict
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp import outwarp as tow
from vbmc_tpu_torch.gp.fit import TrainOptions, assemble_hyp_prior
from vbmc_tpu_torch.gp.gp import gp_from_host as t_gp_from_host
from vbmc_tpu_torch.gp.predict import gp_predict as t_gp_predict
from vbmc_tpu_torch.gp.quad import gp_quad as t_gp_quad

from test_torch_gp_problems import ALL_MEANFUNS, gp_problem, tcfg_of

torch.set_num_threads(1)

# every family of the GP library: the mean families, each output warp, each
# integrated mean, output-dependent noise with and without user noise
FAMILIES = ([dict(meanfun=m) for m in ALL_MEANFUNS]
            + [dict(outwarp=w) for w in (1, 2, 3)]
            + [dict(intmean=i) for i in (1, 2, 3, 4)]
            + [dict(output_noise=1), dict(output_noise=1, user_noise=2,
                                          noisy=True),
               dict(outwarp=2, user_noise=1, noisy=True),
               dict(outwarp=3, intmean=2, meanfun=1),
               dict(intmean=3, meanfun=0, covfun=3, cov_nu=3)])
IDS = ["-".join(f"{k}{v}" for k, v in f.items()) for f in FAMILIES]


@pytest.mark.parametrize("wid", [1, 2, 3])
def test_outwarp_functions_match_jax(wid):
    """direct, inverse and deriv at rtol 1e-12, and inverse(direct(y)) = y."""
    rng = np.random.default_rng(0)
    y = rng.uniform(-30, 2, 40)
    hyp = np.zeros((3, tow.N_OUTWARP_HYP[wid]))
    hyp[:, 0] = rng.uniform(-10, -2, 3)
    hyp[:, 1:] = 0.4 * rng.standard_normal((3, hyp.shape[1] - 1))
    th, ty = torch.tensor(hyp), torch.tensor(y)
    t = tow.outwarp_direct(wid, th, ty)
    for s in range(3):
        h = jnp.asarray(hyp[s])
        t_ref = jow.outwarp_direct(wid, h, jnp.asarray(y))
        np.testing.assert_allclose(t[s].numpy(), np.asarray(t_ref),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            tow.outwarp_deriv(wid, th, ty)[s].numpy(),
            np.asarray(jow.outwarp_deriv(wid, h, jnp.asarray(y))), rtol=1e-12)
        np.testing.assert_allclose(
            tow.outwarp_inverse(wid, th, t)[s].numpy(),
            np.asarray(jow.outwarp_inverse(wid, h, t_ref)), rtol=1e-12)
    np.testing.assert_allclose(tow.outwarp_inverse(wid, th, t).numpy(),
                               np.broadcast_to(y, t.shape), rtol=1e-10)
    ref = jow.outwarp_info(wid, y)
    got = tow.outwarp_info(wid, y)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_unknown_outwarp_raises():
    with pytest.raises(ValueError, match="unknown outwarp"):
        tow.outwarp_direct(7, torch.zeros(1, 2), torch.zeros(3))


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_nlz_and_gradient_match_jax(fam):
    """Value and gradient against `jax.value_and_grad` at rtol 1e-8, the
    tolerance of `test_torch_gp.py` for the same quantity."""
    cfg, X, y, s2, hyps = gp_problem(1, **fam)
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    s2p = np.zeros(32) if s2 is None else pad_to(s2, 32)
    mask = np.arange(32) < X.shape[0]
    th = torch.tensor(hyps, requires_grad=True)
    nlz = tcore.neg_log_marginal_likelihood(
        tcfg_of(cfg), th, torch.tensor(Xp), torch.tensor(yp),
        torch.tensor(s2p), torch.tensor(mask))
    (g,) = torch.autograd.grad(nlz.sum(), th)
    for s in range(hyps.shape[0]):
        v_ref, g_ref = jax.value_and_grad(
            lambda h: jcore.neg_log_marginal_likelihood(
                cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(s2p),
                jnp.asarray(mask)))(jnp.asarray(hyps[s]))
        np.testing.assert_allclose(nlz[s].item(), float(v_ref), rtol=1e-8)
        np.testing.assert_allclose(g[s].numpy(), np.asarray(g_ref),
                                   rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_build_gp_and_predict_match_jax(fam):
    """The posterior's factors at rtol 1e-9 (the integrated mean's Ainv
    goes through a second factorisation: 1e-7), the prediction at 1e-8."""
    cfg, X, y, s2, hyps = gp_problem(2, **fam)
    jgp = j_gp_from_host(cfg, X, y, s2, hyps, n_bucket=32, s_bucket=4)
    tcfg = tcfg_of(cfg)
    tgp = t_gp_from_host(tcfg, X, y, s2, hyps, n_bucket=32, s_bucket=4)
    for name in ("alpha", "Binv", "L", "sn2"):
        np.testing.assert_allclose(getattr(tgp, name).numpy(),
                                   np.asarray(getattr(jgp, name)),
                                   rtol=1e-9, atol=1e-11, err_msg=name)
    for name in ("betabar", "HBinv", "Ainv"):
        if cfg.nint == 0:
            assert getattr(tgp, name) is None
            continue
        ref = np.asarray(getattr(jgp, name))
        np.testing.assert_allclose(getattr(tgp, name).numpy(), ref,
                                   rtol=1e-7, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    Xs = np.random.default_rng(3).uniform(-2.5, 2.5, (50, 3))
    ref = [np.asarray(a) for a in j_gp_predict(cfg, jgp, jnp.asarray(Xs))]
    # from the reference's own factors, so that only the prediction differs
    tgp_j = gp_from_dict(jax.device_get(jgp._asdict()))
    got = [a.numpy() for a in t_gp_predict(tcfg, tgp_j, torch.tensor(Xs))]
    for g_, r_, name in zip(got, ref, ("fbar", "vtot", "fmu", "fs2")):
        np.testing.assert_allclose(g_, r_, rtol=1e-8, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("wid", [1, 2, 3])
@pytest.mark.parametrize("delta", [None, 4.0])
def test_outwarp_hyp_prior_matches_jax(wid, delta):
    """The threshold's bound, half-Cauchy prior and the power's bounds
    (rtol 1e-12)."""
    cfg, X, y, _, _ = gp_problem(4, outwarp=wid)
    plb, pub = np.full(3, -2.0), np.full(3, 2.0)
    kw = dict(outwarp_delta=delta,
              outwarp_thresh_base=None if delta is None else 2.5)
    jp, jx0 = j_assemble(cfg, X, y, plb, pub, JTrainOptions(**kw))
    tp, tx0 = assemble_hyp_prior(tcfg_of(cfg), X, y, plb, pub,
                                 TrainOptions(**kw))
    np.testing.assert_allclose(tx0, jx0, rtol=1e-12)
    for name in ("mu", "sigma", "df", "lb", "ub", "plb", "pub"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-12, err_msg=name)


QUAD_FAMILIES = ([dict(meanfun=m) for m in ALL_MEANFUNS]
                 + [dict(intmean=i) for i in (1, 2, 3, 4)])


@pytest.mark.parametrize("fam", QUAD_FAMILIES,
                         ids=["-".join(f"{k}{v}" for k, v in f.items())
                              for f in QUAD_FAMILIES])
@pytest.mark.parametrize("compute_var", [False, True])
def test_gp_quad_matches_jax(fam, compute_var):
    """The Gaussian integral of the GP at M points, mean and variance, at
    rtol 1e-8 (products with the reference's own Binv)."""
    cfg, X, y, _, hyps = gp_problem(5, **fam)
    jgp = j_gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=4)
    tgp = gp_from_dict(jax.device_get(jgp._asdict()))
    rng = np.random.default_rng(6)
    mu = rng.uniform(-1.5, 1.5, (9, 3))
    sigma = 0.2 + rng.random(3)
    ref = j_gp_quad(cfg, jgp, jnp.asarray(mu), jnp.asarray(sigma),
                    compute_var=compute_var)
    got = t_gp_quad(tcfg_of(cfg), tgp, torch.tensor(mu), torch.tensor(sigma),
                    compute_var=compute_var)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-10)
    if compute_var:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-8, atol=1e-10)
    else:
        assert got[1] is None


def test_gp_quad_refuses_other_covariances():
    cfg, X, y, _, hyps = gp_problem(7, covfun=3)
    tgp = t_gp_from_host(tcfg_of(cfg), X, y, None, hyps, 32, 4)
    with pytest.raises(ValueError, match="SE-ard"):
        t_gp_quad(tcfg_of(cfg), tgp, torch.zeros(2, 3), torch.ones(2, 3))


def _vp_arrays(seed, K=5, KMAX=8, D=3):
    rng = np.random.default_rng(seed)
    mu = np.zeros((KMAX, D))
    mu[:K] = rng.uniform(-1, 1, (K, D))
    sigma = np.ones(KMAX)
    sigma[:K] = 0.3 + 0.2 * rng.random(K)
    lam = np.exp(0.1 * rng.standard_normal(D))
    lam *= np.sqrt(D / np.sum(lam ** 2))
    w = np.zeros(KMAX)
    w[:K] = rng.random(K) + 0.3
    return mu, sigma, lam, w / w.sum(), np.arange(KMAX) < K


@pytest.mark.parametrize("fam", QUAD_FAMILIES,
                         ids=["-".join(f"{k}{v}" for k, v in f.items())
                              for f in QUAD_FAMILIES])
def test_gplogjoint_matches_jax(fam):
    """G, its variance, I_sk and J_sjk for every mean family and every
    integrated mean, at rtol 1e-8 as in `test_torch_elbo.py`."""
    from vbmc_tpu import elbo as jeb
    from vbmc_tpu_torch import elbo as teb
    cfg, X, y, _, hyps = gp_problem(8, n=30, **fam)
    jgp = j_gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=4)
    tgp = gp_from_dict(jax.device_get(jgp._asdict()))
    mu, sigma, lam, w, kmask = _vp_arrays(9)
    ref = jeb.gplogjoint(cfg, jgp, *(jnp.asarray(a) for a in
                                     (mu, sigma, lam, w, kmask)),
                         compute_var=1)
    got = teb.gplogjoint(tcfg_of(cfg), tgp, torch.tensor(mu)[None],
                         torch.tensor(sigma)[None], torch.tensor(lam)[None],
                         torch.tensor(w)[None], torch.tensor(kmask),
                         compute_var=1)
    for g_, r_, name in zip(got, ref, ("G", "varG", "varss", "I", "J")):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(g_[0].numpy(), r_, rtol=1e-8,
                                   atol=1e-10 * max(1.0, np.abs(r_).max()),
                                   err_msg=name)


@pytest.mark.parametrize("covfun", [0, 3])
def test_elbo_refuses_other_covariances(covfun):
    """seiso and Matérn are GP-library families: the quadrature raises the
    reference's ValueError (`tests/test_covfun.py:152`)."""
    from vbmc_tpu_torch import elbo as teb
    cfg, X, y, _, hyps = gp_problem(10, covfun=covfun)
    tgp = t_gp_from_host(tcfg_of(cfg), X, y, None, hyps, 32, 4)
    mu, sigma, lam, w, kmask = _vp_arrays(11)
    with pytest.raises(ValueError, match="SE-ard"):
        teb.gplogjoint(tcfg_of(cfg), tgp, torch.tensor(mu)[None],
                       torch.tensor(sigma)[None], torch.tensor(lam)[None],
                       torch.tensor(w)[None], torch.tensor(kmask))
