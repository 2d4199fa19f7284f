"""The library names of the JAX package that are on no default path, each
against its twin in the port: the `gp` package's re-exports, `Posterior`,
`solve_K`, `predict_one`, `gram_matrix`, `kernel_diag`, `theta_size`,
`entropy_upper_bound`, `pdf_correction`, `build_is_state` and the
`OUTWARP_*` ids in float64 on the same inputs; `slice_sample_chain`,
`slice_sample_ensemble` and `vp_sample_theta` by their moments, as the two
generators differ."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vbmc_tpu.gp as jgp_pkg
from vbmc_tpu import elbo as jeb
from vbmc_tpu import transforms as jtr
from vbmc_tpu.active_is import build_is_state as j_build_is_state
from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp import kernels as jkern
from vbmc_tpu.gp import outwarp as jow
from vbmc_tpu.gp.predict import gp_predict_full as j_predict_full
from vbmc_tpu.options import VBMCOptions as JVBMCOptions
from vbmc_tpu.samplers.slice import (slice_sample_chain as j_chain,
                                     slice_sample_ensemble as j_ensemble)
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu.vpoptim import vp_sample_theta as j_vp_sample_theta
from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch import elbo as teb
from vbmc_tpu_torch import transforms as ttr
from vbmc_tpu_torch.active_is import build_is_state, build_is_state_core
from vbmc_tpu_torch.convert import gp_from_dict, vp_from_dict
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp import outwarp as tow
from vbmc_tpu_torch.gp.kernels import kernel_diag
from vbmc_tpu_torch.samplers.slice import (slice_sample_chain,
                                           slice_sample_ensemble)
from vbmc_tpu_torch.vpoptim import vp_sample_theta

from test_torch_elbo import _setup as elbo_setup
from test_torch_gp_problems import gp_problem, tcfg_of
from test_torch_transforms_vp import _points, _trinfos

torch.set_num_threads(1)


def test_gp_package_exports_the_reference_names():
    import vbmc_tpu_torch.gp as tgp_pkg
    from vbmc_tpu_torch.gp import GPConfig, gram_matrix, train_gp  # noqa
    assert tgp_pkg.__all__ == jgp_pkg.__all__
    for name in tgp_pkg.__all__:
        obj = getattr(tgp_pkg, name)
        assert obj.__module__.startswith("vbmc_tpu_torch.gp."), name
        assert obj.__name__ == name


def test_outwarp_ids_match_the_reference():
    names = [n for n in dir(jow) if n.startswith("OUTWARP_")]
    assert len(names) == 4
    assert all(getattr(tow, n) == getattr(jow, n) for n in names)
    assert tow.N_OUTWARP_HYP == jow.N_OUTWARP_HYP


def _padded(seed, **fam):
    cfg, X, y, s2, hyps = gp_problem(seed, **fam)
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    s2p = np.zeros(32) if s2 is None else pad_to(s2, 32)
    mask = np.arange(32) < X.shape[0]
    return cfg, Xp, yp, s2p, mask, hyps


FAMS = [dict(), dict(covfun=3, cov_nu=5), dict(outwarp=2),
        dict(intmean=2), dict(outwarp=3, intmean=2, meanfun=1)]
FAM_IDS = ["default", "matern5", "outwarp2", "intmean2", "outwarp3-intmean2"]


@pytest.mark.parametrize("fam", FAMS, ids=FAM_IDS)
def test_gram_matrix_and_kernel_diag_match_jax(fam):
    cfg, Xp, yp, s2p, mask, hyps = _padded(11, **fam)
    tcfg = tcfg_of(cfg)
    K = tcore.gram_matrix(tcfg, torch.tensor(hyps), torch.tensor(Xp),
                          torch.tensor(mask)).numpy()
    kd = kernel_diag(tcfg, torch.tensor(hyps), torch.tensor(Xp)).numpy()
    assert K.shape == (hyps.shape[0], 32, 32) and kd.shape == (
        hyps.shape[0], 32)
    for s in range(hyps.shape[0]):
        h = jnp.asarray(hyps[s])
        np.testing.assert_allclose(K[s], np.asarray(jcore.gram_matrix(
            cfg, h, jnp.asarray(Xp), jnp.asarray(mask))), rtol=1e-12,
            atol=1e-14)
        np.testing.assert_allclose(kd[s], np.asarray(jkern.kernel_diag(
            cfg, h, jnp.asarray(Xp))), rtol=1e-14)


@pytest.mark.parametrize("fam", FAMS, ids=FAM_IDS)
def test_posterior_solve_k_and_predict_one_match_jax(fam):
    """`Posterior.of` the port's batched factorisation, `solve_K` of a
    vector and of a matrix, and `predict_one` at 40 points, against the
    reference's per-sample functions: rtol 1e-9 as the factors of
    `test_torch_gp_extras.py`, 1e-8 for the prediction."""
    cfg, Xp, yp, s2p, mask, hyps = _padded(12, **fam)
    tcfg = tcfg_of(cfg)
    T = (torch.tensor(hyps), torch.tensor(Xp), torch.tensor(yp),
         torch.tensor(s2p), torch.tensor(mask))
    post = tcore.Posterior.of(tcore.build_posterior(tcfg, *T))
    assert post._fields == jcore.Posterior._fields
    rng = np.random.default_rng(13)
    v, V = rng.standard_normal(32), rng.standard_normal((32, 3))
    Xs = rng.uniform(-2.5, 2.5, (40, 3))
    x_v = tcore.solve_K(post, torch.tensor(v)).numpy()
    x_V = tcore.solve_K(post, torch.tensor(V)).numpy()
    fmu, fs2 = (a.numpy() for a in tcore.predict_one(
        tcfg, T[0], post, T[1], T[2], T[4], torch.tensor(Xs)))
    assert x_v.shape == (4, 32) and x_V.shape == (4, 32, 3)
    for s in range(hyps.shape[0]):
        jpost = jcore.build_posterior(cfg, jnp.asarray(hyps[s]),
                                      jnp.asarray(Xp), jnp.asarray(yp),
                                      jnp.asarray(s2p), jnp.asarray(mask))
        for name in ("alpha", "Binv", "sn2"):
            np.testing.assert_allclose(getattr(post, name)[s].numpy(),
                                       np.asarray(getattr(jpost, name)),
                                       rtol=1e-9, atol=1e-11, err_msg=name)
        assert bool(post.chol_ok[s]) == bool(jpost.chol_ok)
        np.testing.assert_allclose(x_v[s], np.asarray(jcore.solve_K(
            jpost, jnp.asarray(v))), rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(x_V[s], np.asarray(jcore.solve_K(
            jpost, jnp.asarray(V))), rtol=1e-9, atol=1e-10)
        jm, js = jcore.predict_one(cfg, jnp.asarray(hyps[s]), jpost,
                                   jnp.asarray(Xp), jnp.asarray(yp),
                                   jnp.asarray(mask), jnp.asarray(Xs))
        np.testing.assert_allclose(fmu[s], np.asarray(jm), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(fs2[s], np.asarray(js), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("flags", [(1, 1, 1, 0), (1, 1, 1, 1), (0, 1, 0, 1),
                                   (1, 0, 1, 0), (0, 0, 0, 0)])
@pytest.mark.parametrize("K, D", [(1, 1), (5, 3), (50, 10)])
def test_theta_size_matches_jax(flags, K, D):
    f = [bool(b) for b in flags]
    n = teb.theta_size(teb.VPFlags(*f), K, D)
    assert n == jeb.theta_size(jeb.VPFlags(*f), K, D)
    if any(f):
        z = torch.ones(1, K, D)
        theta = teb.pack_theta(teb.VPFlags(*f), z, z[..., 0], z[:, 0],
                               z[..., 0])
        assert theta.shape == (1, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entropy_upper_bound_matches_jax(seed):
    _, _, vp = elbo_setup(seed)
    args = [np.asarray(a) for a in (vp.mu, vp.sigma, vp.lam, vp.w)]
    km = np.asarray(vp.kmask)
    ref = float(jeb.entropy_upper_bound(*map(jnp.asarray, args),
                                        jnp.asarray(km)))
    # a batch of two: the VP and the same VP with its means shifted
    # (the bound is shift invariant)
    b = [torch.tensor(np.stack([a, a + (1.5 if i == 0 else 0.0)]))
         for i, a in enumerate(args)]
    H = teb.entropy_upper_bound(*b, torch.tensor(km)).numpy()
    np.testing.assert_allclose(H, [ref, ref], rtol=1e-12)
    # the upper bound is above the lower bound
    lb = teb.entropy_lower_bound(*b, torch.tensor(km)).numpy()
    assert np.all(H >= lb)


@pytest.mark.parametrize("bounded_type", [3, 12, 13])
@pytest.mark.parametrize("rotate", [False, True])
def test_pdf_correction_matches_jax(bounded_type, rotate):
    jt, tt = _trinfos(bounded_type, rotate)
    y = np.asarray(jtr.direct(jt, jnp.asarray(_points())))
    ref = np.asarray(jtr.pdf_correction(jt, jnp.asarray(y)))
    got = ttr.pdf_correction(tt, torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def _noisy_gp_vp():
    from test_torch_active_is import _setup as is_setup, _to_torch
    cfg, gp, vp, _, _, _ = is_setup()
    tgp, tvp = _to_torch(gp, vp)[:2]
    return cfg, gp, vp, tgp, tvp


@pytest.mark.parametrize("name", ["viqr", "imiqr"])
def test_build_is_state_matches_jax(name):
    """The wrapper takes the set's sizes and refresh settings from the
    options: the same set as `build_is_state_core` with those values on the
    same generator, as many points as the reference's wrapper makes, and
    at the port's own points the reference's predictive variance and
    B^-1 k(X, Xa) (rtol 1e-9)."""
    cfg, gp, vp, tgp, tvp = _noisy_gp_vp()
    tcfg = tcfg_of(cfg)
    kw = dict(active_importance_sampling_vp_samples=60,
              active_importance_sampling_box_samples=30,
              active_importance_sampling_mcmc_samples=40,
              active_importance_sampling_mh_steps=2)
    opts, jopts = VBMCOptions(**kw).resolve(2), JVBMCOptions(**kw).resolve(2)
    ais = build_is_state(torch.Generator().manual_seed(5), tcfg, name, tvp,
                         tgp, opts)
    core = build_is_state_core(
        torch.Generator().manual_seed(5), tcfg, name, tvp, tgp, 60, 30, 40,
        mh_steps=2,
        fess_thresh=opts.active_importance_sampling_fess_thresh)
    for f in dataclasses.fields(ais):
        assert torch.equal(getattr(ais, f.name), getattr(core, f.name))
    jais = j_build_is_state(jax.random.PRNGKey(5), cfg, name, vp, gp, jopts)
    assert ais.Xa.shape == jais.Xa.shape
    assert ais.ln_weights.shape == jais.ln_weights.shape
    w = torch.exp(ais.ln_weights[tgp.hyp_mask]).sum(1).numpy()
    np.testing.assert_allclose(w, 1.0, rtol=1e-12)
    Xa = jnp.asarray(ais.Xa.numpy())
    _, fs2 = j_predict_full(cfg, gp, Xa)
    np.testing.assert_allclose(ais.f_s2.numpy(), np.asarray(fs2), rtol=1e-9,
                               atol=1e-12)
    ks = jax.vmap(lambda h: jkern.kernel_cross(cfg, h, gp.X, Xa))(gp.hyp)
    ref = np.asarray(gp.Binv @ (ks * gp.mask[None, :, None]))
    np.testing.assert_allclose(ais.invKzk.numpy(), ref, rtol=1e-9,
                               atol=1e-11)


COV = np.array([[1.0, 0.6], [0.6, 0.8]])
PREC = np.linalg.inv(COV)


def _agree(name, a, b, rule=5.0):
    """Rows of ``a`` and ``b`` are independent replicates of a vector
    statistic: the two sides' means within ``rule`` of their standard
    error."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    z = np.abs(a.mean(0) - b.mean(0)) / se
    assert np.all(z < rule), (name, a.mean(0), b.mean(0), z)


def _gauss_stats(s):
    """Mean, variances and covariance of the draws of one chain (n, 2)."""
    c = np.cov(s.T)
    return np.concatenate([s.mean(0), [c[0, 0], c[1, 1], c[0, 1]]])


def test_slice_sample_chain_matches_jax_in_distribution():
    """Six chains a side, one per seed, on a correlated 2-D Gaussian: each
    chain's mean and covariance, side against side, within 5 standard
    errors of the replicates, and both near the truth; slots past n_keep
    hold zeros and -inf on both sides."""
    widths, lo = np.ones(2), np.full(2, -10.0)
    x0 = np.array([0.3, -0.2])
    run_j = jax.jit(lambda k: j_chain(
        k, lambda x: -0.5 * x @ jnp.asarray(PREC) @ x, jnp.asarray(x0),
        jnp.asarray(widths), jnp.asarray(lo), jnp.asarray(-lo), 300, 20, 1,
        320))
    P = torch.tensor(PREC)
    port, ref = [], []
    for seed in range(6):
        s, lp = slice_sample_chain(
            torch.Generator().manual_seed(seed), lambda x: -0.5 * x @ P @ x,
            torch.tensor(x0), torch.tensor(widths), torch.tensor(lo),
            torch.tensor(-lo), 300, 20, 1, 320)
        js, jlp = (np.asarray(a) for a in run_j(jax.random.PRNGKey(seed)))
        assert s.shape == (320, 2) and lp.shape == (320,)
        for buf, lbuf in ((s.numpy(), lp.numpy()), (js, jlp)):
            assert np.all(buf[300:] == 0) and np.all(lbuf[300:] == -np.inf)
            assert np.all(np.isfinite(lbuf[:300]))
        np.testing.assert_allclose(
            lp[:300].numpy(), -0.5 * np.einsum("ni,ij,nj->n", s[:300].numpy(),
                                               PREC, s[:300].numpy()),
            rtol=1e-12)
        port.append(_gauss_stats(s[:300].numpy()))
        ref.append(_gauss_stats(js[:300]))
    port, ref = np.array(port), np.array(ref)
    _agree("slice_sample_chain", port, ref)
    truth = np.array([0.0, 0.0, COV[0, 0], COV[1, 1], COV[0, 1]])
    np.testing.assert_allclose(port.mean(0), truth, atol=0.25)


def test_slice_sample_ensemble_matches_jax_in_distribution():
    """Eight chains a side advanced together, in bounds [-0.5, 2] x [-1, 1]:
    every draw inside, and the chains' means and covariances against the
    reference's as above."""
    C = 8
    lb, ub = np.array([-0.5, -1.0]), np.array([2.0, 1.0])
    x0s = np.random.default_rng(0).uniform(-0.4, 0.9, (C, 2))
    js, jlp = jax.jit(lambda k: j_ensemble(
        k, lambda x: -0.5 * x @ jnp.asarray(PREC) @ x, jnp.asarray(x0s),
        jnp.ones(2), jnp.asarray(lb), jnp.asarray(ub), 200, 20, 2, 200))(
            jax.random.PRNGKey(1))
    P = torch.tensor(PREC)
    s, lp = slice_sample_ensemble(
        torch.Generator().manual_seed(1), lambda x: -0.5 * x @ P @ x,
        torch.tensor(x0s), torch.ones(2, dtype=torch.float64),
        torch.tensor(lb), torch.tensor(ub), 200, 20, 2, 200)
    js = np.asarray(js)
    assert s.shape == js.shape == (C, 200, 2)
    assert lp.shape == np.asarray(jlp).shape == (C, 200)
    s = s.numpy()
    assert np.all((s >= lb) & (s <= ub))
    _agree("slice_sample_ensemble", np.array([_gauss_stats(c) for c in s]),
           np.array([_gauss_stats(c) for c in js]))


@pytest.mark.parametrize("sampler, n", [("mala", 30), ("slice", 6)])
def test_vp_sample_theta_matches_jax_in_distribution(sampler, n):
    """Six chains a side from the same VP and GP (seeds 0-5), ``n`` steps or
    sweeps each (a slice sweep updates all 35 coordinates), each returning
    the VP at its last state: the returned VPs' log densities (minus the
    negative ELBO with the soft bounds) and their mean component means,
    side against side within 5 standard errors. The components' weights
    and the mask stay as they were; lambda keeps ||lambda||^2 = D."""
    cfg, gp, vp = elbo_setup(0)
    tcfg, tgp = tcfg_of(cfg), gp_from_dict(jax.device_get(gp._asdict()))
    tvp = vp_from_dict(jax.device_get(vp._asdict()))
    D = vp.D
    opts, jopts = VBMCOptions().resolve(D), JVBMCOptions().resolve(D)
    flags = teb.VPFlags(opt_weights=False)
    K = int(np.sum(np.asarray(vp.kmask)))
    bnd = teb.compute_vp_bounds(tgp, opts, K)

    def summary(mu, sigma, lam):
        th = teb.pack_theta(flags, mu[None], sigma[None], lam[None],
                            tvp.eta[None])
        F, _ = teb.negelcbo(tcfg, th, tgp, tvp.mu, tvp.sigma, tvp.lam,
                            tvp.w, tvp.kmask, flags, 0.0, 0, 0, bnd=bnd,
                            use_bounds=True)
        return np.concatenate([[-float(F[0])],
                               mu[tvp.kmask].mean(0).numpy()])

    port, ref = [], []
    for seed in range(6):
        out = vp_sample_theta(torch.Generator().manual_seed(seed), tcfg, tvp,
                              tgp, n, opts, sampler=sampler)
        assert torch.equal(out.w, tvp.w) and torch.equal(out.kmask,
                                                         tvp.kmask)
        np.testing.assert_allclose(float((out.lam ** 2).sum()), D,
                                   rtol=1e-12)
        port.append(summary(out.mu, out.sigma, out.lam))
        jout = j_vp_sample_theta(jax.random.PRNGKey(seed), cfg, vp, gp, n,
                                 jopts, sampler=sampler)
        ref.append(summary(*(torch.tensor(np.asarray(a)) for a in (
            jout.mu, jout.sigma, jout.lam))))
    port, ref = np.array(port), np.array(ref)
    start = summary(tvp.mu, tvp.sigma, tvp.lam)
    assert np.all(np.isfinite(port)) and np.all(np.isfinite(ref))
    # the chains moved
    assert np.any(np.abs(port - start) > 1e-6)
    _agree(f"vp_sample_theta {sampler}", port, ref)


def test_vp_sample_theta_follows_variational_sampler():
    """Without ``sampler`` the option `variational_sampler` picks it: the
    reference's names "malasample" and "slicesample" give the same chain
    as "mala" and "slice" on the same generator."""
    cfg, gp, vp = elbo_setup(1)
    tcfg, tgp = tcfg_of(cfg), gp_from_dict(jax.device_get(gp._asdict()))
    tvp = vp_from_dict(jax.device_get(vp._asdict()))
    for opt_name, name in (("malasample", "mala"), ("slicesample", "slice")):
        opts = VBMCOptions(variational_sampler=opt_name).resolve(vp.D)
        a = vp_sample_theta(torch.Generator().manual_seed(3), tcfg, tvp, tgp,
                            5, opts)
        b = vp_sample_theta(torch.Generator().manual_seed(3), tcfg, tvp, tgp,
                            5, opts, sampler=name)
        assert torch.equal(a.mu, b.mu) and torch.equal(a.sigma, b.sigma)
