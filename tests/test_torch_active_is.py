"""The port's VIQR / IMIQR machinery against the JAX reference: the
nearest-noise lookup, the plain evaluation on the same (converted)
importance-sampling state, the plain sweep against the Pallas kernel
`fused_viqr_acq` in interpret mode on the padded inputs of
`tests/test_pallas.py`, the proposal density, and the stochastic IS set
against the grid oracle of `tests/test_active_is.py`, the kernel integral
`int_kernel` of "eig", and the sweep's choice between the kernel's wrapper
and the plain evaluation. The CUDA kernel itself runs only on the card (the `cuda` case skips here; `chip_smoke.py` carries
it)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp.gp import gp_from_host
from vbmc_tpu.vp import make_vp
from vbmc_tpu.transforms import create_trinfo
from vbmc_tpu.acquisitions import AcqState, _nearest_noise as j_nearest
from vbmc_tpu.active_is import (build_is_state_core as j_build,
                                evaluate_is_acquisition as j_evaluate,
                                int_kernel as j_int_kernel,
                                _mixture_draw as j_mixture_draw)
from vbmc_tpu.pallas_kernels import fused_viqr_acq
from vbmc_tpu_torch import acquisitions as tacq
from vbmc_tpu_torch import active_is as tis
from vbmc_tpu_torch import kernels
from vbmc_tpu_torch.convert import (gp_from_dict, is_state_from_dict,
                                    vp_from_dict)
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from test_active_is import _np_viqr_oracle, _setup as _oracle_setup

torch.set_num_threads(1)

D, S = 2, 4


def _setup(seed=42, n=30, K=5, M=512, name="viqr", bounded=False):
    """The noisy problem of `tests/test_pallas.py:64-126`, with a JAX IS
    state built by the reference."""
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, user_noise=1)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.2 * rng.standard_normal(n)
    s2 = np.full(n, 0.25)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8) + 0.05 * rng.standard_normal((S, D))
    hyps[:, D] = 0.1 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.1)
    hyps[:, cfg.ncov + cfg.nnoise] = 0.3
    hyps[:, cfg.ncov + cfg.nnoise + 1 + D:] = np.log(1.2)
    gp = gp_from_host(cfg, X, y, s2, hyps, n_bucket=32, s_bucket=S)
    if bounded:
        trinfo = create_trinfo([-3.0] * D, [3.0] * D, [-2.0] * D, [2.0] * D)
    else:
        trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                               [2.0] * D)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)),
                 0.4 + 0.2 * rng.random(K), np.ones(D), w=w / w.sum(),
                 k_max=8)
    ais = j_build(jax.random.PRNGKey(3), cfg, name, vp, gp, 40, 24, 40,
                  mh_steps=2, fess_thresh=0.9)
    Xs = rng.uniform(-2.5, 2.5, (M, D))
    gls = rng.uniform(0.5, 1.5, D)
    return cfg, gp, vp, ais, Xs, gls


def _jstate(gls, regularize=True, lb=-np.inf, ub=np.inf):
    return AcqState(ymax=jnp.asarray(0.7), tol_var=jnp.asarray(1e-4),
                    lb_eps_orig=jnp.full((D,), lb),
                    ub_eps_orig=jnp.full((D,), ub),
                    gp_length_scale=jnp.asarray(gls),
                    var_log_joint=jnp.ones(S),
                    regularize=jnp.asarray(regularize))


def _tstate(gls, regularize=True, lb=-np.inf, ub=np.inf):
    return tacq.AcqState(
        ymax=torch.tensor(0.7), tol_var=torch.tensor(1e-4),
        lb_eps_orig=torch.full((D,), lb, dtype=torch.float64),
        ub_eps_orig=torch.full((D,), ub, dtype=torch.float64),
        regularize=regularize, gp_length_scale=torch.tensor(gls))


def _to_torch(gp, vp, ais=None):
    out = (gp_from_dict(jax.device_get(gp._asdict())),
           vp_from_dict(jax.device_get(vp._asdict())))
    if ais is not None:
        out += (is_state_from_dict(jax.device_get(ais._asdict())),)
    return out


def test_nearest_noise_matches_jax():
    cfg, gp, vp, _, Xs, gls = _setup()
    ref = np.asarray(j_nearest(cfg, gp, jnp.asarray(Xs), _jstate(gls)))
    tgp, _ = _to_torch(gp, vp)
    got = tacq._nearest_noise(TGPConfig(D=D, user_noise=1), tgp,
                              torch.tensor(Xs), _tstate(gls)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["viqr", "imiqr"])
@pytest.mark.parametrize("M", [512, 500])
@pytest.mark.parametrize("regularize", [True, False])
def test_evaluate_is_acquisition_matches_jax(name, M, regularize):
    cfg, gp, vp, ais, Xs, gls = _setup(M=M, name=name)
    # A threshold above part of the candidates' variances engages the
    # regularisation where it is on.
    st_j = _jstate(gls, regularize)._replace(tol_var=jnp.asarray(0.05))
    ref = np.asarray(j_evaluate(cfg, name, jnp.asarray(Xs), vp, gp, st_j,
                                ais))
    tgp, tvp, tais = _to_torch(gp, vp, ais)
    st_t = _tstate(gls, regularize)
    st_t.tol_var = torch.tensor(0.05)
    got = tis.evaluate_is_acquisition(TGPConfig(D=D, user_noise=1), name,
                                      torch.tensor(Xs), tvp, tgp, st_t,
                                      tais).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)
    assert int(np.argmin(got)) == int(np.argmin(ref))
    swept = tis.sweep_is_acquisition(TGPConfig(D=D, user_noise=1), name,
                                     torch.tensor(Xs), tvp, tgp, st_t,
                                     tais).numpy()
    np.testing.assert_array_equal(swept, got)


def test_bound_rejection_matches_jax():
    cfg, gp, vp, ais, Xs, gls = _setup(seed=7, bounded=True)
    Xs = Xs * 3.0
    ref = np.asarray(j_evaluate(cfg, "viqr", jnp.asarray(Xs), vp, gp,
                                _jstate(gls, True, -2.9, 2.9), ais))
    tgp, tvp, tais = _to_torch(gp, vp, ais)
    got = tis.evaluate_is_acquisition(
        TGPConfig(D=D, user_noise=1), "viqr", torch.tensor(Xs), tvp, tgp,
        _tstate(gls, True, -2.9, 2.9), tais).numpy()
    assert np.isinf(ref).any() and np.isfinite(ref).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-8, atol=1e-10)


def test_plain_sweep_matches_pallas_kernel_interpret():
    """On the padded inputs of `tests/test_pallas.py:108-124` (Na padded to
    a multiple of 128 with -inf weights), to that test's tolerance, which
    covers ROADMAP Queue 3 j-n."""
    cfg, gp, vp, ais, Xs, gls = _setup()
    state = _jstate(np.ones(D))
    Na = ais.Xa.shape[0]
    pad = -(-Na // 128) * 128 - Na
    Xa = jnp.concatenate([ais.Xa, jnp.zeros((pad, D))])
    lnw = jnp.concatenate([ais.ln_weights, jnp.full((S, pad), -jnp.inf)], 1)
    fs2a = jnp.concatenate([ais.f_s2, jnp.ones((S, pad))], 1)
    invk = jnp.concatenate([ais.invKzk, jnp.zeros((S, gp.n_max, pad))], 2)
    sn2c = j_nearest(cfg, gp, jnp.asarray(Xs), state)
    ref = np.asarray(fused_viqr_acq(cfg, jnp.asarray(Xs), gp, Xa, lnw, fs2a,
                                    invk, sn2c, 1e-4, 1.0, interpret=True))
    tgp, _ = _to_torch(gp, vp)
    padded = tis.ISState(*(torch.tensor(np.asarray(a))
                           for a in (Xa, lnw, invk, fs2a)))
    got = kernels.viqr_acq_reference(
        TGPConfig(D=D, user_noise=1), torch.tensor(Xs), tgp, padded,
        torch.tensor(np.asarray(sn2c)), 1e-4, True).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-8)
    assert int(np.argmin(got)) == int(np.argmin(ref))


def test_mixture_log_density_matches_jax():
    """The proposal density of the port at the reference's own draws."""
    _, gp, vp, _, _, _ = _setup()
    lo, hi = jnp.full(D, -3.1), jnp.full(D, 2.7)
    Xa, lp = j_mixture_draw(jax.random.PRNGKey(5), vp, lo, hi, 26, 24,
                            jnp.float64)
    _, tvp = _to_torch(gp, vp)
    got = tis._mixture_log_prop(tvp, torch.tensor(np.asarray(Xa)),
                                torch.tensor(np.asarray(lo)),
                                torch.tensor(np.asarray(hi)), 26, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(lp), rtol=0,
                               atol=1e-10)


def test_mixture_draw_shapes_and_density():
    _, gp, vp, _, _, _ = _setup()
    _, tvp = _to_torch(gp, vp)
    lo, hi = torch.full((D,), -3.0), torch.full((D,), 3.0)
    gen = torch.Generator().manual_seed(0)
    Xa, lp = tis._mixture_draw(gen, tvp, lo, hi, 26, 24)
    assert Xa.shape == (3 * 26 + 24, D)
    np.testing.assert_array_equal(
        lp.numpy(), tis._mixture_log_prop(tvp, Xa, lo, hi, 26, 24).numpy())
    assert torch.isfinite(lp).all()


def _to_torch_oracle(gp, vp):
    return (gp_from_dict(jax.device_get(gp._asdict())),
            vp_from_dict(jax.device_get(vp._asdict())))


@pytest.mark.parametrize("mh_steps", [0, 3])
def test_viqr_mc_estimator_converges(mh_steps):
    """The port's stochastic IS set reaches the grid oracle of
    `tests/test_active_is.py:165-187` on its bimodal problem (the hard case
    for the un-refreshed estimator), averaged over 4 seeds."""
    cfg, gp, vp, state, X, y, hyps = _oracle_setup(
        np.random.default_rng(42), multimodal=True)
    Xm = np.linspace(-2.5, 2.5, 9)[:, None]
    want = _np_viqr_oracle(hyps, X, y, vp, Xm,
                           np.linspace(-10.0, 10.0, 4001))
    tgp, tvp = _to_torch_oracle(gp, vp)
    tcfg = TGPConfig(D=1, meanfun=0)
    st = tacq.AcqState(
        ymax=torch.tensor(float(y.max())), tol_var=torch.tensor(1e-30),
        lb_eps_orig=torch.full((1,), -np.inf, dtype=torch.float64),
        ub_eps_orig=torch.full((1,), np.inf, dtype=torch.float64),
        regularize=False,
        gp_length_scale=torch.tensor(np.asarray(state.gp_length_scale)))
    accs = []
    for rep in range(4):
        gen = torch.Generator().manual_seed(100 + rep)
        ais = tis.build_is_state_core(gen, tcfg, "viqr", tvp, tgp, 2000,
                                      2000, 2000, mh_steps=mh_steps,
                                      fess_thresh=0.9)
        accs.append(tis.evaluate_is_acquisition(
            tcfg, "viqr", torch.tensor(Xm), tvp, tgp, st, ais).numpy())
    err = np.max(np.abs(np.mean(accs, axis=0) - want))
    assert err < 0.05, (mh_steps, err)


def test_mh_refresh_gates_on_fess():
    """With an adequate proposal (fESS above threshold) the refresh is a
    no-op: the set and its weights equal the un-refreshed ones
    (`tests/test_active_is.py:190-201`)."""
    cfg, gp, vp, state, X, y, hyps = _oracle_setup(np.random.default_rng(42))
    tgp, tvp = _to_torch_oracle(gp, vp)
    tcfg = TGPConfig(D=1, meanfun=0)
    a0 = tis.build_is_state_core(torch.Generator().manual_seed(0), tcfg,
                                 "viqr", tvp, tgp, 400, 400, 400,
                                 mh_steps=3, fess_thresh=1e-9)
    a1 = tis.build_is_state_core(torch.Generator().manual_seed(0), tcfg,
                                 "viqr", tvp, tgp, 400, 400, 400,
                                 mh_steps=0)
    np.testing.assert_array_equal(a0.Xa.numpy(), a1.Xa.numpy())
    np.testing.assert_allclose(a0.ln_weights.numpy(), a1.ln_weights.numpy(),
                               atol=1e-10)


@pytest.mark.parametrize("name", ["viqr", "imiqr"])
def test_is_state_shapes_and_normalised_weights(name):
    cfg, gp, vp, _, _, _ = _setup()
    tgp, tvp = _to_torch(gp, vp)
    ais = tis.build_is_state_core(torch.Generator().manual_seed(1),
                                  TGPConfig(D=D, user_noise=1), name, tvp,
                                  tgp, 100, 100, 100, mh_steps=3)
    Na = 3 * 66 + 100
    assert ais.Xa.shape == (Na, D) and ais.invKzk.shape == (S, 32, Na)
    assert ais.f_s2.shape == (S, Na) and bool((ais.f_s2 >= 0).all())
    np.testing.assert_allclose(torch.logsumexp(ais.ln_weights, 1).numpy(),
                               0.0, atol=1e-12)
    assert all(t.is_contiguous() for t in (ais.Xa, ais.ln_weights,
                                           ais.invKzk, ais.f_s2))


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    cfg, gp, vp, ais, Xs, gls = _setup(M=64)
    tgp, tvp, tais = _to_torch(gp, vp, ais)
    tcfg = TGPConfig(D=D, user_noise=1)
    Xs_t = torch.tensor(Xs)
    sn2c = tacq._nearest_noise(tcfg, tgp, Xs_t, _tstate(gls))
    before = kernels.viqr_acq.launches
    got = kernels.viqr_acq(tcfg, Xs_t, tgp, tais, sn2c, 1e-4)
    ref = kernels.viqr_acq_reference(tcfg, Xs_t, tgp, tais, sn2c, 1e-4)
    assert torch.equal(got, ref)
    assert kernels.viqr_acq.launches == before
    with pytest.raises(ValueError):
        kernels.viqr_acq(tcfg, Xs_t.to("meta"), tgp, tais, sn2c, 1e-4)


@pytest.mark.parametrize("change", [dict(meanfun=6), dict(covfun=3),
                                    dict(intmean=1), dict(outwarp=1)])
def test_wrapper_refuses_configurations_outside_the_kernel(change):
    """ROADMAP Queue 3 b: the kernel reads hyp[:D] as SE-ard log length
    scales, so anything else is refused on every device."""
    cfg, gp, vp, ais, Xs, gls = _setup(M=16)
    tgp, tvp, tais = _to_torch(gp, vp, ais)
    with pytest.raises(NotImplementedError):
        kernels.viqr_acq(TGPConfig(D=D, user_noise=1, **change),
                         torch.tensor(Xs), tgp, tais,
                         torch.ones(16, dtype=torch.float64), 1e-4)


@pytest.mark.parametrize("meanfun", [0, 4, 8])
def test_int_kernel_matches_jax(meanfun):
    """Cov(f(x_m), int q f) per sample, products with the reference's own
    Binv: rtol 1e-8."""
    from test_torch_gp_problems import gp_problem, tcfg_of
    cfg, X, y, _, hyps = gp_problem(21, D=D, meanfun=meanfun)
    gp = gp_from_host(cfg, X, y, None, hyps, n_bucket=32, s_bucket=S)
    _, _, vp, _, Xs, _ = _setup(M=40)
    ref = np.asarray(j_int_kernel(cfg, gp, vp, jnp.asarray(Xs)))
    tgp, tvp = _to_torch(gp, vp)
    got = tis.int_kernel(tcfg_of(cfg), tgp, tvp, torch.tensor(Xs)).numpy()
    assert got.shape == (S, 40)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)


def test_int_kernel_refuses_other_covariances():
    cfg, gp, vp, _, Xs, _ = _setup(M=8)
    tgp, tvp = _to_torch(gp, vp)
    with pytest.raises(ValueError, match="SE-ard"):
        tis.int_kernel(TGPConfig(D=D, covfun=3, user_noise=1), tgp, tvp,
                       torch.tensor(Xs))


@pytest.mark.parametrize("fam", [dict(meanfun=8), dict(meanfun=12),
                                 dict(intmean=1), dict(outwarp=2)],
                         ids=lambda f: "-".join(f"{k}{v}"
                                                for k, v in f.items()))
@pytest.mark.parametrize("name", ["viqr", "imiqr"])
def test_sweep_takes_the_plain_path_outside_the_kernel(fam, name,
                                                       monkeypatch):
    """The dispatch of `vbmc_tpu/active_is.py:322-365`: outside
    `kernel_supports` the sweep is `evaluate_is_acquisition`, equal to the
    reference's at rtol 1e-8 on the reference's own IS state; the kernel's
    wrapper is not called and nothing is added to its launches."""
    from test_torch_gp_problems import gp_problem, tcfg_of
    cfg, X, y, s2, hyps = gp_problem(22, D=D, n=30, user_noise=1, noisy=True,
                                     **fam)
    gp = gp_from_host(cfg, X, y, s2, hyps, n_bucket=32, s_bucket=S)
    _, _, vp, _, Xs, gls = _setup(M=96)
    ais = j_build(jax.random.PRNGKey(4), cfg, name, vp, gp, 40, 24, 40,
                  mh_steps=0)
    ref = np.asarray(j_evaluate(cfg, name, jnp.asarray(Xs), vp, gp,
                                _jstate(gls), ais))
    tgp, tvp, tais = _to_torch(gp, vp, ais)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(tis, "viqr_acq", refuse)
    before = kernels.viqr_acq.launches
    st = _tstate(gls)
    st.ymax = st.ymax.double()
    st.tol_var = st.tol_var.double()
    swept = tis.sweep_is_acquisition(tcfg_of(cfg), name, torch.tensor(Xs),
                                     tvp, tgp, st, tais)
    plain = tis.evaluate_is_acquisition(tcfg_of(cfg), name, torch.tensor(Xs),
                                        tvp, tgp, st, tais)
    assert torch.equal(swept, plain)
    assert kernels.viqr_acq.launches == before
    np.testing.assert_allclose(swept.numpy(), ref, rtol=1e-8, atol=1e-10)
    assert int(np.argmin(swept.numpy())) == int(np.argmin(ref))


def test_sweep_takes_the_wrapper_inside_the_kernel(monkeypatch):
    cfg, gp, vp, ais, Xs, gls = _setup(M=32)
    tgp, tvp, tais = _to_torch(gp, vp, ais)
    calls = []
    real = tis.viqr_acq
    monkeypatch.setattr(tis, "viqr_acq",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tis.sweep_is_acquisition(TGPConfig(D=D, user_noise=1), "viqr",
                             torch.tensor(Xs), tvp, tgp, _tstate(gls), tais)
    assert calls == [1]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    cfg, gp, vp, ais, Xs, gls = _setup(M=1000)
    tgp = gp_from_dict(jax.device_get(gp._asdict()), device="cuda")
    tais = is_state_from_dict(jax.device_get(ais._asdict()), device="cuda")
    tcfg = TGPConfig(D=D, user_noise=1)
    Xs_t = torch.tensor(Xs, device="cuda")
    sn2c = torch.rand(1000, device="cuda", dtype=torch.float64) + 0.1
    before = kernels.viqr_acq.launches
    got = kernels.viqr_acq(tcfg, Xs_t, tgp, tais, sn2c, 1e-4)
    ref = kernels.viqr_acq_reference(tcfg, Xs_t, tgp, tais, sn2c, 1e-4)
    assert kernels.viqr_acq.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-9)
