"""The port's acquisitions against the JAX reference: the plain
prospective sweep against `evaluate_acquisition` and against the Pallas
kernel `fused_prospective_acq` in interpret mode, at the shapes of
`tests/test_pallas.py`; every other acquisition, with regularisation on
and off and with bandwidth smoothing; and the sweep's choice between the
kernel's wrapper and the plain evaluation. The CUDA kernel itself runs only
on the card (the `cuda` case skips here; `chip_smoke.py` carries it)."""

import ast
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp.gp import gp_from_host
from vbmc_tpu.vp import make_vp
from vbmc_tpu.transforms import create_trinfo
from vbmc_tpu.acquisitions import evaluate_acquisition, AcqState
from vbmc_tpu.pallas_kernels import fused_prospective_acq
from vbmc_tpu_torch import acquisitions as tacq
from vbmc_tpu_torch import kernels
from vbmc_tpu_torch.convert import gp_from_dict, vp_from_dict
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig

from test_torch_gp_problems import gp_problem, tcfg_of

torch.set_num_threads(1)


def _setup(seed=42, D=3, n=40, S=4, K=6, M=512, bounded=False):
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8) + 0.05 * rng.standard_normal((S, D))
    hyps[:, D] = 0.1 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.05)
    hyps[:, cfg.ncov + cfg.nnoise] = 0.3
    hyps[:, cfg.ncov + cfg.nnoise + 1 + D:] = np.log(1.2)
    gp = gp_from_host(cfg, X, y, None, hyps, n_bucket=64, s_bucket=S)
    if bounded:
        trinfo = create_trinfo([-3.0] * D, [3.0] * D, [-2.0] * D, [2.0] * D)
    else:
        trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                               [2.0] * D)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)),
                 0.4 + 0.2 * rng.random(K), np.ones(D), w=w / w.sum(),
                 k_max=8)
    Xs = rng.uniform(-2.5, 2.5, (M, D))
    return cfg, gp, vp, Xs


def _jstate(D, S, regularize=True, lb=-np.inf, ub=np.inf):
    return AcqState(ymax=jnp.asarray(0.7), tol_var=jnp.asarray(1e-4),
                    lb_eps_orig=jnp.full((D,), lb),
                    ub_eps_orig=jnp.full((D,), ub),
                    gp_length_scale=jnp.ones(D), var_log_joint=jnp.ones(S),
                    regularize=jnp.asarray(regularize))


def _tstate(D, regularize=True, lb=-np.inf, ub=np.inf):
    return tacq.AcqState(ymax=torch.tensor(0.7), tol_var=torch.tensor(1e-4),
                         lb_eps_orig=torch.full((D,), lb, dtype=torch.float64),
                         ub_eps_orig=torch.full((D,), ub, dtype=torch.float64),
                         regularize=regularize)


def _to_torch(gp, vp):
    return (gp_from_dict(jax.device_get(gp._asdict())),
            vp_from_dict(jax.device_get(vp._asdict())))


@pytest.mark.parametrize("M", [512, 500])
@pytest.mark.parametrize("regularize", [True, False])
def test_plain_sweep_matches_evaluate_acquisition(M, regularize):
    cfg, gp, vp, Xs = _setup(M=M)
    ref = np.asarray(evaluate_acquisition(
        cfg, "prospective", jnp.asarray(Xs), vp, gp,
        _jstate(3, 4, regularize)))
    tgp, tvp = _to_torch(gp, vp)
    got = tacq.sweep_acquisition(TGPConfig(D=3), "prospective",
                                 torch.tensor(Xs), tvp, tgp,
                                 _tstate(3, regularize)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    assert int(np.argmin(got)) == int(np.argmin(ref))


def test_plain_sweep_matches_pallas_kernel_interpret():
    cfg, gp, vp, Xs = _setup()
    ref = np.asarray(fused_prospective_acq(cfg, jnp.asarray(Xs), gp, vp,
                                           0.7, 1e-4, interpret=True))
    tgp, tvp = _to_torch(gp, vp)
    got = kernels.prospective_acq_reference(TGPConfig(D=3), torch.tensor(Xs),
                                            tgp, tvp, 0.7, 1e-4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    assert int(np.argmin(got)) == int(np.argmin(ref))


def test_bound_rejection_matches_reference():
    cfg, gp, vp, Xs = _setup(seed=7, bounded=True)
    lb, ub = -2.9, 2.9
    # Candidates in transformed space reach past the epsilon box.
    Xs = Xs * 3.0
    ref = np.asarray(evaluate_acquisition(
        cfg, "prospective", jnp.asarray(Xs), vp, gp,
        _jstate(3, 4, True, lb, ub)))
    tgp, tvp = _to_torch(gp, vp)
    st = _tstate(3, True, lb, ub)
    got = tacq.evaluate_acquisition(TGPConfig(D=3), "prospective",
                                    torch.tensor(Xs), tvp, tgp, st).numpy()
    assert np.isinf(ref).any() and np.isfinite(ref).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-12)
    swept = tacq.sweep_acquisition(TGPConfig(D=3), "prospective",
                                   torch.tensor(Xs), tvp, tgp, st).numpy()
    np.testing.assert_array_equal(swept, got)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    cfg, gp, vp, Xs = _setup(M=64)
    tgp, tvp = _to_torch(gp, vp)
    before = kernels.prospective_acq.launches
    got = kernels.prospective_acq(TGPConfig(D=3), torch.tensor(Xs), tgp, tvp,
                                  0.7, 1e-4)
    ref = kernels.prospective_acq_reference(TGPConfig(D=3), torch.tensor(Xs),
                                            tgp, tvp, 0.7, 1e-4)
    assert torch.equal(got, ref)
    assert kernels.prospective_acq.launches == before
    with pytest.raises(ValueError):
        kernels.prospective_acq(TGPConfig(D=3), torch.tensor(Xs).to("meta"),
                                tgp, tvp, 0.7, 1e-4)


@pytest.mark.parametrize("change", [dict(meanfun=6), dict(covfun=3),
                                    dict(intmean=1), dict(outwarp=1)])
def test_wrapper_refuses_configurations_outside_the_kernel(change):
    cfg, gp, vp, Xs = _setup(M=16)
    tgp, tvp = _to_torch(gp, vp)
    with pytest.raises(NotImplementedError):
        kernels.prospective_acq(TGPConfig(D=3, **change), torch.tensor(Xs),
                                tgp, tvp, 0.7, 1e-4)


def test_unported_acquisition_raises():
    """Every acquisition of the reference is ported; an unknown name is a
    ValueError, as in `vbmc_tpu/main.py:409-416`."""
    assert set(tacq.ACQ_INFO) == set(__import__(
        "vbmc_tpu.acquisitions", fromlist=["ACQ_INFO"]).ACQ_INFO)
    for name in tacq.ACQ_INFO:
        tacq.check_acq(name)
    with pytest.raises(ValueError, match="unknown acquisition"):
        tacq.check_acq("thompson")
    cfg, gp, vp, Xs = _setup(M=8)
    tgp, tvp = _to_torch(gp, vp)
    with pytest.raises(ValueError, match="unknown acquisition"):
        tacq.evaluate_acquisition(TGPConfig(D=3), "thompson",
                                  torch.tensor(Xs), tvp, tgp, _tstate(3))
    with pytest.raises(ValueError, match="importance-sampling"):
        tacq.evaluate_acquisition(TGPConfig(D=3), "viqr", torch.tensor(Xs),
                                  tvp, tgp, _tstate(3))


def test_acq_info_matches_reference():
    from vbmc_tpu.acquisitions import ACQ_INFO
    assert tacq.ACQ_INFO == ACQ_INFO


def _family_setup(seed, M=256, K=5, **fam):
    """A GP of any family with a VP, candidates and both packages' state,
    the variance threshold set where it engages on part of the candidates."""
    cfg, X, y, s2, hyps = gp_problem(seed, n=30, **fam)
    D, S = cfg.D, hyps.shape[0]
    rng = np.random.default_rng(seed + 100)
    gp = gp_from_host(cfg, X, y, s2, hyps, n_bucket=32, s_bucket=S)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D, [2.0] * D)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)),
                 0.4 + 0.2 * rng.random(K), np.exp(0.1 * rng.standard_normal(D)),
                 w=w / w.sum(), k_max=8)
    Xs = rng.uniform(-2.5, 2.5, (M, D))
    gls = rng.uniform(0.5, 1.5, D)
    vlj = 0.5 + rng.random(S)
    delta = 0.1 + 0.2 * rng.random(D)

    def states(regularize, tol_var):
        js = AcqState(ymax=jnp.asarray(0.7), tol_var=jnp.asarray(tol_var),
                      lb_eps_orig=jnp.full((D,), -np.inf),
                      ub_eps_orig=jnp.full((D,), np.inf),
                      gp_length_scale=jnp.asarray(gls),
                      var_log_joint=jnp.asarray(vlj),
                      regularize=jnp.asarray(regularize),
                      delta=jnp.asarray(delta))
        ts = tacq.AcqState(
            ymax=torch.tensor(0.7, dtype=torch.float64),
            tol_var=torch.tensor(tol_var, dtype=torch.float64),
            lb_eps_orig=torch.full((D,), -np.inf, dtype=torch.float64),
            ub_eps_orig=torch.full((D,), np.inf, dtype=torch.float64),
            regularize=regularize, gp_length_scale=torch.tensor(gls),
            var_log_joint=torch.tensor(vlj), delta=torch.tensor(delta))
        return js, ts

    return cfg, gp, vp, Xs, states


NAMES = ["prospective", "prospective_sn2", "prospective_log", "us", "eig"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("regularize", [True, False])
@pytest.mark.parametrize("smooth", [False, True])
def test_every_acquisition_matches_jax(name, regularize, smooth):
    """Values at rtol 1e-8 (the tolerance of the VIQR evaluation against
    JAX) and the same argmin, on a noisy GP so that the nearest-noise terms
    are not constant; the variance threshold is the median predictive
    variance, so regularisation touches about half the candidates."""
    cfg, gp, vp, Xs, states = _family_setup(11, user_noise=1, noisy=True)
    js, ts = states(regularize, 0.05)
    ref = np.asarray(evaluate_acquisition(cfg, name, jnp.asarray(Xs), vp, gp,
                                          js, smooth=smooth))
    tgp, tvp = _to_torch(gp, vp)
    got = tacq.evaluate_acquisition(tcfg_of(cfg), name, torch.tensor(Xs), tvp,
                                    tgp, ts, smooth=smooth).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)
    assert int(np.argmin(got)) == int(np.argmin(ref))
    if regularize:   # the threshold did engage
        js0, _ = states(False, 0.05)
        ref0 = np.asarray(evaluate_acquisition(
            cfg, name, jnp.asarray(Xs), vp, gp, js0, smooth=smooth))
        assert (ref0 != ref).any()


@pytest.mark.parametrize("fam", [dict(meanfun=8), dict(meanfun=12),
                                 dict(intmean=2), dict(outwarp=2),
                                 dict(meanfun=22)],
                         ids=lambda f: "-".join(f"{k}{v}"
                                                for k, v in f.items()))
@pytest.mark.parametrize("name", ["prospective", "prospective_log", "eig"])
def test_acquisitions_on_other_gp_families_match_jax(fam, name):
    """The acquisitions over GPs that the kernels do not compute (rtol
    1e-8, same argmin)."""
    cfg, gp, vp, Xs, states = _family_setup(12, M=128, **fam)
    js, ts = states(True, 1e-3)
    ref = np.asarray(evaluate_acquisition(cfg, name, jnp.asarray(Xs), vp, gp,
                                          js))
    tgp, tvp = _to_torch(gp, vp)
    got = tacq.evaluate_acquisition(tcfg_of(cfg), name, torch.tensor(Xs), tvp,
                                    tgp, ts).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)
    assert int(np.argmin(got)) == int(np.argmin(ref))


@pytest.mark.parametrize("case", [
    dict(fam=dict(meanfun=8), name="prospective", smooth=False),
    dict(fam=dict(outwarp=1), name="prospective", smooth=False),
    dict(fam=dict(intmean=1), name="prospective", smooth=False),
    dict(fam=dict(), name="prospective", smooth=True),
    dict(fam=dict(), name="prospective_log", smooth=False),
    dict(fam=dict(), name="us", smooth=False),
    dict(fam=dict(user_noise=1, noisy=True), name="prospective_sn2",
         smooth=False),
    dict(fam=dict(), name="eig", smooth=False),
], ids=lambda c: f"{c['name']}-{c['fam']}-{c['smooth']}")
def test_sweep_takes_the_plain_path_outside_the_kernel(case, monkeypatch):
    """The dispatch of `vbmc_tpu/acquisitions.py:160-193`: outside
    `kernel_supports`, for a name other than "prospective", or with
    smoothing, the sweep is `evaluate_acquisition`; the kernel's wrapper is
    not called, and nothing is added to its launches."""
    cfg, gp, vp, Xs, states = _family_setup(13, M=64, **case["fam"])
    _, ts = states(True, 1e-3)
    tgp, tvp = _to_torch(gp, vp)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(tacq, "prospective_acq", refuse)
    before = kernels.prospective_acq.launches
    swept = tacq.sweep_acquisition(tcfg_of(cfg), case["name"],
                                   torch.tensor(Xs), tvp, tgp, ts,
                                   smooth=case["smooth"])
    plain = tacq.evaluate_acquisition(tcfg_of(cfg), case["name"],
                                      torch.tensor(Xs), tvp, tgp, ts,
                                      smooth=case["smooth"])
    assert torch.equal(swept, plain)
    assert kernels.prospective_acq.launches == before


def test_sweep_takes_the_wrapper_inside_the_kernel(monkeypatch):
    cfg, gp, vp, Xs = _setup(M=32)
    tgp, tvp = _to_torch(gp, vp)
    calls = []
    real = tacq.prospective_acq
    monkeypatch.setattr(tacq, "prospective_acq",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tacq.sweep_acquisition(TGPConfig(D=3), "prospective", torch.tensor(Xs),
                           tvp, tgp, _tstate(3))
    assert calls == [1]


def test_no_try_surrounds_a_launch():
    """A failed build or launch raises: the modules that choose and launch
    the kernels hold no `try` at all."""
    from vbmc_tpu_torch import active_is, active_sample
    for mod in (kernels, tacq, active_is, active_sample):
        tree = ast.parse(inspect.getsource(mod))
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, (mod.__name__, tries)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    cfg, gp, vp, Xs = _setup(M=1000)
    tgp = gp_from_dict(jax.device_get(gp._asdict()), device="cuda")
    tvp = vp_from_dict(jax.device_get(vp._asdict()), device="cuda")
    Xs_t = torch.tensor(Xs, device="cuda")
    before = kernels.prospective_acq.launches
    got = kernels.prospective_acq(TGPConfig(D=3), Xs_t, tgp, tvp, 0.7, 1e-4)
    ref = kernels.prospective_acq_reference(TGPConfig(D=3), Xs_t, tgp, tvp,
                                            0.7, 1e-4)
    assert kernels.prospective_acq.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-12)
