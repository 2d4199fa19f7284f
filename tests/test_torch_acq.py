"""The port's prospective acquisition against the JAX reference: the plain
sweep against `evaluate_acquisition` and against the Pallas kernel
`fused_prospective_acq` in interpret mode, at the shapes of
`tests/test_pallas.py`. The CUDA kernel itself runs only on the card (the
`cuda` case skips here; `chip_smoke.py` carries it)."""

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
    with pytest.raises(NotImplementedError):
        tacq.check_acq("eig")


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
