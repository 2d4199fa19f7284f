"""The port's transforms, variational posterior and function logger against
the JAX reference on the same float64 inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu import transforms as jtr
from vbmc_tpu import vp as jvp
from vbmc_tpu.function_logger import FunctionLogger as JLogger
from vbmc_tpu_torch import transforms as ttr
from vbmc_tpu_torch import vp as tvp
from vbmc_tpu_torch.convert import trinfo_from_dict, vp_from_dict
from vbmc_tpu_torch.function_logger import FunctionLogger as TLogger

torch.set_num_threads(1)

# One dimension per transform type: unbounded, lower, upper, and bounded
# with each of the three bounded maps.
LB = np.array([-np.inf, 0.5, -np.inf, -1.0, -1.0, -1.0])
UB = np.array([np.inf, np.inf, 2.0, 3.0, 3.0, 3.0])
PLB = np.array([-2.0, 1.0, -1.0, -0.5, -0.5, -0.5])
PUB = np.array([2.0, 4.0, 1.5, 2.5, 2.5, 2.5])


def _trinfos(bounded_type, rotate):
    D = LB.size
    jt = jtr.create_trinfo(LB, UB, PLB, PUB, bounded_type=bounded_type)
    if rotate:
        Q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((D, D)))
        sc = np.exp(0.3 * np.random.default_rng(1).standard_normal(D))
        jt = jt._replace(R_mat=jnp.asarray(Q), scale=jnp.asarray(sc))
    return jt, trinfo_from_dict(jax.device_get(jt._asdict()))


def _points(n=64):
    rng = np.random.default_rng(2)
    return np.clip(rng.uniform(PLB - 0.3, PUB + 0.3, (n, LB.size)),
                   np.where(np.isfinite(LB), LB + 1e-3, -np.inf),
                   np.where(np.isfinite(UB), UB - 1e-3, np.inf))


@pytest.mark.parametrize("bounded_type", [3, 12, 13])
@pytest.mark.parametrize("rotate", [False, True])
def test_transforms_match_jax(bounded_type, rotate):
    jt, tt = _trinfos(bounded_type, rotate)
    x = _points()
    y_ref = np.asarray(jtr.direct(jt, jnp.asarray(x)))
    y = ttr.direct(tt, torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ttr.direct_np(tt, x), y_ref, rtol=1e-10,
                               atol=1e-12)
    x_ref = np.asarray(jtr.inverse(jt, jnp.asarray(y_ref)))
    np.testing.assert_allclose(ttr.inverse(tt, torch.tensor(y_ref)).numpy(),
                               x_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ttr.inverse_np(tt, y_ref), x_ref, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(x_ref, x, rtol=1e-8, atol=1e-8)
    lj_ref = np.asarray(jtr.log_abs_det_jacobian(jt, jnp.asarray(y_ref)))
    np.testing.assert_allclose(
        ttr.log_abs_det_jacobian(tt, torch.tensor(y_ref)).numpy(), lj_ref,
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ttr.log_abs_det_jacobian_np(tt, y_ref),
                               lj_ref, rtol=1e-10, atol=1e-12)


def test_create_trinfo_matches_jax():
    jt = jtr.create_trinfo(LB, UB, PLB, PUB)
    tt = ttr.create_trinfo(LB, UB, PLB, PUB, device="cpu")
    for name in ("type", "lb_orig", "ub_orig", "mu", "delta", "R_mat",
                 "scale"):
        np.testing.assert_allclose(tt.host()[name],
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-12, err_msg=name)


def _vps(seed=0, K=5, k_max=8, D=3):
    rng = np.random.default_rng(seed)
    jt = jtr.create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                           [2.0] * D)
    w = rng.random(K) + 0.3
    jv = jvp.make_vp(jt, rng.uniform(-1, 1, (K, D)), 0.3 + 0.2 * rng.random(K),
                     np.exp(0.1 * rng.standard_normal(D)), w=w / w.sum(),
                     k_max=k_max)
    return jv, vp_from_dict(jax.device_get(jv._asdict()))


@pytest.mark.parametrize("df", [0.0, 3.0])
def test_vp_log_pdf_matches_jax(df):
    jv, tv = _vps()
    X = np.random.default_rng(3).uniform(-3, 3, (100, 3))
    ref = np.asarray(jvp.vp_log_pdf_trans(jv, jnp.asarray(X), df=df))
    got = tvp.vp_log_pdf_trans(tv, torch.tensor(X), df=df).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-11)


def test_vp_moments_and_softmax_match_jax():
    jv, tv = _vps(1)
    m_ref, c_ref = jvp.vp_moments(jv, orig_flag=False)
    m, c = tvp.vp_moments(tv, orig_flag=False)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-12)
    eta = np.random.default_rng(4).standard_normal(8)
    np.testing.assert_allclose(
        tvp.masked_softmax(torch.tensor(eta), tv.kmask).numpy(),
        np.asarray(jvp.masked_softmax(jnp.asarray(eta), jv.kmask)),
        rtol=1e-12)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("df", [0.0, 3.0])
def test_vp_rnd_moments(balance, df):
    _, tv = _vps(2)
    gen = torch.Generator().manual_seed(0)
    X = tvp.vp_rnd(tv, gen, 40000, orig_flag=False, balance_flag=balance,
                   df=df).numpy()
    m, c = (a.numpy() for a in tvp.vp_moments(tv, orig_flag=False))
    assert X.shape == (40000, 3)
    np.testing.assert_allclose(X.mean(0), m, atol=0.03)
    if df == 0:
        np.testing.assert_allclose(np.cov(X.T), c, atol=0.03)
    else:  # Student-t with 3 dof: variance inflated by df/(df-2) = 3
        assert np.all(np.diag(np.cov(X.T)) > np.diag(c))


def test_vp_kldiv_of_a_vp_with_itself_is_small():
    _, tv = _vps(3)
    gen = torch.Generator().manual_seed(1)
    kl = tvp.vp_kldiv(tv, tv, n_samples=20000, gen=gen).numpy()
    assert kl.shape == (2,) and np.all(kl >= 0) and np.all(kl < 5e-3)


def test_function_logger_matches_jax():
    jt = jtr.create_trinfo(np.zeros(2), np.full(2, 10.0), np.full(2, 0.5),
                           np.full(2, 3.0))
    tt = trinfo_from_dict(jax.device_get(jt._asdict()))

    def f(x):
        return -0.5 * float(np.sum(x ** 2))

    jl, tl = JLogger(f, 2, jt), TLogger(f, 2, tt)
    pts = np.random.default_rng(5).uniform(-2, 2, (6, 2))
    for x in list(pts) + [pts[0]]:             # last one is a duplicate
        a, b = jl.evaluate(x), tl.evaluate(x)
        np.testing.assert_allclose(b[0], a[0], rtol=1e-12)
        assert a[1] == b[1]
    for name in ("X", "y", "X_orig", "y_orig", "nevals"):
        np.testing.assert_allclose(getattr(tl, name)[:tl.Xn],
                                   getattr(jl, name)[:jl.Xn], rtol=1e-12)
    assert (tl.func_count, tl.n_train, tl.ymax) == (jl.func_count,
                                                    jl.n_train, jl.ymax)
