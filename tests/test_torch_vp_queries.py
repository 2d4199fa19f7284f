"""The port's posterior queries (`vp_pdf`, `vp_mode`, `vp_mtv`, `vp_power`,
`vp_train2real`, `is_valid_vp`), its copy of the KDEs and its Student-t
draws, against the JAX reference on the same float64 inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu import transforms as jtr
from vbmc_tpu import vp as jvp
from vbmc_tpu.utils import kde as jkde
from vbmc_tpu_torch import vp as tvp
from vbmc_tpu_torch.convert import vp_from_dict
from vbmc_tpu_torch.utils import kde as tkde

torch.set_num_threads(1)

# unbounded, lower-bounded and logit-bounded dimensions
LB = np.array([-np.inf, 0.0, -1.0])
UB = np.array([np.inf, np.inf, 3.0])
PLB = np.array([-2.0, 0.5, -0.5])
PUB = np.array([2.0, 4.0, 2.5])


def _vps(K=5, k_max=8, seed=0, rotate=False):
    """The same VP in both packages: K active components in k_max slots."""
    rng = np.random.default_rng(seed)
    D = LB.size
    jt = jtr.create_trinfo(LB, UB, PLB, PUB)
    if rotate:
        Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
        jt = jt._replace(R_mat=jnp.asarray(Q),
                         scale=jnp.asarray(np.exp(0.2 * rng.standard_normal(D))))
    w = rng.random(K) + 0.2
    lam = np.exp(0.2 * rng.standard_normal(D))
    lam = lam * np.sqrt(D / np.sum(lam ** 2))
    jv = jvp.make_vp(jt, rng.uniform(-1, 1, (K, D)), 0.3 + 0.4 * rng.random(K),
                     lam, w=w / w.sum(), k_max=k_max)
    return jv, vp_from_dict(jax.device_get(jv._asdict()))


def _points(n=50, seed=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.uniform(PLB - 0.3, PUB + 0.3, (n, LB.size)),
                   np.where(np.isfinite(LB), LB + 1e-3, -np.inf),
                   np.where(np.isfinite(UB), UB - 1e-3, np.inf))


@pytest.mark.parametrize("orig_flag", [True, False])
@pytest.mark.parametrize("log_flag", [True, False])
@pytest.mark.parametrize("df", [0.0, 3.0])
@pytest.mark.parametrize("rotate", [False, True])
def test_vp_pdf_matches_reference(orig_flag, log_flag, df, rotate):
    jv, tv = _vps(rotate=rotate)
    X = _points()
    if not orig_flag:
        X = np.asarray(jtr.direct(jv.trinfo, jnp.asarray(X)))
    ref = np.asarray(jvp.vp_pdf(jv, jnp.asarray(X), orig_flag=orig_flag,
                                log_flag=log_flag, df=df))
    got = tvp.vp_pdf(tv, X, orig_flag=orig_flag, log_flag=log_flag,
                     df=df).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_vp_power_and_train2real_match_reference(K):
    jv, tv = _vps(K=K)
    jp, jlnz = jvp.vp_power(jv, n=2, return_lnz=True)
    tp, tlnz = tvp.vp_power(tv, n=2, return_lnz=True)
    np.testing.assert_allclose(tlnz, jlnz, rtol=1e-12)
    for f in ("w", "mu", "sigma", "lam"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-12,
                                   atol=1e-15)
    np.testing.assert_array_equal(tp.kmask.numpy(), np.asarray(jp.kmask))
    X = _points()
    np.testing.assert_allclose(
        tvp.vp_pdf(tp, X, log_flag=True).numpy(),
        np.asarray(jvp.vp_pdf(jp, jnp.asarray(X), log_flag=True)), rtol=1e-12)
    jr, je, jsd = jvp.vp_train2real(jv, 2, -1.25, 0.1)
    tr, te, tsd = tvp.vp_train2real(tv, 2, -1.25, 0.1)
    np.testing.assert_allclose([te, tsd], [je, jsd], rtol=1e-12)
    np.testing.assert_allclose(tr.mu.numpy(), np.asarray(jr.mu), rtol=1e-12)
    assert tvp.vp_train2real(tv, 1, -1.25, 0.1) == (tv, -1.25, 0.1)
    assert tvp.vp_power(tv, n=1) is tv
    with pytest.raises(NotImplementedError):
        tvp.vp_power(tv, n=3)


def test_vp_power_of_one_component_is_its_square():
    """The square of one Gaussian is a Gaussian with half the variance and
    the normaliser of the overlap integral."""
    _, tv = _vps(K=1, k_max=1)
    p, lnz = tvp.vp_power(tv, return_lnz=True)
    np.testing.assert_allclose(p.sigma.numpy(), tv.sigma.numpy() / np.sqrt(2),
                               rtol=1e-14)
    D = tv.D
    s2 = float(tv.sigma[0]) ** 2
    expect = (-0.5 * D * np.log(2 * np.pi) - 0.5 * D * np.log(2 * s2)
              - np.sum(np.log(tv.lam.numpy())))
    np.testing.assert_allclose(lnz, expect, rtol=1e-14)


def test_is_valid_vp():
    jv, tv = _vps()
    assert tvp.is_valid_vp(tv) and jvp.is_valid_vp(jv)
    assert not tvp.is_valid_vp(jv) and not jvp.is_valid_vp(tv)
    assert not tvp.is_valid_vp(np.zeros(3)) and not tvp.is_valid_vp(None)


@pytest.mark.parametrize("orig_flag", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_vp_mode_matches_reference(orig_flag, seed):
    jv, tv = _vps(seed=seed)
    ref = np.asarray(jvp.vp_mode(jv, orig_flag=orig_flag))
    got = tvp.vp_mode(tv, orig_flag=orig_flag).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1000, 20000])
@pytest.mark.parametrize("bounds", [None, (-3.0, 5.0)])
def test_kde1d_equals_reference(n, bounds):
    data = np.random.default_rng(n).gamma(2.0, 1.0, n)
    lo, hi = bounds if bounds else (None, None)
    f_ref, g_ref = jkde.kde1d(data, 2 ** 12, lo, hi)
    f, g = tkde.kde1d(data, 2 ** 12, lo, hi)
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(g, g_ref)


def test_kde2d_equals_reference():
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(3000), rng.gamma(2.0, 1.0, 3000)
    ref = jkde.kde2d(x, y, n=64)
    got = tkde.kde2d(x, y, n=64)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_vp_mtv_matches_reference_within_mc_error():
    """Marginal total variation between two different VPs: both packages
    estimate the same per-dimension numbers; their draws differ, so they
    agree to the estimator's Monte-Carlo error (the spread over seeds),
    and a VP against itself is near 0 in both."""
    jv1, tv1 = _vps(seed=0)
    jv2, tv2 = _vps(seed=1)
    ref = np.stack([np.asarray(jvp.vp_mtv(jv1, jv2, n_samples=20000,
                                          key=jax.random.PRNGKey(s)))
                    for s in range(3)])
    got = np.stack([tvp.vp_mtv(tv1, tv2, n_samples=20000,
                               gen=torch.Generator().manual_seed(s)).numpy()
                    for s in range(3)])
    err = 4 * np.maximum(ref.std(0), got.std(0)) / np.sqrt(3) + 0.02
    assert np.all(np.abs(got.mean(0) - ref.mean(0)) < err), (got, ref)
    assert np.all(got > 0.05)
    same = tvp.vp_mtv(tv1, tv1, n_samples=20000).numpy()
    same_ref = np.asarray(jvp.vp_mtv(jv1, jv1, n_samples=20000))
    assert np.all(same < 0.15) and np.all(same_ref < 0.15)


@pytest.mark.parametrize("df", [2.5, 7.0, 0.7])
def test_vp_rnd_student_t_any_df_by_moments(df):
    """Student-t draws with a df that is no integer (the reference takes any
    df > 0 through a gamma draw, `vbmc_tpu/vp.py:153-156`): one component at
    0 with scale 1, in transformed space. The variance df / (df - 2) for
    df > 2, the mean for df > 1; every df by the CDF at 1 (the median of
    |t| and its quartiles against scipy)."""
    from scipy import stats
    from vbmc_tpu_torch.transforms import create_trinfo
    D, N = 2, 200_000
    ti = create_trinfo([-np.inf] * D, [np.inf] * D, [-1.0] * D, [1.0] * D)
    vp = tvp.make_vp(ti, np.zeros((1, D)), 1.0, np.ones(D))
    X = tvp.vp_rnd(vp, torch.Generator().manual_seed(0), N, orig_flag=False,
                   df=df).numpy()
    assert np.all(np.isfinite(X))
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        emp = np.mean(X[:, 0] <= stats.t.ppf(q, df))
        assert abs(emp - q) < 4 * np.sqrt(q * (1 - q) / N), (q, emp)
    if df > 2:
        var = df / (df - 2)
        # the variance estimate's SD from the fourth moment; finite for
        # df > 4, a loose bound below that
        tol = 5 * np.sqrt((3 * (df - 2) / (df - 4) - 1) / N) * var \
            if df > 4 else 0.15 * var
        assert abs(X[:, 0].var() - var) < tol
    if df > 1:
        assert abs(X.mean()) < 0.05
