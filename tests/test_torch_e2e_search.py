"""Whole runs of the port's `vbmc` on CPU tensors through the host-side
search path: the noise-corrected acquisition, integer variables, and a
starting cache larger than the initial design with ``search_cache_frac``
(cf. `tests/test_active_features.py:105,130,161`), at 20 to 25 evaluations,
held to the gate of `test_torch_e2e_families.py` where the target has a
known normaliser. Repeated observations run in `test_torch_e2e_repeat.py`."""

import numpy as np
import torch

from vbmc_tpu_torch.transforms import direct_np

from test_torch_e2e_families import _gate, _run

torch.set_num_threads(1)


def _noisy_halfnormal(seed, sigma):
    sd = np.array([1.0, 0.6])
    noise = np.random.default_rng(1000 + seed)

    def fun(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + sigma * noise.standard_normal()), sigma

    box = dict(x0=np.array([0.5, 0.5]), lb=np.zeros(2), ub=np.full(2, 10.0),
               plb=np.full(2, 0.05), pub=np.full(2, 3.0))
    return fun, box, float(np.log(0.25)), sd * np.sqrt(2 / np.pi)


def test_noisy_prospective_sn2():
    fun, box, lnz, mean_true = _noisy_halfnormal(2, 0.3)
    res = _run(fun, evals=20, seed=2, K=20, specify_target_noise=True,
               search_acq_fcn=("prospective_sn2",), **box)
    assert np.all(res.logger.nevals[:res.logger.Xn] <= 1)
    _gate(res, lnz, mean_true)


def test_integer_vars_round_through_transform():
    """`tests/test_active_features.py:105`: every point acquired after the
    initial design is integral in dimension 0, in original space."""
    evals = []

    def fun(x):
        evals.append(np.array(x, float))
        return float(-0.5 * np.sum(((x - np.array([3.0, 0.0])) / 2.0) ** 2))

    res = _run(fun, evals=20, seed=1, K=4, integer_vars=(0,),
               x0=np.array([3.0, 0.2]), lb=np.array([0.0, -10.0]),
               ub=np.array([10.0, 10.0]), plb=np.array([1.0, -3.0]),
               pub=np.array([6.0, 3.0]))
    X = np.stack(evals)
    frac = np.abs(X[10:, 0] - np.round(X[10:, 0]))
    assert np.all(frac < 1e-6)
    assert np.any(np.abs(X[:, 1] - np.round(X[:, 1])) > 1e-3)
    assert res.func_count >= 20 and np.isfinite(res.elbo)


def test_oversized_cache_feeds_the_search(monkeypatch):
    """Forty starting points against ``fun_eval_start`` = 10: k-means keeps
    ten for the initial design, and with ``search_cache_frac`` the other
    thirty reach every search set, in the transform of the day."""
    from vbmc_tpu_torch import active_sample as tas

    x0 = np.random.default_rng(0).uniform(-2, 2, (40, 2))
    seen = []
    gsp = tas.get_search_points

    def spy(gen, n, vp, logger, sb, options, search_cache=None):
        Xs = gsp(gen, n, vp, logger, sb, options, search_cache=search_cache)
        seen.append((search_cache, direct_np(logger.trinfo, x0), Xs,
                     sb.lb.copy(), sb.ub.copy()))
        return Xs

    monkeypatch.setattr(tas, "get_search_points", spy)
    res = _run(evals=25, seed=4, x0=x0, search_cache_frac=0.1)
    assert res.func_count >= 25 and len(seen) == res.func_count - 10
    X0 = res.logger.X_orig[:10]
    assert all(np.any(np.all(np.abs(x0 - x) < 1e-9, axis=1)) for x in X0)
    for cache, x0_t, Xs, lb, ub in seen:
        assert cache.shape == (30, 2)
        # each cached point is one of the starting points, and the search
        # set begins with the cache
        d = np.abs(cache[:, None, :] - x0_t[None, :, :]).max(-1).min(1)
        assert np.all(d < 1e-8)
        np.testing.assert_allclose(Xs[:30].numpy(), np.clip(cache, lb, ub),
                                   atol=1e-12)
    _gate(res, 0.0, np.zeros(2))
