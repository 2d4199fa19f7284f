"""The port's samplers and optimisers: slice and ensemble sampling judged
by the moments of a Gaussian (as `tests/test_ensemble_hyp.py` does), the
trip-based slice sampler against a plain per-chain loop on the same
uniforms, the GP's log posterior without gradients against the one with
them,
CMA-ES on quadratics (against itself run by hand and against the JAX
reference), the CPU path of its eigensolver wrapper, and the batched L-BFGS
reaching the minimum the JAX reference reaches."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp import GPConfig
from vbmc_tpu.gp import core as jcore
from vbmc_tpu.gp.fit import assemble_hyp_prior as j_prior, \
    TrainOptions as JTrainOptions
from vbmc_tpu.optim import minimize_lbfgs_bounded as j_lbfgs
from vbmc_tpu.utils.math import pad_to
from vbmc_tpu_torch.convert import hyp_prior_from_dict
from vbmc_tpu_torch.gp import core as tcore
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, train_gp, hyp_sampler_for
from vbmc_tpu_torch.optim import minimize_lbfgs_bounded, fminadam, \
    value_and_grad
from vbmc_tpu_torch.kernels import sym_eig
from vbmc_tpu_torch.samplers.cmaes import CMAES, cmaes_minimize
from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_final
from vbmc_tpu_torch.samplers import slice as slice_mod
from vbmc_tpu_torch.samplers.slice import SliceChains, slice_sample_chains

torch.set_num_threads(1)

COV = np.array([[1.0, 0.6], [0.6, 0.8]])
PREC = torch.tensor(np.linalg.inv(COV))


def _logp(x):
    return -0.5 * torch.einsum("bi,ij,bj->b", x, PREC, x)


def test_slice_chains_sample_gaussian():
    gen = torch.Generator().manual_seed(0)
    x0 = 0.1 * torch.randn((8, 2), generator=gen, dtype=torch.float64)
    lb = torch.full((2,), -10.0, dtype=torch.float64)
    samples, logps = slice_sample_chains(gen, _logp, x0,
                                         torch.full((2,), 1.0,
                                                    dtype=torch.float64),
                                         lb, -lb, n_keep=150, burn=20, thin=1,
                                         n_keep_max=150)
    pooled = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(pooled.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(pooled.T), COV, atol=0.22)
    np.testing.assert_allclose(logps.reshape(-1).numpy(),
                               _logp(samples.reshape(-1, 2)).numpy(),
                               rtol=1e-12)


def test_slice_chains_respect_bounds():
    gen = torch.Generator().manual_seed(1)
    lb = torch.tensor([0.0, -1.0], dtype=torch.float64)
    ub = torch.tensor([0.5, 1.0], dtype=torch.float64)
    x0 = torch.tensor([[0.25, 0.0]] * 4, dtype=torch.float64)
    samples, _ = slice_sample_chains(gen, _logp, x0,
                                     torch.ones(2, dtype=torch.float64), lb,
                                     ub, n_keep=20, burn=5, thin=1,
                                     n_keep_max=24)
    kept = samples[:, :20].reshape(-1, 2)
    assert bool(((kept >= lb) & (kept <= ub)).all())
    assert bool((samples[:, 20:] == 0).all())


def _quad2(xs):
    """The correlated Gaussian of `_logp`, elementwise, so that a row's
    value does not depend on the batch around it."""
    a, b, c = (float(PREC[0, 0]), float(PREC[0, 1]), float(PREC[1, 1]))
    x, y = xs[:, 0], xs[:, 1]
    return -0.5 * (a * x * x + 2.0 * b * x * y + c * y * y)


def _per_chain_slice(logp, x0s, widths, lb, ub, n_sweeps, log_v, r, u):
    """The slice sampler's rules, one chain and one step at a time, on the
    uniforms the trip-based sampler drew: each chain's states after every
    sweep (C, n_sweeps, D), and its stepping-out and shrinking steps at
    every update (2, C, n_sweeps * D)."""
    C, D = x0s.shape
    states = torch.zeros((C, n_sweeps, D), dtype=x0s.dtype)
    steps = torch.zeros((2, C, n_sweeps * D), dtype=torch.long)
    for c in range(C):
        x = x0s[c].clone()
        lp = logp(x[None])[0]
        for k in range(n_sweeps * D):
            d = k % D

            def at(v):
                z = x.clone()
                z[d] = v
                return logp(z[None])[0]

            xd, w = x[d].clone(), widths[d]
            log_u = lp + log_v[k, c]
            left = torch.maximum(xd - r[k, c] * w, lb[d])
            right = torch.minimum(xd + (1.0 - r[k, c]) * w, ub[d])
            go_l = go_r = True
            n = 0
            while (go_l or go_r) and n < 16:
                lp_l, lp_r = at(left), at(right)
                go_l = go_l and bool(lp_l > log_u) and bool(left > lb[d])
                go_r = go_r and bool(lp_r > log_u) and bool(right < ub[d])
                if go_l:
                    left = torch.maximum(left - w, lb[d])
                if go_r:
                    right = torch.minimum(right + w, ub[d])
                n += 1
            steps[0, c, k] = n
            for j in range(64):
                prop = left + (right - left) * u[k, j, c]
                lp_p = at(prop)
                steps[1, c, k] = j + 1
                if bool(lp_p > log_u):
                    x[d], lp = prop, lp_p
                    break
                if bool(prop < xd):
                    left = prop
                else:
                    right = prop
            if d == D - 1:
                states[c, k // D] = x
    return states, steps


def _spike_at(x0s):
    def logp(xs):
        hit = (xs[:, None, :] == x0s[None]).all(-1).any(-1)
        return torch.where(hit, 0.0, -torch.inf).to(xs.dtype)
    return logp


_F64 = dict(dtype=torch.float64)
SLICE_CASES = {
    # a Gaussian in a wide box
    "gaussian": (_quad2, torch.tensor([[0.3, -0.2], [1.5, 0.4], [-2.0, 1.0],
                                       [0.0, 0.0]], **_F64),
                 torch.ones(2, **_F64), torch.full((2,), -10.0, **_F64),
                 torch.full((2,), 10.0, **_F64), 6),
    # flat: every chain steps out to its cap of 16 on both sides
    "stepout_cap": (lambda xs: torch.zeros(xs.shape[0], **_F64),
                    torch.tensor([[0.0, 0.0], [3.0, -1.0], [-2.0, 5.0]],
                                 **_F64),
                    torch.full((2,), 0.01, **_F64),
                    torch.full((2,), -1e3, **_F64),
                    torch.full((2,), 1e3, **_F64), 2),
    # all mass on the starting points, brackets too wide to close in on
    # them: 64 shrinking steps miss and the chains stay put
    "shrink_cap": (None, torch.tensor([[0.1, 0.2], [-0.7, 1.3]], **_F64),
                   torch.full((2,), 1e12, **_F64),
                   torch.full((2,), -1e15, **_F64),
                   torch.full((2,), 1e15, **_F64), 2),
    # rising towards a hard bound, one chain starting on it
    "hard_bound": (lambda xs: -(xs[:, 0] + 2.0 * xs[:, 1]),
                   torch.tensor([[0.0, 0.0], [0.0, 2.0], [1.0, 1.0]],
                                **_F64),
                   torch.full((2,), 0.5, **_F64), torch.zeros(2, **_F64),
                   torch.full((2,), 5.0, **_F64), 5),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_trip_sampler_is_the_per_chain_loop(monkeypatch, case):
    """`slice_sample_chains` (the plain loop on the CPU) keeps, bit for bit,
    the states a plain per-chain loop reaches on the same pre-drawn
    uniforms, with the log density at each, whatever the rows a chain a
    trip; an update takes as many trips as its slowest chain needs with
    rows/2 stepping-out and ``rows`` shrinking steps a trip."""
    logp, x0s, widths, lb, ub, n_sweeps = SLICE_CASES[case]
    if logp is None:
        logp = _spike_at(x0s)
    C, D = x0s.shape
    n = n_sweeps * D
    drawn = SliceChains(torch.Generator().manual_seed(7), logp, x0s, widths,
                        lb, ub, n)
    want, steps = _per_chain_slice(logp, x0s, widths, lb, ub, n_sweeps,
                                   drawn.log_v, drawn.r, drawn.u)
    for rows in (2, 4, 6):
        monkeypatch.setattr(slice_mod, "ROWS", rows)
        got, lps = slice_sample_chains(torch.Generator().manual_seed(7),
                                       logp, x0s, widths, lb, ub,
                                       n_keep=n_sweeps, burn=0, thin=1,
                                       n_keep_max=n_sweeps)
        assert torch.equal(got, want), rows
        assert torch.equal(lps, logp(got.reshape(-1, D)).reshape(
            C, n_sweeps))
        ch = SliceChains(torch.Generator().manual_seed(7), logp, x0s,
                         widths, lb, ub, n)
        for _ in range(n):
            ch.coordinate()
        per_chain = (-(-steps[0] // (rows // 2)) - (-steps[1] // rows))
        assert ch.counts == per_chain.amax(0).tolist(), rows
    if case == "stepout_cap":
        assert steps[0].unique().tolist() == [16]
    elif case == "shrink_cap":
        assert steps[1].unique().tolist() == [64]
        assert torch.equal(got, x0s[:, None, :].expand_as(got))
    elif case == "hard_bound":
        assert bool((got >= lb).all()) and bool((got[:, :, 0] > 0).any())


def _no_host_reads(monkeypatch):
    """Make every way of reading a tensor on the host raise."""
    def boom(*args, **kwargs):
        raise AssertionError("a host read")
    for name in ("__bool__", "__float__", "__int__", "__index__", "item",
                 "tolist", "nonzero", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch, "nonzero", boom)


def _gp_log_posterior(intmean=0, n=24, nb=32, **cfg_kw):
    """A GP log posterior as GP training samples it (in bounds, finite, else
    -inf), on a padded D=2 training set, and hyperparameter rows: the
    prior's starting point jittered, and a last row whose system matrix is
    not positive definite (every point perfectly correlated, no noise).
    ``cfg_kw`` sets more of the `GPConfig`."""
    from vbmc_tpu_torch.gp.fit import assemble_hyp_prior
    from vbmc_tpu_torch.utils.math import pad_to as tpad

    rng = np.random.default_rng(11)
    D = 2
    cfg = TGPConfig(D=D, intmean=intmean, **cfg_kw)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1) + 0.05 * rng.standard_normal(n)
    prior, x0 = assemble_hyp_prior(cfg, X, y, np.full(D, -2.0),
                                   np.full(D, 2.0), TrainOptions())
    Xp = torch.tensor(tpad(X, nb))
    yp = torch.tensor(tpad(y, nb))
    s2 = torch.zeros(nb, dtype=torch.float64)
    mask = torch.arange(nb) < n
    h = torch.tensor(x0)[None].repeat(5, 1)
    h[:4] += 0.05 * torch.tensor(rng.standard_normal((4, cfg.nhyp)))
    h[4, :D] = 12.0               # length scales far beyond the data
    h[4, D] = 8.0                 # a large signal
    h[4, cfg.ncov] = -30.0        # no noise

    def logpdf(hh):
        lp = tcore.gp_log_posterior(cfg, prior, hh, Xp, yp, s2, mask)
        inside = ((hh >= prior.lb) & (hh <= prior.ub)).all(-1)
        return torch.where(inside & torch.isfinite(lp), lp, -torch.inf)

    return cfg, prior, Xp, yp, s2, mask, h, logpdf


@pytest.mark.parametrize("intmean", [0, 2])
def test_log_posterior_without_gradients_is_the_autograd_one(monkeypatch,
                                                            intmean):
    """Without gradients the marginal likelihood replaces a failed factor
    on the device, with no host read; every row's value is the one the
    path that autograd takes gives, a failed one -inf."""
    cfg, prior, X, y, s2, mask, h, _ = _gp_log_posterior(intmean)
    hg = h.clone().requires_grad_(True)
    want = tcore.gp_log_posterior(cfg, prior, hg, X, y, s2, mask).detach()
    L, info = torch.linalg.cholesky_ex(tcore._system_matrix(
        cfg, h, X, y, None, mask)[0])
    assert (info[:4] == 0).all() and info[4] > 0
    assert torch.isfinite(want[:4]).all() and want[4] == -torch.inf
    with monkeypatch.context() as mp, torch.no_grad():
        _no_host_reads(mp)
        got = tcore.gp_log_posterior(cfg, prior, h, X, y, s2, mask)
    assert torch.equal(got, want)


def _trips_without_host_reads(monkeypatch, **cfg_kw):
    cfg, prior, X, y, s2, mask, h, logpdf = _gp_log_posterior(**cfg_kw)
    starts = torch.minimum(torch.maximum(h[:4], prior.lb), prior.ub)
    ch = SliceChains(torch.Generator().manual_seed(0), logpdf, starts,
                     torch.full((cfg.nhyp,), 0.3, dtype=torch.float64),
                     prior.lb, prior.ub, 2 * cfg.nhyp)
    with monkeypatch.context() as mp, torch.no_grad():
        _no_host_reads(mp)
        for _ in range(cfg.nhyp + 3):
            ch.begin()
            for _ in range(4):
                ch.trip()
    assert int(ch.k) >= 1 and torch.isfinite(ch.lp).all()


def test_a_trip_reads_nothing_on_the_host(monkeypatch):
    """The start of an update and a trip of the slice chains on GP
    training's log density make no host read: on the card they are what
    the graph records."""
    _trips_without_host_reads(monkeypatch)


# The GP configurations, besides the negquad mean, whose training the slice
# sampler runs (nhyp <= 20): each integrated mean, an output warp, output-
# dependent noise and a fitted user-noise scale.
GP_SLICE_VARIANTS = {"intmean1": dict(intmean=1), "intmean2": dict(intmean=2),
                     "intmean3": dict(intmean=3), "outwarp": dict(outwarp=1),
                     "output_noise": dict(output_noise=1),
                     "user_noise2": dict(user_noise=2)}


@pytest.mark.parametrize("variant", sorted(GP_SLICE_VARIANTS))
def test_a_trip_reads_nothing_on_the_host_in_each_gp_variant(monkeypatch,
                                                             variant):
    """As above, for every other GP configuration the slice sampler
    trains."""
    _trips_without_host_reads(monkeypatch, **GP_SLICE_VARIANTS[variant])


def test_ensemble_final_samples_gaussian():
    W, R = 16, 48
    lb = torch.full((2,), -10.0, dtype=torch.float64)
    pooled = []
    for seed in range(R):
        gen = torch.Generator().manual_seed(seed)
        x0 = 0.1 * torch.randn((W, 2), generator=gen, dtype=torch.float64)
        xs, lps = ensemble_slice_final(gen, _logp, x0, lb, -lb, 60)
        pooled.append(xs.numpy())
    pooled = np.concatenate(pooled)
    np.testing.assert_allclose(pooled.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(pooled.T), COV, atol=0.22)


def _quadratic(D):
    """An axis-aligned quadratic with scales 0.1 to 10 (D=4: the scales
    and minimum the test has used since the port began)."""
    if D == 4:
        scales = torch.tensor([1.0, 10.0, 0.1, 3.0], dtype=torch.float64)
        target = torch.tensor([0.3, -0.2, 1.0, 0.5], dtype=torch.float64)
    else:
        scales = torch.logspace(-1, 1, D, dtype=torch.float64)
        target = torch.linspace(-0.5, 1.0, D, dtype=torch.float64)

    def f(xs):
        return (((xs - target) * scales) ** 2).sum(1)

    return f, target


@pytest.mark.parametrize("D", [1, 2, 4, 10])
def test_cmaes_minimizes_ill_conditioned_quadratic(D):
    f, target = _quadratic(D)
    gen = torch.Generator().manual_seed(0)
    lb = torch.full((D,), -5.0, dtype=torch.float64)
    res = cmaes_minimize(gen, f, torch.zeros(D, dtype=torch.float64),
                         torch.ones(D, dtype=torch.float64), lb, -lb,
                         max_evals=3000, popsize=16)
    assert float(res.f_best) < 1e-6
    np.testing.assert_allclose(res.x_best.numpy(), target.numpy(), atol=1e-3)
    assert res.n_evals == 188 * 16


def test_cmaes_generations_by_hand_are_cmaes_minimize():
    """On the CPU `start` and `finish` are the generation function run
    n_gen times: by hand it gives the same bits, and n_gen lam
    evaluations."""
    D = 4
    f, _ = _quadratic(D)
    calls = []

    def f_counted(xs):
        calls.append(xs.shape[0])
        return f(xs)

    args = (torch.zeros(D, dtype=torch.float64),
            torch.ones(D, dtype=torch.float64),
            torch.full((D,), -5.0, dtype=torch.float64),
            torch.full((D,), 5.0, dtype=torch.float64))
    es = CMAES(torch.Generator().manual_seed(3), f_counted, *args,
               max_evals=500, popsize=16)
    assert es.n_gen == 32
    for _ in range(es.n_gen):
        es.generation()
    assert int(es.k) == es.n_gen
    by_hand = es.result()
    res = cmaes_minimize(torch.Generator().manual_seed(3), f, *args,
                         max_evals=500, popsize=16)
    assert res.n_evals == by_hand.n_evals == es.n_gen * es.lam == sum(calls)
    for field in ("x_best", "f_best", "x_mean"):
        assert torch.equal(getattr(by_hand, field), getattr(res, field))


def test_cmaes_start_value_is_the_best_to_beat():
    """``f0``, the start's own value, only seeds the best point: above every
    value CMA-ES finds it changes no bit of the result, below all of them
    the result is the start."""
    D = 4
    f, _ = _quadratic(D)
    x0 = torch.full((D,), 0.5, dtype=torch.float64)
    args = (x0, torch.ones(D, dtype=torch.float64),
            torch.full((D,), -5.0, dtype=torch.float64),
            torch.full((D,), 5.0, dtype=torch.float64))

    def run(f0=None):
        return cmaes_minimize(torch.Generator().manual_seed(3), f, *args,
                              max_evals=500, popsize=16, f0=f0)

    free, high = run(), run(torch.tensor(1e300, dtype=torch.float64))
    for field in ("x_best", "f_best", "x_mean"):
        assert torch.equal(getattr(free, field), getattr(high, field))
    low = run(torch.tensor(-1.0, dtype=torch.float64))
    assert torch.equal(low.x_best, x0) and float(low.f_best) == -1.0
    assert torch.equal(low.x_mean, free.x_mean)


def test_launch_counts_charge_and_take_back():
    """`kernels.add_launches` charges a reading of `launch_counts` as many
    times as asked, and takes it back with -1: what CMA-ES does with the
    launches a graph records."""
    from vbmc_tpu_torch import kernels

    start = kernels.launch_counts()
    try:
        kernels.sym_eig.launches += 1
        kernels.sym_eig.launches_f32 += 1
        recorded = kernels.launch_counts(since=start)
        assert recorded == [(0, 0), (0, 0), (1, 1)]
        kernels.add_launches(recorded, -1)
        assert kernels.launch_counts() == start
        kernels.add_launches(recorded, 374)
        assert kernels.launch_counts(since=start) == [(0, 0), (0, 0),
                                                      (374, 374)]
    finally:
        for k, (n, n32) in zip(kernels.KERNELS, start):
            k.launches, k.launches_f32 = n, n32


def test_cmaes_agrees_with_the_jax_reference():
    """The same rotated ill-conditioned quadratic through both packages,
    eight seeds each (their random streams differ, so the runs are
    compared by their spread): on a short budget the median log10 of the
    best value agrees within 1.5, and on a long one both reach the minimum
    to 1e-10 on every seed."""
    from vbmc_tpu.samplers.cmaes import cmaes_minimize as j_cmaes

    rng = np.random.default_rng(5)
    D = 4
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    H = Q @ np.diag(1.0 / np.array([10.0, 3.0, 1.0, 0.3]) ** 2) @ Q.T
    x_opt = rng.uniform(-1, 1, D)
    Hj, xj = jnp.asarray(H), jnp.asarray(x_opt)
    Ht, xt = torch.tensor(H), torch.tensor(x_opt)

    def fj(xs):
        return jnp.einsum("nd,de,ne->n", xs - xj, Hj, xs - xj)

    def ft(xs):
        return torch.einsum("nd,de,ne->n", xs - xt, Ht, xs - xt)

    jitted = {}

    def both(seed, max_evals):
        if max_evals not in jitted:     # one compile a budget
            jitted[max_evals] = jax.jit(lambda key: j_cmaes(
                key, fj, jnp.zeros(D), jnp.ones(D), jnp.full(D, -20.0),
                jnp.full(D, 20.0), max_evals=max_evals, popsize=16))
        rj = jitted[max_evals](jax.random.PRNGKey(seed))
        one = torch.ones(D, dtype=torch.float64)
        rt = cmaes_minimize(torch.Generator().manual_seed(seed), ft, 0 * one,
                            one, -20 * one, 20 * one, max_evals=max_evals,
                            popsize=16)
        assert rj.n_evals == rt.n_evals
        return rj, rt

    short = [both(s, 800) for s in range(8)]
    med_j = np.median([np.log10(float(rj.f_best)) for rj, _ in short])
    med_t = np.median([np.log10(float(rt.f_best)) for _, rt in short])
    assert abs(med_j - med_t) < 1.5, (med_j, med_t)
    for s in range(2):
        rj, rt = both(s, 3000)
        np.testing.assert_allclose(np.asarray(rj.x_best), x_opt, atol=1e-10)
        np.testing.assert_allclose(rt.x_best.numpy(), x_opt, atol=1e-10)


@pytest.mark.parametrize("D", [1, 2, 3, 10, 128])
def test_sym_eig_on_the_cpu_is_eigh(D):
    """The eigen wrapper's CPU path: B diag(L) B^T gives C back and B is
    orthogonal."""
    rng = np.random.default_rng(D)
    G = rng.standard_normal((D, D))
    C = torch.tensor(G @ G.T + 0.1 * np.eye(D))
    L, B = sym_eig(C)
    scale = float(C.abs().max())
    assert float((B @ torch.diag(L) @ B.T - C).abs().max()) < 1e-12 * scale
    assert float((B.T @ B - torch.eye(D, dtype=C.dtype)).abs().max()) < 1e-12


@pytest.mark.parametrize("A, err", [
    (torch.eye(129, dtype=torch.float64), ValueError),
    (torch.zeros((3, 4), dtype=torch.float64), ValueError),
    (torch.zeros((2, 2, 2), dtype=torch.float64), ValueError),
    (torch.eye(3, dtype=torch.float16), TypeError),
    (torch.eye(3, dtype=torch.int64), TypeError),
])
def test_sym_eig_refuses_what_the_kernel_does_not_take(A, err):
    with pytest.raises(err):
        sym_eig(A)


def _gp_problem(seed=0, D=2, n=30):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum((X / np.array([1.0, 0.7])[:D]) ** 2, 1)
    return X, y


def test_lbfgs_reaches_jax_map_minimum():
    """GP hyperparameter MAP from the same starts: the batched torch
    L-BFGS reaches the minimum optax L-BFGS reaches (or a lower one)."""
    D = 2
    cfg = GPConfig(D=D)
    X, y = _gp_problem()
    opts = JTrainOptions()
    jp, x0 = j_prior(cfg, X, y, np.full(D, -2.0), np.full(D, 2.0), opts)
    Xp, yp = pad_to(X, 32), pad_to(y, 32)
    mask = np.arange(32) < X.shape[0]

    def jobj(h):
        nll = (jcore.neg_log_marginal_likelihood(
            cfg, h, jnp.asarray(Xp), jnp.asarray(yp), jnp.zeros(32),
            jnp.asarray(mask)) - jcore.hyperprior_logpdf(jp, h))
        return jnp.where(jnp.isfinite(nll), nll, 1e12)

    rng = np.random.default_rng(3)
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    plb, pub = np.asarray(jp.plb), np.asarray(jp.pub)
    starts = np.stack([x0] + [plb + rng.random(cfg.nhyp) * (pub - plb)
                              for _ in range(2)])
    f_ref = np.array([float(j_lbfgs(jobj, jnp.asarray(s), jp.lb, jp.ub,
                                    maxiter=80)[1]) for s in starts])

    tp = hyp_prior_from_dict(jax.device_get(jp._asdict()))
    tcfg = TGPConfig(D=D)

    def tobj(h):
        nll = (tcore.neg_log_marginal_likelihood(
            tcfg, h, torch.tensor(Xp), torch.tensor(yp), torch.zeros(32),
            torch.tensor(mask))
            - tcore.hyperprior_logpdf(tp, h))
        return torch.where(torch.isfinite(nll), nll, 1e12)

    x_t, f_t = minimize_lbfgs_bounded(tobj, torch.tensor(starts), tp.lb,
                                      tp.ub, maxiter=80)
    assert bool(((x_t >= tp.lb) & (x_t <= tp.ub)).all())
    np.testing.assert_allclose(tobj(x_t).numpy(), f_t.numpy(), rtol=1e-12)
    # Same basin: the best minimum agrees to 1e-4 nats (or torch is lower).
    assert f_t.min().item() <= f_ref.min() + 1e-4
    assert f_t.min().item() >= f_ref.min() - 0.5


def test_fminadam_converges_on_quadratic_batch():
    target = torch.tensor([[1.0, -2.0], [0.5, 0.5]], dtype=torch.float64)

    def f_vg(x, _it):
        return value_and_grad(lambda z: ((z - target) ** 2).sum(1), x)

    res = fminadam(f_vg, torch.zeros((2, 2), dtype=torch.float64),
                   maxiter=2000, step_max=0.1, tol_fun=1e-6)
    np.testing.assert_allclose(res.x.numpy(), target.numpy(), atol=2e-2)
    assert bool((res.n_iters < 2000).all())


@pytest.mark.parametrize("D", [2, 6])
def test_train_gp_picks_the_reference_sampler(D):
    """nhyp <= 20 runs slice chains, nhyp > 20 the ensemble; both give
    dispersed finite samples and a GP that fits the training data."""
    rng = np.random.default_rng(D)
    X = rng.uniform(-2, 2, (40, D))
    y = -0.5 * np.sum(X ** 2, 1)
    cfg = TGPConfig(D=D)
    opts = TrainOptions(ns_samples=8, ninit=128, nopts=1, thin=2,
                        lbfgs_iters=30, n_chains=4)
    gen = torch.Generator().manual_seed(0)
    gp, info = train_gp(gen, cfg, X, y, None, np.full(D, -2.0),
                        np.full(D, 2.0), opts, host_seed=1, device="cpu")
    assert hyp_sampler_for(cfg, 8) == ("ensemble" if D == 6 else "slice")
    hyp = gp.hyp[gp.hyp_mask].numpy()
    assert np.all(np.isfinite(hyp)) and hyp.shape[0] == 8
    assert hyp.std(axis=0).max() > 1e-4
    from vbmc_tpu_torch.gp.predict import gp_predict
    fbar, _, _, _ = gp_predict(cfg, gp, torch.tensor(X[:8]))
    assert np.sqrt(np.mean((fbar.numpy() - y[:8]) ** 2)) < 0.5
