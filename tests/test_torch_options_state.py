"""The port's own copies of the host-side modules (`options`, `state`,
`hedge`) against the reference's: both sides are the same numpy code, so
every comparison is exact."""

import dataclasses
import types
import warnings

import numpy as np
import pytest

import vbmc_tpu.hedge as jhedge
import vbmc_tpu.options as jopt
import vbmc_tpu.state as jst
import vbmc_tpu_torch.hedge as thedge
import vbmc_tpu_torch.options as topt
import vbmc_tpu_torch.state as tst

_CALLABLE_ARGS = (1, 2, 7, 50, 133)


def _fields(cls):
    return [(f.name, f.type, f.default,
             None if f.default_factory is dataclasses.MISSING
             else f.default_factory())
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["VBMCOptions"])
def test_options_fields_and_defaults_match_reference(name):
    assert _fields(getattr(topt, name)) == _fields(getattr(jopt, name))
    assert topt._FIXED_BY_DESIGN == jopt._FIXED_BY_DESIGN


@pytest.mark.parametrize("name", ["IterStats", "Stats", "OptimState"])
def test_state_fields_and_defaults_match_reference(name):
    assert _fields(getattr(tst, name)) == _fields(getattr(jst, name))


def test_hedge_fields_and_defaults_match_reference():
    assert _fields(thedge.AcqHedge) == _fields(jhedge.AcqHedge)


def _resolved_values(r):
    out = {}
    for k, v in vars(r).items():
        if k == "user":
            continue
        out[k] = tuple(v(a) for a in _CALLABLE_ARGS) if callable(v) else v
    return out


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("D", [1, 2, 6, 10])
def test_resolved_options_match_reference(D, noisy):
    a = topt.VBMCOptions(specify_target_noise=noisy).resolve(D)
    b = jopt.VBMCOptions(specify_target_noise=noisy).resolve(D)
    va, vb = _resolved_values(a), _resolved_values(b)
    assert list(va) == list(vb)
    for k in va:
        assert va[k] == vb[k], k
    for name in ("ns_ent", "ns_elbo", "k_fun_max", "max_fun_evals"):
        assert a.evalopt(name, 12) == b.evalopt(name, 12)


@pytest.mark.parametrize("override", [
    dict(max_fun_evals=70, tol_stable_count=40, uncertainty_handling=True),
    dict(search_acq_fcn=("viqr", "imiqr"), acq_hedge=True,
         specify_target_noise=True, active_sample_gp_update=False),
    dict(ns_ent=lambda K: 3 * K, k_fun_max=lambda N: N ** 0.5, min_iter=900),
])
def test_resolved_options_with_overrides_match_reference(override):
    va = _resolved_values(topt.VBMCOptions(**override).resolve(3))
    vb = _resolved_values(jopt.VBMCOptions(**override).resolve(3))
    assert va == vb


@pytest.mark.parametrize("mod", [topt, jopt])
def test_options_reject_and_warn_alike(mod):
    with pytest.raises(ValueError, match="temperature must be 1 or 2"):
        mod.VBMCOptions(temperature=3).resolve(2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mod.VBMCOptions(gp_tol_opt=1e-3, cache_frac=0.3).resolve(2)
    assert len(w) == 1
    assert "['gp_tol_opt', 'cache_frac']" in str(w[0].message)


def _history(mod, n_iter, seed, warmup_until=6):
    """One recorded run: n_iter iterations of seeded summaries."""
    rng = np.random.default_rng(seed)
    stats = mod.Stats()
    elbo = -3.0
    for i in range(n_iter):
        elbo += float(rng.uniform(0.0, 0.6)) * 0.8 ** i
        stats.add(mod.IterStats(
            iter=i, elbo=elbo, elbo_sd=float(0.3 * 0.75 ** i),
            sKL=float(0.5 * 0.7 ** i), sKL_true=None, K=2 + i // 3,
            N=10 + 5 * i, neff=float(10 + 5 * i), func_count=10 + 5 * i,
            warmup=i < warmup_until, pruned=int(i % 7 == 6),
            varss=float(1e-3 * 0.5 ** i),
            rindex=float(rng.uniform(0.1, 3.0) * 0.85 ** i),
            lcbmax=float(-2.0 + 1.5 * (1 - 0.7 ** i) + 0.01 * rng.random()),
            timer={"active_sampling": float(rng.uniform(0.5, 1.0)),
                   "gp_train": float(0.1 + 0.01 * i + 0.01 * rng.random()),
                   "variational_fit": float(rng.uniform(0.2, 0.4)),
                   "finalize": 0.01}))
    return stats


def _logger(seed, n):
    rng = np.random.default_rng(seed)
    y = -np.abs(rng.standard_normal(n + 5)) * 40.0
    y[3] = np.nan
    return types.SimpleNamespace(Xn=n, y_orig=y, D=2,
                                 X_flag=np.ones(n + 5, dtype=bool))


def _iter_values(stats):
    return [(it.rindex, it.elcbo_impro, it.stable) for it in stats.iterations]


def _same(a, b):
    np.testing.assert_equal(a, b)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("n_iter", [2, 5, 14, 25])
def test_check_termination_matches_reference(n_iter, warm):
    outs = []
    for st, opts in ((tst, topt), (jst, jopt)):
        o = opts.VBMCOptions().resolve(2)
        stats = _history(st, n_iter, seed=11)
        state = st.OptimState(warmup=warm, sn2hpd=0.04,
                              last_successful_warping=3.0)
        trail = []
        # Replay the run: the controller is called after every iteration.
        for k in range(1, n_iter + 1):
            part = st.Stats(iterations=stats.iterations[:k])
            trail.append(st.check_termination(state, part, o,
                                              part.last.func_count))
        outs.append((trail, dataclasses.asdict(state), _iter_values(stats)))
    _same(outs[0], outs[1])
    if n_iter == 25:
        assert any(t[0] for t in outs[0][0])   # the history does terminate


@pytest.mark.parametrize("trimmed", [False, True])
@pytest.mark.parametrize("n_iter", [4, 9, 16])
def test_check_warmup_matches_reference(n_iter, trimmed):
    outs = []
    for st, opts in ((tst, topt), (jst, jopt)):
        o = opts.VBMCOptions().resolve(2)
        stats = _history(st, n_iter, seed=5, warmup_until=99)
        state = st.OptimState(data_trim_list=[20] if trimmed else [])
        logger = _logger(7, stats.last.N)
        notes, trim = st.check_warmup(state, stats, o, logger)
        outs.append((notes, trim, dataclasses.asdict(state),
                     logger.X_flag.copy()))
    _same(outs[0], outs[1])


def test_check_warmup_ends_warmup_on_the_recorded_history():
    o = topt.VBMCOptions().resolve(2)
    stats = _history(tst, 16, seed=5, warmup_until=99)
    state = tst.OptimState()
    notes, trim = tst.check_warmup(state, stats, o, _logger(7, stats.last.N))
    assert notes == ["end warm-up"] and trim and not state.warmup


@pytest.mark.parametrize("n_iter", [1, 8, 20])
def test_update_k_and_cost_model_match_reference(n_iter):
    outs = []
    for st, opts in ((tst, topt), (jst, jopt)):
        o = opts.VBMCOptions().resolve(2)
        stats = _history(st, n_iter, seed=3)
        state = st.OptimState(warmup=False, recompute_var_post=False, vp_K=3)
        k_new = st.update_K(state, stats, o)
        cost = st.update_cost_model(state, stats)
        outs.append((k_new, cost, state.t_algoperfuneval,
                     st.update_K(st.OptimState(), st.Stats(), o),
                     st.update_cost_model(st.OptimState(), st.Stats())))
    _same(outs[0], outs[1])


@pytest.mark.parametrize("rank_criterion", [True, False])
@pytest.mark.parametrize("stable_at", [None, 6, 11])
def test_best_iteration_matches_reference(stable_at, rank_criterion):
    outs = []
    for st in (tst, jst):
        stats = _history(st, 12, seed=9)
        if stable_at is not None:
            stats.iterations[stable_at].stable = True
        outs.append([st.best_iteration(stats, idx, rank_criterion=rank_criterion)
                     for idx in (None, 12, 7, 3)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("lapse", [0.0, 0.05])
def test_hedge_picks_and_weights_match_reference(lapse):
    names = ["viqr", "imiqr", "prospective"]
    outs = []
    for mod in (thedge, jhedge):
        rng = np.random.default_rng(42)
        rewards = np.random.default_rng(1).uniform(-0.5, 1.5, 40)
        h = mod.AcqHedge(names=list(names), beta=2.0, decay=0.9, lapse=lapse)
        picks, weights = [], []
        for r in rewards:
            picks.append(h.choose(rng))
            h.update(float(r), func_evals=5)
            weights.append(h.g.copy())
        outs.append((picks, np.asarray(weights)))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert len(set(outs[0][0])) > 1
