"""The port's `vbmc` end to end on CPU tensors, held to the reference's own
gate (`tests/test_e2e.py:12-18`): |ELBO - lnZ| < 0.5 nats and posterior-mean
RMSE < 0.5; plus short runs with each option of the user surface, and the
option values the reference refuses."""

import os

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch.main import vbmc
from vbmc_tpu_torch.vp import vp_moments

torch.set_num_threads(1)


def _check(result, lnz_true, mean_true, tol_elbo=0.5, tol_mean=0.5):
    err_elbo = abs(result.elbo - lnz_true)
    gen = torch.Generator().manual_seed(0)
    mean, _ = vp_moments(result.vp, orig_flag=True, n_samples=10 ** 5,
                         gen=gen)
    rmse = float(np.sqrt(np.mean((mean.numpy() - mean_true) ** 2)))
    assert err_elbo < tol_elbo, (result.elbo, lnz_true)
    assert rmse < tol_mean, (mean.numpy(), mean_true)
    return err_elbo, rmse


def test_mvn_2d_unconstrained():
    D = 2
    sd = np.array([1.0, 0.8])
    mu_true = np.array([0.5, -0.3])
    lnz = -1.3

    def logp(x):
        return (-0.5 * np.sum(((x - mu_true) / sd) ** 2)
                - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)) + lnz)

    opts = VBMCOptions(display="off", max_fun_evals=45, seed=1,
                       min_final_components=10)
    res = vbmc(logp, x0=np.zeros(D), plb=np.full(D, -3.0),
               pub=np.full(D, 3.0), options=opts, device="cpu")
    assert res.func_count <= 47
    assert res.vp.mu.device.type == "cpu"
    assert res.vp.mu.dtype == torch.float64
    _check(res, lnz, mu_true)


def test_noisy_halfnormal_viqr():
    """The noisy half-normal of `tests/test_e2e.py:61-80` (sigma=1 additive
    noise, the target returns its SD; the noise stream of `bench.py`
    `halfnorm2_noisy`): VIQR with its importance-sampling set, the GP with
    user noise and the per-point full updates, at the smallest evaluation
    budget that meets the gate here (25; the card runs 100)."""
    D = 2
    sd = np.array([1.0, 0.6])
    seed = 2
    noise = np.random.default_rng(1000 + seed)

    def logp(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + noise.standard_normal()), 1.0

    opts = VBMCOptions(display="off", max_fun_evals=25, seed=seed,
                       min_final_components=20, specify_target_noise=True)
    res = vbmc(logp, x0=np.array([0.5, 0.5]), lb=np.zeros(D),
               ub=np.full(D, 10.0), plb=np.full(D, 0.05),
               pub=np.full(D, 3.0), options=opts, device="cpu")
    assert res.func_count == 25
    assert res.quick_updates > 0
    _check(res, float(np.log(0.25)), sd * np.sqrt(2 / np.pi))


def test_noisy_acquisition_hedge_chooses_between_viqr_and_imiqr(monkeypatch):
    """With two acquisitions and ``acq_hedge`` the hedge of the reference
    (`vbmc_tpu_torch.hedge.AcqHedge`) picks one per iteration and is rewarded
    after each; at this seed it picks each once, so IMIQR runs end to end.
    The target is an unnormalised 2-D Gaussian (lnZ = log 2 pi) with
    sigma=0.3 noise."""
    from vbmc_tpu_torch.hedge import AcqHedge
    chosen, rewards = [], []
    choose, update = AcqHedge.choose, AcqHedge.update

    def spy_choose(self, rng):
        chosen.append(choose(self, rng))
        return chosen[-1]

    def spy_update(self, *a):
        rewards.append(a)
        return update(self, *a)

    monkeypatch.setattr(AcqHedge, "choose", spy_choose)
    monkeypatch.setattr(AcqHedge, "update", spy_update)
    noise = np.random.default_rng(3)

    def logp(x):
        y = -0.5 * np.sum(x ** 2)
        return float(y + 0.3 * noise.standard_normal()), 0.3

    opts = VBMCOptions(display="off", max_fun_evals=20, seed=2,
                       specify_target_noise=True, acq_hedge=True,
                       search_acq_fcn=["viqr", "imiqr"])
    res = vbmc(logp, x0=np.zeros(2), plb=np.full(2, -2.0),
               pub=np.full(2, 2.0), options=opts, device="cpu")
    assert res.func_count == 20
    assert abs(res.elbo - np.log(2 * np.pi)) < 0.5
    assert sorted(chosen) == ["imiqr", "viqr"]
    assert len(rewards) == res.iterations - 1


@pytest.mark.parametrize("override", [
    dict(temperature=2), dict(fvals=np.zeros(1)),
    dict(retry_max_fun_evals=11), dict(plot=True),
    dict(temperature=2, gp_mean_fun="negquadfix"),
    dict(temperature=2, specify_target_noise=True),
    dict(retry_max_fun_evals=11, gp_mean_fun="se"),
    dict(fvals=np.zeros(1), fitness_shaping=True),
    dict(plot=True, gp_int_mean_fun=1), dict(plot=True, bandwidth=0.1),
    dict(temperature=2, integer_vars=[0]),
    dict(retry_max_fun_evals=11, search_acq_fcn=["prospective_log"]),
    dict(fvals=np.zeros(1), hpd_search_frac=0.1),
    dict(plot=True, max_repeated_observations=2, specify_target_noise=True),
])
def test_options_outside_the_slice_raise(override, tmp_path, monkeypatch):
    """The options of the user surface (slice 5: ``temperature``, ``fvals``,
    ``retry_max_fun_evals``, ``plot``), alone and beside options of earlier
    slices, are accepted and take effect in a run of one or two
    iterations: the tempered ELBOs and the final VP go through
    `vp_train2real` at T=2, the pre-evaluated starting point enters the
    logger without a call of the target, the retry evaluates its own
    budget after the first run's, and the plot writes one PNG an
    iteration (or, where plotting fails, turns itself off with the
    reference's warning). One point an iteration and budgets of 11, a
    retry's too: a budget that resolves to ``fun_eval_start`` (10 at D=2;
    a smaller one is raised to ``min_fun_evals``, also 10) divides by zero
    in the reference's GP-training schedule, and so in the port's (ROADMAP
    Queue 3 x)."""
    import warnings

    from vbmc_tpu_torch import main as tmain
    calls, t2r = [], []
    noisy = override.get("specify_target_noise", False)

    def logp(x):
        calls.append(np.array(x))
        y = -float(np.sum(x ** 2))
        return (y, 1.0) if noisy else y

    real_t2r = tmain.vp_train2real
    monkeypatch.setattr(tmain, "vp_train2real",
                        lambda vp, T, *a: t2r.append(T) or real_t2r(vp, T, *a))
    monkeypatch.setenv("VBMC_PLOT_DIR", str(tmp_path))
    opts = VBMCOptions(display="off", max_fun_evals=11, seed=1,
                       fun_evals_per_iter=1, min_final_components=2,
                       **override)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = vbmc(logp, x0=np.zeros(2), plb=np.full(2, -1.0),
                   pub=np.full(2, 1.0), options=opts, device="cpu")
    assert np.isfinite(res.elbo) and np.isfinite(res.elbo_sd)
    if "temperature" in override:
        assert res.logger.T == 2
        assert t2r == [2] * (res.iterations + 1)
    else:
        assert t2r == []
    if "fvals" in override:
        # 9 calls complete the initial design of 10, two points follow
        assert res.logger.cache_count == 1
        assert res.logger.y_orig[0] == 0.0
        assert not any(np.all(c == 0.0) for c in calls)
        assert res.func_count == len(calls) == 11
    if "retry_max_fun_evals" in override:
        # the second run evaluates its own budget
        assert len(calls) == 11 + override["retry_max_fun_evals"]
    elif "fvals" not in override:
        assert len(calls) == res.func_count == 11
    if override.get("plot"):
        pngs = os.listdir(tmp_path)
        off = [w for w in caught if "iteration plot disabled" in str(w.message)]
        assert len(pngs) == res.iterations or (off and not pngs)


def test_warm_start_from_a_vp_raises():
    """`vbmc_tpu.vbmc` takes a variational posterior as ``x0``
    (`vbmc_tpu/main.py:372-382`), and so does the port: the first
    evaluation is at the first of 100 draws from the VP with the seed + 77,
    the next ones at the following draws."""
    from vbmc_tpu_torch.transforms import create_trinfo
    from vbmc_tpu_torch.vp import make_vp, vp_rnd
    ti = create_trinfo([-np.inf] * 2, [np.inf] * 2, [-1.0] * 2, [1.0] * 2)
    vp0 = make_vp(ti, np.zeros((2, 2)), 0.5, np.ones(2))
    draws = vp_rnd(vp0, torch.Generator().manual_seed(1 + 77), 100).numpy()
    calls = []

    def logp(x):
        calls.append(np.array(x))
        return -float(np.sum(x ** 2))

    res = vbmc(logp, x0=vp0, options=VBMCOptions(
        display="off", max_fun_evals=11, fun_evals_per_iter=1, seed=1,
        min_final_components=2), device="cpu")
    assert res.func_count == 11
    np.testing.assert_allclose(np.array(calls[:10]), draws[:10], rtol=1e-12)


def test_temperature_above_two_raises_as_the_reference_does():
    """`vbmc_tpu/options.py:366`: only power posteriors with T in {1, 2}."""
    import vbmc_tpu

    def logp(x):
        return -float(np.sum(x ** 2))

    kw = dict(x0=np.zeros(2), plb=np.full(2, -1.0), pub=np.full(2, 1.0))
    with pytest.raises(ValueError, match="temperature"):
        vbmc_tpu.vbmc(logp, options=vbmc_tpu.VBMCOptions(display="off",
                                                         temperature=3), **kw)
    with pytest.raises(ValueError, match="temperature"):
        vbmc(logp, options=VBMCOptions(display="off", temperature=3),
             device="cpu", **kw)


@pytest.mark.parametrize("override,match", [
    (dict(gp_mean_fun="cubic"), "gp_mean_fun"),
    (dict(bounded_transform="tanh"), "bounded_transform"),
    (dict(fitness_shaping=True, gp_out_warp_fun="log"), "gp_out_warp_fun"),
    (dict(search_acq_fcn=["thompson"]), "acquisition"),
])
def test_unknown_option_values_raise_as_the_reference_does(override, match):
    """The reference's up-front `ValueError`s (`vbmc_tpu/main.py:397-416`),
    from both packages on the same options."""
    import vbmc_tpu

    def logp(x):
        return -float(np.sum(x ** 2))

    kw = dict(x0=np.zeros(2), plb=np.full(2, -1.0), pub=np.full(2, 1.0))
    with pytest.raises(ValueError, match=match):
        vbmc_tpu.vbmc(logp, options=vbmc_tpu.VBMCOptions(display="off",
                                                         **override), **kw)
    with pytest.raises(ValueError, match=match):
        vbmc(logp, options=VBMCOptions(display="off", **override),
             device="cpu", **kw)
