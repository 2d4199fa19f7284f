"""The port's `vbmc` end to end on CPU tensors, held to the reference's own
gate (`tests/test_e2e.py:12-18`): |ELBO - lnZ| < 0.5 nats and posterior-mean
RMSE < 0.5; plus the options outside the ported slice raising."""

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
    dict(max_repeated_observations=2, specify_target_noise=True),
    dict(search_acq_fcn=["prospective_sn2"]),
    dict(search_acq_fcn=["eig"]), dict(search_acq_fcn=["us"]),
    dict(gp_mean_fun="se"), dict(fitness_shaping=True),
    dict(gp_int_mean_fun=1), dict(bandwidth=0.1), dict(integer_vars=[0]),
    dict(plot=True), dict(search_acq_fcn=["prospective_log"]),
    dict(temperature=2), dict(retry_max_fun_evals=10),
    dict(hpd_search_frac=0.1),
])
def test_options_outside_the_slice_raise(override):
    opts = VBMCOptions(display="off", **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vbmc(lambda x: -float(np.sum(x ** 2)), x0=np.zeros(2),
             plb=np.full(2, -1.0), pub=np.full(2, 1.0), options=opts,
             device="cpu")
