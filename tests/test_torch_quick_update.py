"""The per-point full update of noisy targets (`quick_update.py`): after one
more acquired point it re-trains the GP from warm sampler chains and
re-fits the VP, with the behavioural checks of `tests/test_quick_update.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch.elbo import gplogjoint
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.gp.config import FIXED_CENTER_MEANFUNS, GPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, train_gp
from vbmc_tpu_torch.gp.means import fix_center_from_data
from vbmc_tpu_torch.quick_update import QuickUpdater
from vbmc_tpu_torch.transforms import create_trinfo
from vbmc_tpu_torch.vp import make_vp

torch.set_num_threads(1)

D = 2


def _setup(seed=42, n0=20, ns=4, **cfg_kw):
    rng = np.random.default_rng(seed)
    sd = np.array([1.0, 0.7])
    ti = create_trinfo([-np.inf] * D, [np.inf] * D, [-3.0] * D, [3.0] * D,
                       device="cpu")

    def noisy(x):
        y = float(-0.5 * np.sum((np.asarray(x) / sd) ** 2))
        return y + 0.5 * rng.standard_normal(), 0.5

    logger = FunctionLogger(noisy, D, ti, uncertainty_level=2)
    for _ in range(n0):
        logger.evaluate(rng.uniform(-2, 2, D))
    cfg = GPConfig(D=D, user_noise=1, **cfg_kw)
    if cfg.meanfun in FIXED_CENTER_MEANFUNS:
        X, y, _ = logger.training_data()
        cfg = dataclasses.replace(cfg,
                                  fix_center=fix_center_from_data(X, y))
    opts = VBMCOptions(display="off").resolve(D)
    topts = TrainOptions(ns_samples=ns, ninit=64, nopts=1, thin=2,
                         n_chains=2, lbfgs_iters=20)
    X, y, s2 = logger.training_data()
    gen = torch.Generator().manual_seed(0)
    gp, _ = train_gp(gen, cfg, X, y, s2, np.full(D, -3.0), np.full(D, 3.0),
                     topts, host_seed=1, device="cpu")
    vp = make_vp(ti, rng.uniform(-1, 1, (3, D)), 0.5, np.ones(D), k_max=4)
    return cfg, opts, topts, logger, gp, vp


def _updater(cfg, opts, topts, **kw):
    return QuickUpdater(cfg, opts, topts, np.full(D, -3.0), np.full(D, 3.0),
                        warmup=True, entropy_switch=False, K=3, **kw)


@pytest.mark.parametrize("ns", [4, 16])
def test_quick_updater_full(ns):
    cfg, opts, topts, logger, gp, vp = _setup(ns=ns)
    qu = _updater(cfg, opts, topts, do_gp=True, do_vp=True)
    logger.evaluate(np.array([0.3, -0.2]))
    gp2, vp2, gls = qu(torch.Generator().manual_seed(5), logger, gp, vp)

    # The new GP carries the grown training set, the logger's noise and
    # fresh hyperparameter samples.
    assert int(gp2.mask.sum()) == logger.n_train
    assert int(gp2.hyp_mask.sum()) == ns
    _, _, s2 = logger.training_data()
    np.testing.assert_array_equal(gp2.s2[:logger.n_train].numpy(), s2)
    assert bool(torch.isfinite(gls).all()) and bool((gls > 0).all())
    assert qu.updates == 1

    # The refit VP is valid and its expected log joint under the new GP is
    # not much worse than the un-refit VP's.
    assert np.isclose(float(vp2.w.sum()), 1.0, atol=1e-5)
    assert bool((vp2.sigma > 0).all())

    def G(v):
        g, _, _, _, _ = gplogjoint(cfg, gp2, v.mu[None], v.sigma[None],
                                   v.lam[None], v.w[None], v.kmask,
                                   compute_var=0)
        return float(g[0])

    assert G(vp2) > G(vp) - 1.0


def test_quick_updater_gp_only():
    cfg, opts, topts, logger, gp, vp = _setup()
    qu = _updater(cfg, opts, topts, do_gp=True, do_vp=False)
    logger.evaluate(np.array([0.1, 0.4]))
    gp2, vp2, _ = qu(torch.Generator().manual_seed(6), logger, gp, vp)
    assert vp2 is vp
    assert int(gp2.mask.sum()) == logger.n_train


def test_quick_updater_vp_only_keeps_hyperparameters():
    cfg, opts, topts, logger, gp, vp = _setup()
    qu = _updater(cfg, opts, topts, do_gp=False, do_vp=True)
    logger.evaluate(np.array([-0.5, 0.2]))
    gp2, vp2, _ = qu(torch.Generator().manual_seed(7), logger, gp, vp)
    torch.testing.assert_close(gp2.hyp, gp.hyp, rtol=0, atol=0)
    assert int(gp2.mask.sum()) == logger.n_train
    assert np.isclose(float(vp2.w.sum()), 1.0, atol=1e-5)


@pytest.mark.parametrize("cfg_kw", [
    dict(meanfun=8), dict(meanfun=12), dict(intmean=1),
    dict(outwarp=1), dict(meanfun=14, outwarp=3, intmean=2)],
    ids=["negquadse", "negquadfix", "intmean", "outwarp", "all-three"])
def test_quick_updater_with_other_gp_families(cfg_kw):
    """The per-point update assembles its prior and bounds through
    `assemble_hyp_prior`, so the mean families, the integrated mean and the
    output warp's hyperparameters pass through it: the retrained GP holds
    the grown set and its extras, and the refit VP stays valid."""
    cfg, opts, topts, logger, gp, vp = _setup(**cfg_kw)
    topts = dataclasses.replace(topts, outwarp_delta=opts.out_warp_thresh_base,
                                outwarp_thresh_base=opts.out_warp_thresh_base)
    qu = _updater(cfg, opts, topts, do_gp=True, do_vp=True)
    logger.evaluate(np.array([0.3, -0.2]))
    gp2, vp2, gls = qu(torch.Generator().manual_seed(5), logger, gp, vp)
    assert gp2.hyp.shape[1] == cfg.nhyp
    assert int(gp2.mask.sum()) == logger.n_train
    assert bool(torch.isfinite(gp2.alpha).all())
    assert (gp2.betabar is not None) == (cfg.nint > 0)
    if cfg.nint > 0:
        assert gp2.betabar.shape == (gp2.hyp.shape[0], cfg.nint)
    assert bool(torch.isfinite(gls).all()) and bool((gls > 0).all())
    assert np.isclose(float(vp2.w.sum()), 1.0, atol=1e-5)
    assert bool(torch.isfinite(vp2.mu).all()) and bool((vp2.sigma > 0).all())
