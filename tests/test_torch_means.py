"""The port's GP mean families against the JAX reference in float64:
`mean_function` and `mean_info` for all twelve families, the integrated
mean's basis, the fixed centre, and the hyperprior of each family."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vbmc_tpu.gp.fit import (TrainOptions as JTrainOptions,
                             assemble_hyp_prior as j_assemble)
from vbmc_tpu.gp import means as jmeans
from vbmc_tpu_torch.gp import means as tmeans
from vbmc_tpu_torch.gp.config import GPConfig as TGPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, assemble_hyp_prior

from test_torch_gp_problems import ALL_MEANFUNS, gp_problem, tcfg_of

torch.set_num_threads(1)


@pytest.mark.parametrize("meanfun", ALL_MEANFUNS)
def test_mean_function_matches_jax(meanfun):
    """rtol 1e-12: elementwise arithmetic on the same numbers."""
    cfg, X, _, _, hyps = gp_problem(0, meanfun=meanfun)
    Xs = np.random.default_rng(1).uniform(-3, 3, (11, 3))
    got = tmeans.mean_function(tcfg_of(cfg), torch.tensor(hyps[:, cfg.sl_mean]),
                               torch.tensor(Xs)).numpy()
    assert got.shape == (hyps.shape[0], 11)
    for s in range(hyps.shape[0]):
        ref = np.asarray(jmeans.mean_function(
            cfg, jnp.asarray(hyps[s, cfg.sl_mean]), jnp.asarray(Xs)))
        np.testing.assert_allclose(got[s], ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("meanfun", ALL_MEANFUNS)
def test_mean_info_matches_jax(meanfun):
    """Exact: the same numpy arithmetic."""
    cfg, X, y, _, _ = gp_problem(2, meanfun=meanfun)
    ref = jmeans.mean_info(cfg, X, y)
    got = tmeans.mean_info(tcfg_of(cfg), X, y)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("meanfun", ALL_MEANFUNS)
def test_hyp_prior_matches_jax(meanfun):
    """Bounds, plausible box, priors and x0 of every family (rtol 1e-12)."""
    cfg, X, y, _, _ = gp_problem(3, meanfun=meanfun)
    plb, pub = np.full(3, -2.0), np.full(3, 2.0)
    jp, jx0 = j_assemble(cfg, X, y, plb, pub, JTrainOptions())
    tp, tx0 = assemble_hyp_prior(tcfg_of(cfg), X, y, plb, pub, TrainOptions())
    np.testing.assert_allclose(tx0, jx0, rtol=1e-12)
    for name in ("mu", "sigma", "df", "lb", "ub", "plb", "pub"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("intmean", [0, 1, 2, 3, 4])
def test_int_mean_basis_matches_jax(intmean):
    cfg, X, _, _, _ = gp_problem(4, intmean=intmean)
    got = tmeans.int_mean_basis(tcfg_of(cfg), torch.tensor(X)).numpy()
    ref = np.asarray(jmeans.int_mean_basis(cfg, jnp.asarray(X)))
    assert got.shape == (X.shape[0], cfg.nint)
    np.testing.assert_allclose(got, ref, rtol=1e-14)


def test_fix_center_from_data_and_missing_centre():
    _, X, y, _, _ = gp_problem(5)
    assert tmeans.fix_center_from_data(X, y) == \
        jmeans.fix_center_from_data(X, y)
    with pytest.raises(ValueError, match="fix_center"):
        tmeans.mean_function(TGPConfig(D=3, meanfun=12), torch.zeros(1, 4),
                             torch.tensor(X))


def test_unknown_mean_raises():
    with pytest.raises(ValueError, match="unsupported meanfun"):
        TGPConfig(D=2, meanfun=5).nmean
