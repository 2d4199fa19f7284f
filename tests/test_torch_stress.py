"""The D=10 / K=50 stress configuration of `tests/test_stress.py` through
the port on CPU tensors: the anisotropic 10-D Gaussian (lnZ = 0), the final
boost to 50 components, and the reference's assertions. The whole budget
(250 evaluations: the GP past N=192, the ensemble hyperparameter sampler
at nhyp = 33) is marked slow as the reference is; a short twin of the
same target runs in tier 1. A file of its own, so that the test runner
gives it a worker of its own."""

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions, vbmc
from vbmc_tpu_torch.vp import vp_moments

torch.set_num_threads(1)

D = 10
SD = np.linspace(0.5, 2.0, D)


def mvn10(x):
    return float(-0.5 * np.sum((x / SD) ** 2)
                 - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(SD)))


def _run(evals):
    """`tests/test_stress.py:14-26` at a budget of ``evals``, pinned by
    ``min_fun_evals`` as there."""
    opts = VBMCOptions(display="off", max_fun_evals=evals, seed=3,
                       min_fun_evals=evals, min_final_components=50)
    return vbmc(mvn10, x0=np.full(D, 0.5), plb=np.full(D, -4.0),
                pub=np.full(D, 4.0), options=opts, device="cpu")


def _check(res):
    """The assertions of `tests/test_stress.py:30-41`."""
    mean, cov = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5,
                           gen=torch.Generator().manual_seed(0))
    assert abs(res.elbo) < 1.0, res.elbo
    rmse = float(np.sqrt(np.mean(mean.numpy() ** 2)))
    assert rmse < 0.5, rmse
    ratio = np.diag(cov.numpy()) / SD ** 2
    assert np.all(ratio > 0.35) and np.all(ratio < 2.8), ratio
    assert int(res.vp.kmask.sum()) >= 50


@pytest.mark.slow
def test_d10_k50_stress():
    res = _run(250)
    _check(res)
    assert res.func_count >= 240


def test_d10_k50_stress_short():
    """40 evaluations: the run goes on to ``min_iter`` = D iterations (65
    evaluations, N in the 128 rung), and the boost still takes the VP from
    its own K to 50 components."""
    res = _run(40)
    assert int(res.vp_train.kmask.sum()) < 50
    _check(res)
    assert res.func_count >= 40
