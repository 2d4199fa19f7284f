"""The final boost across input warps (`tests/test_finalboost.py`) through
the port on CPU tensors: the boost optimises the best iteration's VP
against the GP of that same iteration (`misc/finalboost_vbmc.m:36`), not
against the last GP, which after a later rotoscale warp lives in another
transformed space. Marked slow as the reference is (about 45 s)."""

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions, vbmc

torch.set_num_threads(1)


@pytest.mark.slow
def test_boost_uses_best_iterations_gp_across_warps():
    # Correlated 2-D Gaussian in a box: rotoscale warps engage, and
    # warp_every_iters=1 lets them land up to the last iteration.
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    prec = np.linalg.inv(cov)
    lognorm = -np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(cov)[1]

    def lnp(x):
        return float(-0.5 * x @ prec @ x + lognorm)

    res = vbmc(lnp, x0=np.array([0.2, 0.2]), lb=np.full(2, -6.0),
               ub=np.full(2, 6.0), plb=np.full(2, -3.0), pub=np.full(2, 3.0),
               options=VBMCOptions(max_fun_evals=60, seed=11, display="off",
                                   warp_every_iters=1, warp_min_k=2,
                                   min_final_components=20),
               device="cpu")
    # every iteration records its GP (the boost's input)
    assert all(it.gp is not None for it in res.stats.iterations)
    assert res.warps_made >= 1
    assert int(res.vp_train.kmask.sum()) < 20 <= int(res.vp.kmask.sum())
    # lnZ = 0: the boost's result within the self-test gate
    assert abs(res.elbo) < 0.5, res.elbo
