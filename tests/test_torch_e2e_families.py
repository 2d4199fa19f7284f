"""Whole runs of the port's `vbmc` on CPU tensors with the GP families and
the acquisitions beyond the defaults, each held to the reference's gate
(`tests/test_e2e.py:12-18`): |ELBO - lnZ| < 0.5 nats and posterior-mean
RMSE < 0.5. The runs follow the reference's own
(`tests/test_gp_meanfix.py:144`, `tests/test_gp_extras.py:353`) at 30
evaluations, each covering a mean family or GP feature together with an
acquisition or search option, so that the file stays short; the deterministic functions under each option are held to the
JAX package's values in the other `test_torch_*` files, and the host-side
search options run in `test_torch_e2e_search.py`."""

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions
from vbmc_tpu_torch.main import vbmc
from vbmc_tpu_torch.vp import vp_moments

torch.set_num_threads(1)

SD = np.array([1.0, 0.8])


def _gauss(x):
    """A normalised 2-D Gaussian: lnZ = 0, mean 0."""
    return float(-0.5 * np.sum((x / SD) ** 2) - np.log(2 * np.pi)
                 - np.sum(np.log(SD)))


def _gate(res, lnz, mean_true):
    gen = torch.Generator().manual_seed(0)
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    rmse = float(np.sqrt(np.mean((mean.numpy() - mean_true) ** 2)))
    assert np.isfinite(res.elbo)
    assert abs(res.elbo - lnz) < 0.5, (res.elbo, lnz)
    assert rmse < 0.5, (mean.numpy(), mean_true)


def _run(fun=_gauss, evals=35, seed=3, K=10, **kw):
    box = {k: kw.pop(k) for k in ("x0", "lb", "ub", "plb", "pub") if k in kw}
    box.setdefault("x0", np.zeros(2))
    box.setdefault("plb", np.full(2, -3.0))
    box.setdefault("pub", np.full(2, 3.0))
    opts = VBMCOptions(display="off", max_fun_evals=evals, seed=seed,
                       min_final_components=K, **kw)
    return vbmc(fun, options=opts, device="cpu", **box)


@pytest.mark.parametrize("evals,seed,kw", [
    (30, 3, dict(gp_mean_fun="negquadfix", search_acq_fcn=("eig",))),
    (30, 5, dict(gp_int_mean_fun=1, search_acq_fcn=("us",))),
    (30, 3, dict(gp_mean_fun="negquadse", fitness_shaping=True,
                 search_acq_fcn=("prospective_log",))),
    (30, 6, dict(gp_mean_fun="se", bandwidth=0.01, search_optimizer="none",
                 hpd_search_frac=0.2)),
], ids=["negquadfix-eig", "intmean-us", "negquadse-outwarp-log",
        "se-bandwidth-hpd-nocmaes"])
def test_gaussian_2d_with_families_and_acquisitions(evals, seed, kw):
    res = _run(evals=evals, seed=seed, **kw)
    assert res.func_count >= evals
    _gate(res, 0.0, np.zeros(2))
