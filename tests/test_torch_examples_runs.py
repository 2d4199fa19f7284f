"""The port's six worked examples (`vbmc_tpu_torch/examples.py`), each run
whole through its own function on CPU tensors at a small budget: the kind
of value its twin in `vbmc_tpu/examples.py` returns, exit flag >= 0, and for
examples 2 and 6 the posterior mean against the quadrature oracle
`chip_smoke.example_truth` within the bound the JAX package meets at the
same budget and seed (CHANGES.md, PR 12: RMSE 0.0416 for example 2 at 20
evaluations, 0.1900 for example 6 at 20, both within the standard 0.5)."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import vbmc_tpu.diagnostics as jdiag
import vbmc_tpu.main as jmain
from vbmc_tpu_torch import active_sample, examples
from vbmc_tpu_torch.diagnostics import DiagnosticsResult
from vbmc_tpu_torch.main import VBMCResult
from vbmc_tpu_torch.utils import ibs
from vbmc_tpu_torch.vp import vp_moments

torch.set_num_threads(1)

# (example, keyword arguments): the smallest budgets the runs allow (the
# D=2 and D=3 runs go to min_iter = D iterations of 5 points past the
# initial design of 10), example 4 with two runs.
RUNS = {1: dict(max_fun_evals=15), 2: dict(max_fun_evals=20),
        3: dict(max_fun_evals=15), 4: dict(max_fun_evals=15, n_runs=2),
        5: dict(max_fun_evals=15), 6: dict(max_fun_evals=20)}
# Posterior-mean RMSE against the oracle: the standard gate, which
# `vbmc_tpu` meets at these budgets and seeds.
MEAN_RMSE = {2: 0.5, 6: 0.5}


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _rmse(res, mean_true):
    gen = torch.Generator().manual_seed(0)
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    return float(np.sqrt(np.mean((mean.numpy() - mean_true) ** 2)))


@pytest.mark.parametrize("n", sorted(RUNS))
def test_example_runs_whole_on_cpu_tensors(n, monkeypatch):
    sweeps = []
    sweep = active_sample.sweep_is_acquisition

    def counted(cfg, name, *args, **kw):
        sweeps.append(name)
        return sweep(cfg, name, *args, **kw)

    monkeypatch.setattr(active_sample, "sweep_is_acquisition", counted)
    # example 6's target seeds its IBS stream from `np.round(params, 8)`:
    # the function logger must hand it a float64 numpy vector, as the JAX
    # package's does
    params = []
    ibs_sd = ibs.ibs_loglike_and_sd

    def recorded(simulator, theta, *args, **kw):
        params.append(theta)
        return ibs_sd(simulator, theta, *args, **kw)

    monkeypatch.setattr(ibs, "ibs_loglike_and_sd", recorded)
    out = examples.EXAMPLES[n](device="cpu", **RUNS[n])
    if n == 3:
        res, diag = out
        runs = [res]
    elif n == 4:
        runs, diag = out
        assert isinstance(runs, list) and len(runs) == RUNS[4]["n_runs"]
    else:
        runs, diag = [out], None
    # the JAX twin returns a VBMCResult, (res, diag) for example 3 and
    # (list, diag) for example 4, with these fields
    assert set(_fields(jmain.VBMCResult)) <= set(_fields(VBMCResult))
    if diag is not None:
        assert isinstance(diag, DiagnosticsResult)
        assert _fields(DiagnosticsResult) == _fields(jdiag.DiagnosticsResult)
    for res in runs:
        assert isinstance(res, VBMCResult)
        assert res.vp.mu.device.type == "cpu"
        assert res.exitflag >= 0
        assert np.isfinite(res.elbo)
    if n in MEAN_RMSE:
        truth = chip_smoke.example_truth(n)
        assert _rmse(runs[0], truth["mean"]) < MEAN_RMSE[n]
    if n == 6:
        # the noisy path: the IS sweep and the per-point full updates
        assert set(sweeps) & {"viqr", "imiqr"}
        assert len(params) == runs[0].func_count
        assert all(type(p) is np.ndarray and p.dtype == np.float64
                   and p.shape == (3,) for p in params)
        assert runs[0].quick_updates >= 1
        sd = runs[0].logger.S[:runs[0].logger.Xn]
        assert np.all(np.isfinite(sd)) and sd.min() > 0
    else:
        assert not sweeps
