"""Whole runs of the port's user surface on CPU tensors, held to the
reference's gate (`tests/test_e2e.py:12-18`) on the 2-D Gaussian of
`tests/test_e2e.py:21-36` (lnZ = -1.3, mean (0.5, -0.3)): a warm start
from a variational posterior, the retry from the best posterior, a
tempered target, a resume through pre-evaluated values, the run sweep in
process and through two worker processes, and the live plot. A file of its
own, so that the test runner gives it a worker of its own."""

import os
import sys

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import VBMCOptions, vbmc
from vbmc_tpu_torch.vp import make_vp, vp_moments

torch.set_num_threads(1)

D = 2
SD = np.array([1.0, 0.8])
MU = np.array([0.5, -0.3])
LNZ = -1.3
BOX = dict(plb=np.full(D, -3.0), pub=np.full(D, 3.0))


class Target:
    """The 2-D Gaussian, counting its calls; picklable for the workers."""

    def __init__(self):
        self.calls = []

    def __call__(self, x):
        self.calls.append(np.array(x, float))
        return float(-0.5 * np.sum(((x - MU) / SD) ** 2)
                     - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(SD)) + LNZ)


def _gate(res):
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5,
                         gen=torch.Generator().manual_seed(0))
    rmse = float(np.sqrt(np.mean((mean.numpy() - MU) ** 2)))
    assert abs(res.elbo - LNZ) < 0.5, res.elbo
    assert rmse < 0.5, mean


def _opts(**kw):
    return VBMCOptions(display="off", seed=1, min_final_components=10, **kw)


def test_warm_start_from_a_vp():
    """`vbmc_tpu/main.py:372-382`, `:421-425`: 100 draws from the VP (seed +
    77) give the first starting point, the plausible box (their 5% and 95%
    quantiles, as none is given) and the rest of the initial design."""
    from vbmc_tpu_torch.transforms import create_trinfo
    ti = create_trinfo([-np.inf] * D, [np.inf] * D, [-3.0] * D, [3.0] * D)
    u = (MU - 0.0) / 6.0        # the transform's affine map: centre 0, scale 6
    vp0 = make_vp(ti, u[None, :] + 0.02 * np.array([[1, 0], [0, 1], [-1, -1]]),
                  SD.mean() / 6.0, SD / SD.mean())
    f = Target()
    res = vbmc(f, x0=vp0, options=_opts(max_fun_evals=20), device="cpu")
    start = np.array(f.calls[:10])
    # the starting points are the VP's draws, not uniform in a wide box
    assert np.all(np.abs(start - MU) < 4 * SD)
    assert res.func_count == 20
    _gate(res)


def test_retry_runs_from_the_best_posterior():
    """`vbmc_tpu/main.py:900-917`: a first run too short to be stable
    (exit flag 0) is followed by a second one warm-started from its VP,
    with ``retry_max_fun_evals`` evaluations and the seed + 1."""
    f = Target()
    res = vbmc(f, x0=np.zeros(D), options=_opts(max_fun_evals=15,
                                                 retry_max_fun_evals=20),
               device="cpu", **BOX)
    assert len(f.calls) == 35          # the retry ran to its budget
    assert res.func_count in (15, 20)  # whichever result the rule keeps
    _gate(res)


def test_tempered_run_then_resume_through_fvals(tmp_path):
    """`temperature=2`: the run fits p^(1/2) and returns the real posterior
    through `vp_train2real`. Its checkpoint then seeds a new run
    (`vbmc_tpu/serialize.py:107-120`): the evaluations as ``x0`` with their
    values as ``fvals``, ten evaluations past the checkpoint's budget. The
    logger keeps tempered values (y / T; ROADMAP Queue 3 w), so the values
    passed back are T times the stored ones. No pre-evaluated point is
    evaluated again."""
    from vbmc_tpu_torch.serialize import load_checkpoint, save_result
    f = Target()
    res = vbmc(f, x0=np.zeros(D), options=_opts(max_fun_evals=30,
                                                 temperature=2),
               device="cpu", **BOX)
    _gate(res)
    path = str(tmp_path / "ck.npz")
    save_result(path, res)
    vp, evals, meta = load_checkpoint(path, device="cpu")
    assert meta["func_count"] == 30
    np.testing.assert_allclose(evals["y_orig"] * 2,
                               [Target()(x) for x in evals["X_orig"]],
                               rtol=1e-12)
    g = Target()
    res2 = vbmc(g, x0=evals["X_orig"], options=_opts(
        max_fun_evals=meta["func_count"] + 10, temperature=2,
        fvals=2 * evals["y_orig"]), device="cpu", **BOX)
    pre = {tuple(x) for x in evals["X_orig"]}
    assert not any(tuple(c) in pre for c in g.calls)
    assert res2.logger.cache_count == 10
    assert len(g.calls) == res2.func_count == 40
    _gate(res2)


@pytest.mark.parametrize("dispatch", ["local", "subprocess"])
def test_vbmc_sweep_gives_diagnostics(dispatch, tmp_path):
    """Two runs with seeds 1 and 1001 on the Rosenbrock-like target of the
    examples, in this process or in two CPU worker processes (cf.
    `tests/test_multihost.py:14`; the target must be importable there),
    gathered into a `DiagnosticsResult`."""
    from vbmc_tpu_torch.diagnostics import DiagnosticsResult
    from vbmc_tpu_torch.examples import rosenbrock_test
    from vbmc_tpu_torch.main import vbmc_sweep
    kw = {}
    if dispatch == "subprocess":
        kw = dict(env_per_run=[{"OMP_NUM_THREADS": "1"}] * 2,
                  workdir=str(tmp_path), timeout=600.0)
    diag, results = vbmc_sweep(rosenbrock_test, x0=np.zeros(D),
                               options=_opts(max_fun_evals=15), n_runs=2,
                               dispatch=dispatch, device="cpu", **BOX, **kw)
    assert isinstance(diag, DiagnosticsResult)
    assert diag.skl_matrix.shape == diag.mtv_matrix.shape == (2, 2)
    assert diag.best in (0, 1) and np.all(np.isfinite(diag.elbos))
    if dispatch == "local":
        assert [r.func_count for r in results] == [15, 15]
        assert results[0].vp.mu.device.type == "cpu"
    else:
        for vp, elbo, elbo_sd, meta in results:
            assert vp.mu.device.type == "cpu"
            assert meta["func_count"] == 15
            assert np.isfinite(elbo) and np.isfinite(elbo_sd)
    assert abs(diag.elbos[0] - diag.elbos[1]) < 3.0


def test_plot_writes_one_png_per_iteration(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("VBMC_PLOT_DIR", str(tmp_path))
    res = vbmc(Target(), x0=np.zeros(D), options=_opts(max_fun_evals=12,
                                                        plot=True),
               device="cpu", **BOX)
    pngs = sorted(os.listdir(tmp_path))
    assert pngs == [f"iter_{i:03d}.png" for i in range(1, res.iterations + 1)]
    assert "matplotlib" in sys.modules
