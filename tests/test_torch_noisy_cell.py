"""The noisy IBS deployment as the benchmark's cell ``ibs3.late`` runs it:
the per-point full update (`vbmc_tpu_torch/quick_update.py`) against the
benchmark's plain reference, the spans inside the full update and the
readers of the cell's new per-layer metrics, and the cell itself shrunk
for the CPU: correct in float64, not correct in float32 (the control)."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import correct
from benchmark import reference as ref
from benchmark import run as brun
from vbmc_tpu_torch import VBMCOptions, vbmc
from vbmc_tpu_torch.elbo import gplogjoint
from vbmc_tpu_torch.function_logger import FunctionLogger
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.fit import TrainOptions, train_gp
from vbmc_tpu_torch.quick_update import QuickUpdater
from vbmc_tpu_torch.transforms import create_trinfo
from vbmc_tpu_torch.vp import make_vp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "ibs3.late"
LIMITS = json.loads((ROOT / "benchmark" / "limits"
                     / f"{CELL}.json").read_text())
FULL_UPDATE = "active_sampling.full_update"
PARTS = ("map", "sample", "build", "sieve", "optimize", "pick")
READERS = ("active_sampling.full_update", "active_sampling.full_update.sample",
           "active_sampling.full_update.optimize", "active_sampling.is_set")
# What shrinks a run to seconds on the CPU: fewer candidates, CMA-ES
# evaluations and hyperparameter samples, and a small final posterior.
SMALL = dict(ns_search=256, search_max_fun_evals=96, ns_gp_max=8,
             min_final_components=5)


# ------------------------------------------- the full update, one call

def test_full_update_against_the_reference():
    """One `QuickUpdater` call on seeded D=3 data whose target reports a
    different SD at every point: the GP it returns passes the componentwise
    backward-error limits of the cell, on the rows and noise the logger
    holds, and the refitted posterior's expected log joint is the
    reference's Bayesian quadrature of it."""
    D, N = 3, 24
    rng = np.random.default_rng(20260418)
    ti = create_trinfo([-np.inf] * D, [np.inf] * D, [-3.0] * D, [3.0] * D,
                       device="cpu")
    scale = np.array([1.0, 0.7, 1.4])

    def noisy(x):
        x = np.asarray(x, float)
        sd = 0.2 + 0.3 * abs(x[0])
        return float(-0.5 * np.sum((x / scale) ** 2)
                     + sd * rng.standard_normal()), float(sd)

    logger = FunctionLogger(noisy, D, ti, uncertainty_level=2)
    for _ in range(N):
        logger.evaluate(rng.uniform(-2, 2, D))
    cfg = GPConfig(D=D, user_noise=1)
    opts = VBMCOptions(display="off").resolve(D)
    topts = TrainOptions(ns_samples=4, ninit=64, nopts=1, thin=2,
                         n_chains=2, lbfgs_iters=20)
    X, y, s2 = logger.training_data()
    gp, _ = train_gp(torch.Generator().manual_seed(0), cfg, X, y, s2,
                     np.full(D, -3.0), np.full(D, 3.0), topts, host_seed=1,
                     device="cpu")
    vp = make_vp(ti, rng.uniform(-1, 1, (3, D)), 0.5, np.ones(D), k_max=4)
    qu = QuickUpdater(cfg, opts, topts, np.full(D, -3.0), np.full(D, 3.0),
                      warmup=False, entropy_switch=False, K=3, do_gp=True,
                      do_vp=True)
    logger.evaluate(np.array([0.3, -0.2, 0.5]))
    gp2, vp2, _ = qu(torch.Generator().manual_seed(5), logger, gp, vp)

    g = correct.gp_state(gp2)
    X, y, s2 = logger.training_data()
    assert g["X"].shape == (N + 1, D) and len(np.unique(s2)) > N // 2
    np.testing.assert_array_equal(g["X"], X)
    np.testing.assert_array_equal(g["y"], y)
    np.testing.assert_array_equal(g["s2"], s2)
    post = ref.Posterior(g["X"], g["y"], g["s2"], g["hyp"],
                         factors=(g["alpha"], g["Binv"]))
    r_alpha, r_binv = post.residuals()
    assert r_alpha <= LIMITS["gp_alpha"] and r_binv <= LIMITS["gp_binv"]

    v = correct.vp_state(vp2)
    expect = ref.expected_log_joint(post, v["mu"], v["sigma"], v["lam"],
                                    v["w"])
    G = float(gplogjoint(cfg, gp2, vp2.mu[None], vp2.sigma[None],
                         vp2.lam[None], vp2.w[None], vp2.kmask,
                         compute_var=0)[0][0])
    assert abs(G - expect) <= 1e-10 * abs(expect)


# ------------------------------------------------ spans and readers

def _window_timers(fun, **opts):
    """A short D=2 run from a fresh start with warm-up off; the timers
    summed over every iteration but the first, as `benchmark/run.py`
    sums its window's, and the run's result."""
    D = 2
    infos = []

    def ofn(info):
        infos.append(dict(info["timer"]))
        return False

    res = vbmc(fun, x0=np.array([0.5, 0.5]), lb=np.zeros(D),
               ub=np.full(D, 10.0), plb=np.full(D, 0.05),
               pub=np.full(D, 3.0),
               options=VBMCOptions(display="off", seed=4, warmup=False,
                                   output_fcn=ofn, **SMALL, **opts),
               device="cpu")
    timers = {}
    for t in infos[1:]:
        for k, v in t.items():
            timers[k] = timers.get(k, 0.0) + v
    return timers, res


def _half_normal(x):
    sd = np.array([1.0, 0.6])
    return float(-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
                 - np.sum(np.log(sd)))


def _readers():
    return {p: brun.load_module(ROOT / "benchmark" / "metrics"
                                / f"{p}.s_per_point.py") for p in READERS}


def test_full_update_spans_and_their_readers():
    """A noisy run makes the six parts of the full update, each child at
    most its parent, and the cell's four new readers, loaded as
    `benchmark/run.py` loads them, read numbers; on a noiseless run,
    which makes neither a full update nor an importance-sampling set, they
    read nothing."""
    noise = np.random.default_rng(1002)

    def noisy(x):
        return _half_normal(x) + noise.standard_normal(), 1.0

    timers, res = _window_timers(noisy, specify_target_noise=True,
                                 fun_evals_per_iter=3, max_fun_evals=16)
    assert res.quick_updates > 0
    tot = res.timers
    for part in PARTS:
        assert tot[f"{FULL_UPDATE}.{part}"] <= tot[FULL_UPDATE], part
    # its own parts, not theirs (the slice sampler's `capture` and `tail`
    # nest inside `sample`)
    children = [p for p in tot if p.startswith(FULL_UPDATE + ".")
                and "." not in p[len(FULL_UPDATE) + 1:]]
    assert set(children) >= {f"{FULL_UPDATE}.{part}" for part in PARTS}
    assert sum(tot[p] for p in children) <= tot[FULL_UPDATE]
    assert tot[FULL_UPDATE] <= tot["active_sampling"]
    assert tot["active_sampling.is_set"] <= tot["active_sampling"]
    run = dict(timers=timers, points=3)
    for path, mod in _readers().items():
        v = mod.read(run)
        assert v is not None and math.isfinite(v) and v > 0, path

    quiet, res = _window_timers(_half_normal, fun_evals_per_iter=3,
                                max_fun_evals=16)
    assert res.quick_updates == 0
    assert not any(p.startswith((FULL_UPDATE, "active_sampling.is_set"))
                   for p in res.timers)
    for path, mod in _readers().items():
        assert mod.read(dict(timers=quiet, points=3)) is None, path


# ------------------------------------------------ the cell, shrunk

def _tiny(cfg, traffic):
    """``ibs3.late`` at 12 starting points and 20 more evaluations."""
    n = 12
    traffic.update(n_start=n, n_uniform=n // 5)
    traffic["options"].update(fun_eval_start=n, min_fun_evals=n + 20,
                              max_fun_evals=n + 20)
    cfg["options"].update(SMALL)


@pytest.mark.parametrize("dtype,ok", [(None, True), ("float32", False)],
                         ids=["float64", "float32_control"])
def test_the_cell_shrunk_is_correct_and_its_control_is_not(dtype, ok):
    wl, conf, spec = brun.cell_spec(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("ibs3", "late", 1)
    assert conf["reduced"] == []
    out, checks = brun.run_cell(CELL, 3000000017, 0.5, False, device="cpu",
                                dtype=dtype, tweak=_tiny)
    assert out["correct"] is ok, checks
    assert set(correct.compared(checks)) == {
        "train", "gp_alpha", "gp_binv", "elbo_G", "acq", "rmse"}
    assert set(out["metrics"]) == {"s_per_point", "setup_s"}
