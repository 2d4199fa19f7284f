"""The port's microbenchmark `vbmc_tpu_torch/bench_kernels.py` (the twin of
`bench_kernels.py`) on the CPU: its deterministic rows against the JAX
package's functions on the same numpy inputs (float64, relative 1e-10),
its sampler rows' states and log density against the reference's -nlZ,
its FLOP counts against `KERNELS_r05_dev.json` (which pins the copied
formulas and the importance-sampling set's 298 points), its documented
peak, and its command line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbmc_tpu import elbo as jeb
from vbmc_tpu.acquisitions import AcqState as JAcqState
from vbmc_tpu.acquisitions import evaluate_acquisition as j_evaluate
from vbmc_tpu.active_is import ISState as JISState
from vbmc_tpu.active_is import evaluate_is_acquisition as j_evaluate_is
from vbmc_tpu.gp.core import neg_log_marginal_likelihood as j_nlz
from vbmc_tpu.gp.fit import _build_gp_jit
from vbmc_tpu.gp.gp import gp_from_host as j_gp_from_host
from vbmc_tpu.transforms import create_trinfo as j_create_trinfo
from vbmc_tpu.vp import make_vp as j_make_vp
from vbmc_tpu_torch import bench_kernels as tbk

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = (32, 4, 4, 256)
RTOL = 1e-10
# -nlZ at a sampler's state against the reference: the nlZ parity rule of
# `tests/test_torch_gp.py:73` (a state 10 away from the samples conditions
# the Gram matrix worse than the samples do).
NLZ_RTOL = 1e-8


@pytest.fixture(scope="module")
def small():
    """The twin's inputs and rows at N=32 S=4 K=4 M=256, and the JAX
    package's GP, VP and acquisition state from the same numpy draws."""
    inp = tbk.build_inputs(*SMALL, "cpu")
    rows = {r.name: r for r in tbk.make_rows(inp)}
    cfg, X, y, hyps, mu, _ = tbk.host_inputs(*SMALL)
    N, S, K, M = SMALL
    D = tbk.D
    jgp = j_gp_from_host(cfg, X, y, None, hyps, n_bucket=N, s_bucket=S)
    trinfo = j_create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                             [2.0] * D)
    jvp = j_make_vp(trinfo, mu, 0.5, np.ones(D))
    f64 = jnp.float64
    state = JAcqState(
        ymax=jnp.asarray(0.0, f64), tol_var=jnp.asarray(1e-4, f64),
        lb_eps_orig=jnp.full((D,), -jnp.inf, f64),
        ub_eps_orig=jnp.full((D,), jnp.inf, f64),
        gp_length_scale=jnp.ones(D, f64), var_log_joint=jnp.ones(S, f64),
        regularize=jnp.asarray(True))
    return inp, rows, cfg, jgp, jvp, state


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def test_posterior_build_equals_the_reference(small):
    inp, rows, cfg, jgp, _, _ = small
    got = rows["gp_posterior_build"].call(0)
    ref = _build_gp_jit(cfg, jgp.X, jgp.y, jgp.s2, jgp.mask, jgp.hyp,
                        jgp.hyp_mask)
    for name in ("L", "alpha", "Binv"):
        _close(getattr(got, name), getattr(ref, name))


def test_plain_prospective_sweep_equals_the_reference(small):
    inp, rows, cfg, jgp, jvp, state = small
    got = rows["acquisition_sweep_8k"].call(0)
    ref = j_evaluate(cfg, "prospective", jnp.asarray(inp.Xs.numpy()), jvp,
                     jgp, state)
    assert got.shape == (SMALL[3],)
    _close(got, ref)


def test_plain_viqr_sweep_equals_the_reference(small):
    """On the port's importance-sampling set (298 points), handed to the
    reference as its `ISState`."""
    inp, rows, cfg, jgp, jvp, state = small
    ais = JISState(**{k: jnp.asarray(getattr(inp.ais, k).numpy())
                      for k in ("Xa", "ln_weights", "invKzk", "f_s2")})
    assert ais.Xa.shape == (298, tbk.D)
    got = rows["viqr_sweep_8k"].call(0)
    ref = j_evaluate_is(cfg, "viqr", jnp.asarray(inp.Xs.numpy()), jvp, jgp,
                        state, ais)
    _close(got, ref)


def test_elbo_value_and_gradient_equal_the_reference(small):
    inp, rows, cfg, jgp, jvp, _ = small
    F, g = rows["elbo_value_and_grad"].call(0)
    flags = jeb.VPFlags(opt_weights=True)
    theta = jeb.pack_theta(flags, jvp.mu, jvp.sigma, jvp.lam,
                           jnp.zeros(SMALL[2]))

    def f(th):
        return jeb.negelcbo(cfg, th, jgp, jvp.mu, jvp.sigma, jvp.lam, jvp.w,
                            jvp.kmask, flags, 0.0, 0, 1,
                            jax.random.PRNGKey(0))[0]

    v_ref, g_ref = jax.value_and_grad(f)(theta)
    assert F.shape == (1,) and g.shape == (1, theta.shape[0])
    _close(F[0], v_ref)
    _close(g[0], g_ref)


@pytest.mark.parametrize("name", ["slice_sweep_nlz", "ensemble_sweep_nlz"])
def test_sampler_rows_stay_in_their_box_on_the_references_nlz(small, name):
    """The states stay within 10 of the starting samples (the box of
    `bench_kernels.py`: around the first sample for the slice sweep, around
    all of them for the ensemble), and the rows' log density, -nlZ, is the
    reference's at those states."""
    inp, rows, cfg, jgp, _, _ = small
    xs, lps = rows[name].call(0)
    xs = xs.reshape(-1, cfg.nhyp)
    lps = lps.reshape(-1)
    h = torch.as_tensor(inp.hyps)
    if name.startswith("slice"):
        assert xs.shape[0] == 1
        lo, hi = h[0] - 10.0, h[0] + 10.0
    else:
        assert xs.shape[0] == SMALL[1]
        lo, hi = h.amin(0) - 10.0, h.amax(0) + 10.0
    assert torch.isfinite(xs).all() and torch.isfinite(lps).all()
    assert ((xs >= lo) & (xs <= hi)).all()
    logp = tbk.nlz_logp(inp.cfg, inp.gp)
    ref = -jax.vmap(lambda x: j_nlz(cfg, x, jgp.X, jgp.y, jgp.s2,
                                    jgp.mask))(jnp.asarray(xs.numpy()))
    _close(logp(xs), ref, NLZ_RTOL)
    _close(lps, logp(xs), 1e-12)


@pytest.fixture(scope="module")
def default_rows():
    return {r.name: r for r in tbk.make_rows(
        tbk.build_inputs(*tbk.DEFAULTS, "cpu"))}


@pytest.mark.parametrize("name", [
    "gp_posterior_build", "acquisition_sweep_8k", "viqr_sweep_8k",
    "elbo_value_and_grad", "slice_sweep_nlz", "ensemble_sweep_nlz"])
def test_flops_at_the_default_shape_equal_the_tpu_record(default_rows, name):
    rec = {r["metric"]: r for r in map(json.loads, (
        ROOT / "KERNELS_r05_dev.json").read_text().splitlines())}
    want = rec[f"kernel_{name}_ms"]
    assert (want["N"], want["S"], want["K"], want["M"]) == tbk.DEFAULTS
    assert int(default_rows[name].flops) == want["flops"]


def test_documented_peak_takes_the_longest_name(monkeypatch):
    assert tbk.peak_for("NVIDIA H100 80GB HBM3") == (
        67.0, "NVIDIA H100 80GB HBM3")
    assert tbk.peak_for("NVIDIA H100 PCIe") == (None, None)
    monkeypatch.setitem(tbk.DOCUMENTED_PEAK_F64, "NVIDIA H100", 1.0)
    assert tbk.peak_for("NVIDIA H100 80GB HBM3")[0] == 67.0
    assert tbk.peak_for("NVIDIA H100 NVL")[0] == 1.0


def test_a_dgemm_over_the_documented_peak_is_a_broken_timer():
    row = {"value": 71.0, "documented_peak_f64_tflops": 67.0,
           "measured_dgemm_frac_of_documented": 71.0 / 67.0}
    with pytest.raises(tbk.BrokenTimer, match="timer is broken"):
        tbk.check_probe(row)
    tbk.check_probe(dict(row, measured_dgemm_frac_of_documented=1.04))


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "vbmc_tpu_torch.bench_kernels", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})


def test_the_command_on_the_cpu_prints_the_probe_and_six_rows():
    out = _run("--device", "cpu", *map(str, SMALL))
    assert out.returncode == 0, out.stderr
    lines = [json.loads(s) for s in out.stdout.splitlines()]
    probe, rows = lines[0], lines[1:]
    assert probe["metric"] == "device_probe" and probe["value"] is None
    assert probe["device"] == "cpu"
    assert [r["metric"] for r in rows] == [
        f"kernel_{n}_ms" for n in (
            "gp_posterior_build", "acquisition_sweep_8k", "viqr_sweep_8k",
            "elbo_value_and_grad", "slice_sweep_nlz", "ensemble_sweep_nlz")]
    for r in rows:
        assert (r["N"], r["S"], r["K"], r["M"]) == SMALL
        assert r["dtype"] == "float64" and r["device"] == "cpu"
        assert r["ms_pipelined"] > 0 and r["ms_single"] > 0
        # no device metric from a CPU run
        assert r["launches"] is None and r["device_ms"] is None
        assert r["mfu"] is None and r["mfu_f64roof"] is None
        assert r["sweep_launches"] == {"prospective_acq": 0, "viqr_acq": 0}


def test_the_command_exits_2_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    out = _run()
    assert out.returncode == 2 and out.stdout == ""
    assert "--device cpu" in out.stderr
