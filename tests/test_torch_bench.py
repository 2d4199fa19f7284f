"""The port's acceptance harness (`vbmc_tpu_torch/bench.py`, the twin of
`bench.py`) on the CPU: its stress block, knobs and constants against
`bench.py`'s (read with `ast`: `bench.py` imports jax and sets `sys.path`
when imported), `selftest.run_block`'s deadline and per-layer numbers, the
runner of child processes, the budget's skip notes, the exit code over a
failed run, the refusal without a card; and the law of `vp._chi2`'s two
paths (ROADMAP decision z)."""

import ast
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.stats
import torch

from vbmc_tpu_torch import bench as tbench
from vbmc_tpu_torch import selftest

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
BENCH_SRC = (ROOT / "bench.py").read_text()
KNOBS = ("VBMC_BENCH_BUDGET_S", "VBMC_BENCH_BLOCKS", "VBMC_BENCH_STRESS",
         "VBMC_BENCH_SEEDS", "VBMC_BENCH_PARALLEL", "VBMC_BENCH_PROGRESS")


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _env_reads(src):
    """{knob: default} of every os.environ.get("VBMC_BENCH_...", default);
    a default that is not a literal reads as None."""
    out = {}
    for n in ast.walk(ast.parse(src)):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "get" and ast.unparse(n.func.value)
                == "os.environ" and isinstance(n.args[0], ast.Constant)):
            default = n.args[1] if len(n.args) > 1 else None
            out[n.args[0].value] = (default.value if isinstance(
                default, ast.Constant) else None)
    return out


def _blk(name):
    return {b["name"]: b for b in selftest._blocks()}[name]


def test_stress_block_equals_bench_run_stress_block():
    fn = _function(ast.parse(BENCH_SRC), "run_stress_block")
    defaults = {a.arg: ast.literal_eval(d) for a, d in
                zip(fn.args.args[-len(fn.args.defaults):], fn.args.defaults)}
    assert (tbench.STRESS_SEED, tbench.STRESS_EVALS) == (
        defaults["seed"], defaults["max_fun_evals"]) == (7, 300)
    # The target: bench.py's D, sd and mvn10, run on the same points.
    head = [s for s in fn.body if isinstance(s, ast.Assign)
            and ast.unparse(s.targets[0]) in ("D", "sd")]
    head.append(_function(fn, "mvn10"))
    ns = {"np": np}
    exec(compile(ast.Module(body=head, type_ignores=[]), "bench.py", "exec"),
         ns)
    blk = tbench.stress_block()
    assert blk["D"] == ns["D"] == 10 and blk["lnz"] == 0.0
    for x in np.random.default_rng(0).uniform(-4, 4, (20, 10)):
        assert blk["fun"](x) == ns["mvn10"](x)
    # The measured run's options and bounds (the last vbmc call).
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    opts = [c for c in calls if ast.unparse(c.func) == "VBMCOptions"][-1]
    kw = {k.arg: ast.unparse(k.value) for k in opts.keywords}
    assert kw["min_fun_evals"] == "max_fun_evals"
    assert blk["options"] == dict(min_fun_evals=tbench.STRESS_EVALS,
                                  min_final_components=int(
                                      kw["min_final_components"]))
    run = [c for c in calls if ast.unparse(c.func) == "vbmc"][-1]
    for k in run.keywords:
        if k.arg in ("x0", "plb", "pub"):
            np.testing.assert_array_equal(
                blk[k.arg], eval(ast.unparse(k.value), ns))
    assert blk["lb"] is None and blk["ub"] is None and not blk["noisy"]
    # Its gate: |ELBO| < 1 and RMSE < 0.5, as bench.py's.
    gate = [k.value for c in calls if ast.unparse(c.func) == "dict"
            for k in c.keywords if k.arg == "ok"][0]
    assert ast.unparse(gate) == "bool(err_elbo < 1.0 and rmse < 0.5)"


def test_constants_and_knobs_equal_bench_py():
    consts = {ast.unparse(s.targets[0]): ast.literal_eval(s.value)
              for s in ast.parse(BENCH_SRC).body
              if isinstance(s, ast.Assign) and isinstance(s.value,
                                                          ast.Constant)}
    assert tbench.MATLAB_BASELINE_TOTAL == consts["MATLAB_BASELINE_TOTAL"]
    assert tbench.MATLAB_BLOCKS == consts["MATLAB_BLOCKS"]
    base = json.loads((ROOT / "BASELINE_D10.json").read_text())
    assert tbench.BASELINE_D10_S_PER_ITER == base["s_per_iter"]
    ref = _env_reads(BENCH_SRC)
    got = {**_env_reads((ROOT / "vbmc_tpu_torch/bench.py").read_text()),
           **_env_reads((ROOT / "vbmc_tpu_torch/selftest.py").read_text())}
    for knob in KNOBS:
        assert knob in ref and knob in got, knob
        if ref[knob] is not None:
            assert got[knob] == ref[knob], knob


def test_run_block_with_a_passed_deadline_stops_after_one_iteration():
    r = selftest.run_block(_blk("smoothbox1"), seed=1, max_fun_evals=20,
                           device="cpu", deadline=time.monotonic() - 1.0)
    assert r["cut"] and r["iters"] == 1 and r["func_count"] < 20
    assert r["acquired"] == r["func_count"] - 10


def test_run_block_takes_a_blocks_own_options():
    blk = dict(_blk("smoothbox1"), options=dict(min_final_components=5,
                                                min_fun_evals=15))
    r = selftest.run_block(blk, seed=1, max_fun_evals=15, device="cpu")
    assert r["func_count"] == 15 and r["K_final"] == 5 >= r["K"]


def test_k_is_the_best_iterations_vp_before_the_boost(monkeypatch):
    """``K`` is `bench.py`'s quantity, the components of ``res.vp_train``;
    ``K_final`` counts the final VP, which the boost raised."""
    import vbmc_tpu_torch

    results = []

    def keep(*args, **kw):
        results.append(run(*args, **kw))
        return results[-1]

    run = vbmc_tpu_torch.vbmc
    monkeypatch.setattr(vbmc_tpu_torch, "vbmc", keep)
    r = selftest.run_block(_blk("smoothbox1"), seed=1, max_fun_evals=15,
                           device="cpu")
    (res,) = results
    assert r["K"] == int(res.vp_train.kmask.sum())
    assert r["K_final"] == int(res.vp.kmask.sum()) == 20 > r["K"]


def test_the_stress_block_runs_through_run_job():
    r = tbench.run_job(dict(name="stress_d10", seed=tbench.STRESS_SEED,
                            max_fun_evals=tbench.STRESS_EVALS,
                            deadline=time.monotonic() - 1.0, device="cpu"))
    assert "error" not in r and r["cut"] and r["iters"] == 1
    assert r["K_final"] == 50 and r["func_count"] == 20


def test_run_block_returns_timers_launches_and_the_gate():
    r = selftest.run_block(_blk("smoothbox1"), seed=1, max_fun_evals=20,
                           device="cpu")
    assert r["ok"] and not r["cut"] and r["elbo_err"] < 0.5
    assert r["rmse"] < 0.5
    assert r["exitflag"] >= 0 and r["func_count"] == 20
    assert r["acquired"] == 10 and r["iters"] >= 2
    assert r["launches"] == {"prospective_acq": 0, "viqr_acq": 0}
    assert {"active_sampling", "gp_train", "variational_fit", "finalize",
            "warping", "total"} <= set(r["timers"])
    assert r["peak_device_mib"] is None and r["K_final"] >= r["K"] >= 1
    assert 0 < r["s_per_iter_median"] and 0 < r["s_per_iter"] <= r[
        "elapsed_s"]
    json.dumps(r)


class _Die:
    """Unpickled in the child, it ends that process with code 3."""

    def __reduce__(self):
        return os._exit, (3,)


def test_run_jobs_in_child_processes_reports_each_failure():
    def job(name, **kw):
        return dict(name=name, seed=1, max_fun_evals=20, deadline=None,
                    device="cpu", **kw)
    good, raises, dies = tbench.run_jobs(
        [job("smoothbox1"), job("no_such_block"), job("smoothbox1",
                                                      die=_Die())], 2)
    assert good["ok"] and good["func_count"] == 20 and good["name"] == \
        "smoothbox1" and good["launches_ok"] is None
    assert not raises["ok"] and "KeyError" in raises["error"]
    assert not dies["ok"] and "code 3" in dies["error"]


def _lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def test_main_with_a_budget_that_fits_no_stage(monkeypatch, capsys):
    monkeypatch.setenv("VBMC_BENCH_BUDGET_S", "1")
    monkeypatch.setenv("VBMC_BENCH_SEEDS", "2")
    monkeypatch.setenv("VBMC_BENCH_STRESS", "1")
    assert tbench.main(["--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 4
    last = lines[-1]
    assert last["metric"] == "selftest_speedup" and last["value"] is None
    assert last["unit"] == "x" and last["vs_baseline"] is None
    d = last["detail"]
    assert d["device"]["platform"] == d["device"]["kind"] == "cpu"
    assert d["dtype"] == "float64" and d["failed"] == []
    for stage in ("setup", "suite", "stress_d10", "seeds"):
        assert d[stage]["skipped"].startswith("budget exhausted"), stage


def test_main_exits_non_zero_over_a_failed_run(monkeypatch, capsys):
    def fake_run_block(blk, seed, max_fun_evals=100, device="cuda",
                       deadline=None):
        if blk["name"] == "halfnorm2" and seed == 2:
            raise FloatingPointError("a fault in the run")
        return dict(name=blk["name"], seed=seed, ok=True, cut=False,
                    elbo_err=0.1, rmse=0.1, func_count=max_fun_evals,
                    iters=5)

    monkeypatch.setattr(selftest, "run_block", fake_run_block)
    for knob, v in (("VBMC_BENCH_BUDGET_S", "1000"), ("VBMC_BENCH_BLOCKS",
                    "2"), ("VBMC_BENCH_PARALLEL", "0"),
                    ("VBMC_BENCH_STRESS", "0"), ("VBMC_BENCH_SEEDS", "0")):
        monkeypatch.setenv(knob, v)
    assert tbench.main(["--device", "cpu"]) == 1
    lines = _lines(capsys.readouterr().out)
    setup, d = lines[0]["detail"]["setup"], lines[-1]["detail"]
    assert setup["run"]["seed"] == 99 and setup["run"]["func_count"] == 30
    suite = d["suite"]
    assert suite["blocks"] == 2 and suite["accuracy_passed"] == 1
    assert [r["name"] for r in suite["runs"]] == ["mvn6", "halfnorm2"]
    assert "FloatingPointError: a fault in the run" in suite["runs"][1][
        "error"]
    assert d["failed"] == ["suite:halfnorm2@2"]
    assert lines[-1]["value"] == pytest.approx(
        80.0 / suite["elapsed_s"])
    assert suite["cold_total_s"] == pytest.approx(
        d["setup"]["setup_s"] + suite["elapsed_s"])


def test_the_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbench.main([])


@pytest.mark.parametrize("df", [3.0, 2.5])
def test_chi2_draws_have_the_chi2_law(df):
    """Both paths of `vp._chi2` (the sum of squared normals at a whole df,
    the gamma elsewhere) draw the chi-square law of the reference's one
    gamma path."""
    from vbmc_tpu_torch.vp import _chi2

    gen = torch.Generator().manual_seed(11)
    like = torch.zeros((), dtype=torch.float64)
    x = _chi2(gen, df, (20_000,), like).numpy()
    assert x.shape == (20_000,) and np.all(x > 0)
    assert scipy.stats.kstest(x, scipy.stats.chi2(df).cdf).pvalue > 1e-3


def test_runs_the_budget_cuts_short_are_not_failures(monkeypatch, capsys):
    def fake_run_block(blk, seed, max_fun_evals=100, device="cuda",
                       deadline=None):
        cut = deadline is not None and seed in (101, 115)
        return dict(name=blk["name"], seed=seed, ok=seed != 115, cut=cut,
                    elbo_err=9.0 if cut else 0.1, rmse=0.1,
                    func_count=max_fun_evals, iters=5)

    monkeypatch.setattr(selftest, "run_block", fake_run_block)
    for knob, v in (("VBMC_BENCH_BUDGET_S", "1000"), ("VBMC_BENCH_BLOCKS",
                    "2"), ("VBMC_BENCH_PARALLEL", "0"),
                    ("VBMC_BENCH_STRESS", "0"), ("VBMC_BENCH_SEEDS", "2")):
        monkeypatch.setenv(knob, v)
    assert tbench.main(["--device", "cpu"]) == 0
    seeds = _lines(capsys.readouterr().out)[-1]["detail"]["seeds"]
    assert (seeds["runs"], seeds["passed"], seeds["cut"]) == (4, 2, 2)
    assert [r["seed"] for r in seeds["results"]] == [101, 102, 114, 115]
    assert seeds["per_block"] == {"mvn6": "1/2", "halfnorm2": "1/2"}
    assert seeds["worst_elbo_err"] == 0.1
