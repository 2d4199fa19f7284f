"""The port's acceptance harness, the jax-free twin of the JAX package's
`bench.py`:

    python -m vbmc_tpu_torch.bench [--device cpu]

It runs on the card unless ``--device cpu`` is given; without a card the
default raises, and nothing moves to the CPU on its own. Its stages, each
printing one JSON line on stdout when it completes (so the last line is the
most complete; progress goes to stderr):

    {"metric": "selftest_speedup", "value": ..., "unit": "x",
     "vs_baseline": ..., "detail": {...}}

1. Set-up: build both kernels (`kernels.build_all`, on the card), then one
   short run, `bench.py`'s own CPU warm-up (block 2, seed 99, 30
   evaluations). ``detail["setup"]["setup_s"]`` is its seconds.
2. Suite: the six self-test blocks (`selftest.py`, the targets of
   `runtest_vbmc.m`) at 100 evaluations, seeds 1 to 6, each held to the
   reference's gate (|ELBO - lnZ| < 0.5, RMSE < 0.5, exit flag >= 0) and,
   on the card, to at least one launch of its sweep kernel per acquired
   point (`viqr_acq` for the noisy block, `prospective_acq` for the
   others). ``value`` is MATLAB's 240 s scaled to the blocks run, over the
   stage's wall seconds; ``cold_total_s`` adds the set-up's seconds.
3. Stress: `bench.run_stress_block`'s D=10 / K=50 block (seed 7, 300
   evaluations pinned by ``min_fun_evals``, ``min_final_components=50``),
   held to |ELBO| < 1, RMSE < 0.5 and a final K (``K_final``, after the
   boost) of at least 50; seconds per iteration (mean and median) against
   `BASELINE_D10.json`'s 148.84.
4. Seeds: n x 6 runs at seeds 101 + 13 s + i, accuracy only, each
   stopped at the budget's end: passed/runs, the runs the budget cut
   short (which neither pass nor fail), the tally per block, the worst
   |ELBO - lnZ| and RMSE of the runs that ran to their end.

Every line's ``detail`` names the device (`torch.cuda.get_device_name(0)`,
the device count, and the name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them), or
``cpu``, and the dtype, float64. On the card each run goes in a spawned
child process with one host thread (``VBMC_BENCH_PARALLEL=0``: all in
sequence in this process, the default on the CPU); a run that raises or
whose process dies is a failed run with its error text.

Environment, as `bench.py` reads it: ``VBMC_BENCH_BUDGET_S`` (default 1380
s from process start; a stage that no longer fits is skipped with a note),
``VBMC_BENCH_BLOCKS`` (the first n blocks), ``VBMC_BENCH_STRESS`` (0 skips
stage 3), ``VBMC_BENCH_SEEDS`` (n; default 5 on the card, 0 on the CPU),
``VBMC_BENCH_PARALLEL`` (0, 1 or auto), ``VBMC_BENCH_PROGRESS`` (0
silences the per-iteration lines).

Exit code 0, or 1 when any run failed its gate, raised or died (after the
last line is printed); a run the budget cut short is reported as such, not
as failed.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import wait

import numpy as np

from vbmc_tpu_torch import selftest

T0 = time.monotonic()   # process start under `python -m`

# MATLAB's self-test: about 240 s for its 6 blocks of 100 evaluations on an
# i7-9750H (`test/runtest_vbmc.m:10-11`, copied as `bench.py:49-50`), a CPU
# measurement of the reference.
MATLAB_BASELINE_TOTAL = 240.0
MATLAB_BLOCKS = 6
# Seconds per iteration of the reference's D=10 hot loop at N=250, K=20
# (`BASELINE_D10.json` "s_per_iter": `tools/baseline_d10.py`, a NumPy
# transliteration of that loop, on a 2-core x86_64 CPU).
BASELINE_D10_S_PER_ITER = 148.84
STRESS_SEED, STRESS_EVALS = 7, 300
# The seconds a stage must have left to start, as `bench.py` keeps them:
# the suite the 240 its warm-up leaves the measured pass, the stress block
# 150, the seed sweep 240.
SUITE_MIN_S, STRESS_MIN_S, SEEDS_MIN_S = 240.0, 150.0, 240.0
MAX_SEED_WORKERS = 12
_JOIN_S = 60.0


def stress_block():
    """`bench.run_stress_block`'s D=10 / K=50 configuration as a block:
    the anisotropic 10-D Gaussian (lnZ 0), x0 0.5, plausible box +-4,
    ``min_fun_evals`` pinned to the budget (the s/iter baseline is taken at
    N=250 steady state) and ``min_final_components=50``."""
    D = 10
    sd = np.linspace(0.5, 2.0, D)

    def mvn10(x):
        return float(-0.5 * np.sum((x / sd) ** 2)
                     - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)))
    return dict(name="stress_d10", fun=mvn10, D=D, lnz=0.0,
                mean=np.zeros(D), x0=np.full(D, 0.5), lb=None, ub=None,
                plb=np.full(D, -4.0), pub=np.full(D, 4.0), noisy=False,
                options=dict(min_fun_evals=STRESS_EVALS,
                             min_final_components=50))


def _block(name):
    if name == "stress_d10":
        return stress_block()
    return {b["name"]: b for b in selftest._blocks()}[name]


def _failed(job, error):
    return dict(name=job["name"], seed=job["seed"], ok=False, cut=False,
                elbo_err=None, rmse=None, func_count=0, iters=0, error=error)


def run_job(job):
    """One run of a job (block name, seed, evaluations, deadline, device).
    This is the boundary that keeps the benchmark going: a run that raises
    comes back as a failed run with its error text, the traceback on
    stderr. On the card the run must also have launched its sweep kernel
    at least once per acquired point (``launches_ok``; None on the CPU)."""
    try:
        blk = _block(job["name"])
        r = selftest.run_block(blk, job["seed"], job["max_fun_evals"],
                               device=job["device"], deadline=job["deadline"])
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        return _failed(job, "".join(
            traceback.format_exception_only(type(e), e)).strip())
    r["launches_ok"] = None
    if job["device"] != "cpu":
        kernel = "viqr_acq" if blk["noisy"] else "prospective_acq"
        r["launches_ok"] = r["launches"][kernel] >= r["acquired"]
        r["ok"] = r["ok"] and r["launches_ok"]
    return r


def _child(job, conn):
    import torch

    # One host thread a process: with torch's default thread pools, a few
    # processes sharing the host ran about 20 times slower (PERF.md,
    # section 6).
    torch.set_num_threads(1)
    try:
        conn.send(run_job(job))
    finally:
        conn.close()


def run_jobs(jobs, workers):
    """Each job in its own spawned child process, at most ``workers`` at
    once; the results in the jobs' order. A child that raises reports a
    failed run (`run_job`); one that dies without a result is a failed run
    with its exit code."""
    ctx = mp.get_context("spawn")
    results = [None] * len(jobs)
    todo = list(enumerate(jobs))[::-1]
    running = {}
    try:
        while todo or running:
            while todo and len(running) < workers:
                i, job = todo.pop()
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(target=_child, args=(job, send),
                                   daemon=True)
                proc.start()
                send.close()
                running[recv] = (i, job, proc)
            for conn in wait(list(running)):
                i, job, proc = running.pop(conn)
                try:
                    results[i] = conn.recv()
                except EOFError:
                    proc.join(_JOIN_S)
                    results[i] = _failed(job, f"the child process exited "
                                              f"with code {proc.exitcode} "
                                              f"and no result")
                conn.close()
                proc.join(_JOIN_S)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    finally:
        for _, _, proc in running.values():
            proc.kill()
            proc.join()
    return results


def device_info(device):
    """The device a run's numbers belong to. On the card this raises
    without one."""
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=0, nvidia_smi=None,
                    power_limit=None)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("python -m vbmc_tpu_torch.bench runs on the card "
                           "unless --device cpu is given, and "
                           "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=smi,
                power_limit=smi.rsplit(",", 1)[-1].strip())


def _emit(value, detail):
    """One JSON line on stdout; the last one printed is the most complete."""
    print(json.dumps({"metric": "selftest_speedup", "value": value,
                      "unit": "x", "vs_baseline": value, "detail": detail}),
          flush=True)


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _worst(runs, key):
    vals = [r[key] for r in runs
            if r[key] is not None and np.isfinite(r[key])]
    return max(vals) if vals else None


def main(argv=None, t0=None):
    """Run the stages; returns the exit code. ``t0`` (a `time.monotonic()`)
    is where the budget starts: now unless given."""
    parser = argparse.ArgumentParser(
        prog="python -m vbmc_tpu_torch.bench",
        description="The port's acceptance harness (the twin of bench.py).")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = parser.parse_args(argv).device
    t0 = time.monotonic() if t0 is None else t0
    info = device_info(device)
    budget = float(os.environ.get("VBMC_BENCH_BUDGET_S", "1380"))
    blocks = selftest._blocks()
    names = [b["name"] for b in
             blocks[:int(os.environ.get("VBMC_BENCH_BLOCKS", len(blocks)))]]
    par = os.environ.get("VBMC_BENCH_PARALLEL", "auto")
    parallel = par == "1" if par in ("0", "1") else device != "cpu"
    n_seeds = int(os.environ.get("VBMC_BENCH_SEEDS",
                                 "0" if device == "cpu" else "5"))
    baseline_scaled = MATLAB_BASELINE_TOTAL * len(names) / MATLAB_BLOCKS

    def remaining():
        return budget - (time.monotonic() - t0)

    def job(name, seed, evals=100, deadline=None):
        return dict(name=name, seed=seed, max_fun_evals=evals,
                    deadline=deadline, device=device)

    def run(jobs, workers):
        if parallel:
            return run_jobs(jobs, workers)
        return [run_job(j) for j in jobs]

    failed = []
    value = None
    detail = dict(device=info, dtype="float64", budget_s=budget,
                  baseline_s_scaled=baseline_scaled, parallel=parallel,
                  failed=failed)

    def skip(stage):
        detail[stage] = {"skipped":
                         f"budget exhausted ({remaining():.0f}s left)"}
        detail["stage"] = stage
        _emit(value, detail)

    def stage_done(stage, runs):
        # A run the budget's deadline cut short has not failed its gate.
        failed.extend(f"{stage}:{r['name']}@{r['seed']}" for r in runs
                      if not (r["ok"] or r["cut"]))
        for r in runs:
            _log(f"{stage} {r['name']} seed {r['seed']}: ok={r['ok']} "
                 f"cut={r['cut']} elbo_err={r['elbo_err']} rmse={r['rmse']} "
                 f"fevals={r['func_count']} {r.get('error', '')}")
        detail["stage"] = stage
        _emit(value, detail)

    # 1. Set-up. `bench.py` warms up with a full same-seed pass of every
    # block to fill XLA's trace and compile caches; PyTorch has no such
    # cache, so a second pass would time nothing new. What a cold start
    # pays here is the kernels' build and each process's first run, which
    # this stage times once.
    setup_deadline = t0 + min(0.6 * budget, 900.0, budget - SUITE_MIN_S)
    setup_s = 0.0
    if time.monotonic() >= setup_deadline:
        skip("setup")
    else:
        _log(f">> set-up ({remaining():.0f}s left)")
        t = time.monotonic()
        if device != "cpu":
            from vbmc_tpu_torch import kernels
            kernels.build_all()
        r = run([job(names[1 % len(names)], 99, 30, setup_deadline)], 1)[0]
        setup_s = time.monotonic() - t
        detail["setup"] = dict(setup_s=setup_s, kernels_built=device != "cpu",
                               run=r)
        # Its gate is not held at 30 evaluations; a run that raised is a
        # failure all the same.
        if "error" in r:
            failed.append(f"setup:{r['name']}@{r['seed']}")
        stage_done("setup", [])

    # 2. The suite: every block at once, each in its own process.
    if remaining() < SUITE_MIN_S:
        skip("suite")
    else:
        _log(f">> suite of {len(names)} blocks ({remaining():.0f}s left)")
        t = time.monotonic()
        runs = run([job(n, i + 1) for i, n in enumerate(names)], len(names))
        elapsed = time.monotonic() - t
        value = baseline_scaled / elapsed
        detail["suite"] = dict(
            elapsed_s=elapsed, cold_total_s=setup_s + elapsed,
            cold_speedup=baseline_scaled / (setup_s + elapsed),
            blocks=len(runs), accuracy_passed=sum(r["ok"] for r in runs),
            runs=runs)
        stage_done("suite", runs)

    # 3. The D=10 / K=50 stress block. No warm pass, as at the set-up.
    if os.environ.get("VBMC_BENCH_STRESS", "1") == "1":
        if remaining() < STRESS_MIN_S:
            skip("stress_d10")
        else:
            _log(f">> stress block d10 ({remaining():.0f}s left)")
            r = run([job("stress_d10", STRESS_SEED, STRESS_EVALS)], 1)[0]
            if "error" not in r:
                r["ok"] = bool(r["elbo_err"] < 1.0 and r["rmse"] < 0.5
                               and r["K_final"] >= 50
                               and r["launches_ok"] is not False)
                r["baseline_s_per_iter"] = BASELINE_D10_S_PER_ITER
                r["speedup_d10"] = BASELINE_D10_S_PER_ITER / r["s_per_iter"]
                if r["s_per_iter_median"]:
                    r["speedup_d10_median"] = (BASELINE_D10_S_PER_ITER
                                               / r["s_per_iter_median"])
            detail["stress_d10"] = r
            stage_done("stress_d10", [r])

    # 4. The seed sweep, accuracy only; its runs stop at the budget.
    if n_seeds > 0:
        if remaining() < SEEDS_MIN_S:
            skip("seeds")
        else:
            jobs = [job(n, 101 + 13 * s + i, deadline=t0 + budget - 30.0)
                    for s in range(n_seeds) for i, n in enumerate(names)]
            workers = min(len(jobs), os.cpu_count() or 1, MAX_SEED_WORKERS)
            _log(f">> seed sweep: {len(jobs)} runs, {workers} at once "
                 f"({remaining():.0f}s left)")
            t = time.monotonic()
            runs = run(jobs, workers)
            # A run the budget cut short neither passes nor counts in
            # the worst errors.
            whole = [r for r in runs if not r["cut"]]
            per_block = {}
            for r in runs:
                tally = per_block.setdefault(r["name"], [0, 0])
                tally[0] += int(r["ok"] and not r["cut"])
                tally[1] += 1
            detail["seeds"] = dict(
                runs=len(runs), passed=sum(r["ok"] for r in whole),
                cut=len(runs) - len(whole),
                per_block={k: f"{p}/{n}" for k, (p, n) in per_block.items()},
                worst_elbo_err=_worst(whole, "elbo_err"),
                worst_rmse=_worst(whole, "rmse"),
                elapsed_s=time.monotonic() - t, workers=workers, results=[
                    {k: r.get(k) for k in ("name", "seed", "ok", "cut",
                                           "elbo_err", "rmse", "func_count",
                                           "iters", "elapsed_s", "error")}
                    for r in runs])
            stage_done("seeds", runs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(t0=T0))
