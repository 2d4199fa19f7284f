"""Benchmark of `vbmc_tpu_torch.vbmc`, the PyTorch and CUDA port of VBMC,
on one NVIDIA GPU:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. A cell of ``BENCHMARK.json`` names a
configuration (``benchmark/configs/<name>.json``, with its target and truth
in ``<name>.py``) and a traffic mix (``benchmark/traffic/<name>.json``);
each metric is read by ``benchmark/metrics/<name>.py``.

One run drives the served path in one process: set-up (the kernels loaded
or built into the checkout's ``build/``, the target, its starting points,
and `vbmc` through its initial design and first iteration), then the window
(the iterations until ``--seconds`` have passed, stopped through
``output_fcn``; it opens after the first iteration, or where the traffic
says so after the first that reports warm-up over), then `vbmc`'s own finish. After the window the run's
device peak is read, the program's state is copied to the host and freed,
and the plain reference (`benchmark/correct.py`) judges what the timed path
produced. The last line of standard output is one JSON object: ``correct``,
``attempted`` (points acquired in the window), ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also close standard error.

Exits 2 without a CUDA device (or with fewer than the cell asks for), 3 if
a JAX module was loaded, and with an exception's code if the run raised.
"""

from __future__ import annotations

import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vbmc_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name, spec=None):
    """(workload entry, configuration entry, BENCHMARK.json) of a cell."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    return wl, conf, spec


def metric_names(spec, cell, trace):
    """The cell's end-to-end metrics, or its per-layer ones when traced."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, device, chips, trace_summary):
    if device == "cpu":
        info = dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    else:
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    if trace_summary is not None:
        info["busy_s"] = trace_summary["busy_s"]
        info["window_s"] = trace_summary["window_s"]
    return info


def peak_of(kind):
    for key, val in load_json(HERE / "peaks.json").items():
        if isinstance(val, dict) and key in kind:
            return val
    return None


def run_cell(cell, seed, seconds, trace, device="cuda", dtype=None,
             tweak=None, log=sys.stderr, spec=None, limits=None):
    """One run of a cell; returns (result dict, checks). ``dtype``
    replaces the configuration's (the lower-precision control); ``tweak``
    (a function of the configuration and traffic dicts) shrinks a run for
    the CPU tests, which may also give a ``spec`` in place of
    ``BENCHMARK.json`` and ``limits`` in place of the cell's file."""
    wl, conf, spec = cell_spec(cell, spec)
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    if tweak is not None:
        tweak(cfg, traffic)
    cmod = load_module(ROOT / conf["file"].replace(".json", ".py"))

    import torch

    from benchmark import correct, generator
    from benchmark.hooks import Recorder

    torch.set_num_threads(1)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            raise SystemExit(2)
        from vbmc_tpu_torch import kernels
        kernels.prospective_acq.load()
        kernels.viqr_acq.load()
        torch.cuda.reset_peak_memory_stats()
    from vbmc_tpu_torch import VBMCOptions, vbmc

    # the truth serves the starting points and the answer, where a traffic
    # mix uses them
    truth = (cmod.truth(cfg) if traffic["n_start"] or traffic["answer"]
             else None)
    x0 = generator.starting_points(cfg, truth, traffic, seed)
    lb, ub, plb, pub = generator.bounds(cfg)
    rec = Recorder(seconds, trace, seed, t0=T_PROC0,
                   opens=traffic.get("window_opens", "first_iteration"))
    dt = getattr(torch, dtype or cfg["dtype"])
    opts = VBMCOptions(display="off", seed=seed, output_fcn=rec.output_fcn,
                       **generator.options(cfg, traffic))
    with rec.installed():
        res = vbmc(rec.wrap_target(cmod.make_target(cfg)), x0=x0,
                   lb=None if cfg["lb"] is None else lb,
                   ub=None if cfg["ub"] is None else ub, plb=plb, pub=pub,
                   options=opts, device=device, dtype=dt)
        rec.close()
    t_return = time.monotonic()
    w0, w1 = rec.window
    if w0 is None:
        raise RuntimeError("the run ended before its window opened")
    win_iters = [it for it in rec.iters if w0 < it["t"] <= w1]
    if not win_iters:
        raise RuntimeError("the run ended before its window held an "
                           "iteration")
    in_win = [c for c in rec.calls if c[0] >= w0 and c[1] <= w1]
    timers = {}
    for it in win_iters:
        for k, v in it["timer"].items():
            timers[k] = timers.get(k, 0.0) + v
    summary = None
    if trace:
        from benchmark import trace as trace_mod
        summary = trace_mod.read(rec)
    info = device_info(torch, device, wl["chips"], summary)
    # what a metric reader may read (finish_s, iterations: for readers to
    # come)
    run = dict(setup_s=w0 - T_PROC0, finish_s=t_return - w1,
               window_s=w1 - w0, points=len(in_win),
               target_s=sum(c[1] - c[0] for c in in_win), timers=timers,
               quick_updates=sum(n for t, n in rec.quick if w0 < t <= w1),
               sweeps=rec.sweeps, trace=summary,
               peak=peak_of(info["kind"]), iterations=len(win_iters))
    if run["points"] == 0:
        raise RuntimeError("no point was acquired in the window")

    # the comparison, on the host, after the program's state is freed
    cap = correct.capture(rec, res)
    calls = rec.calls
    del res, rec
    if device == "cuda":
        torch.cuda.empty_cache()
    lim_path = HERE / "limits" / f"{cell}.json"
    if limits is None:
        limits = {}
        if lim_path.exists():
            limits = {k: v for k, v in load_json(lim_path).items()
                      if k != "readings"}
    box = (lb, ub) + generator.plausible_box(cfg, x0)
    checks = correct.judge(cap, calls, box, cfg, truth, traffic["answer"],
                           limits, seed)
    ok = correct.verdict(checks)

    metrics = {}
    for m in metric_names(spec, cell, trace):
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    out = dict(correct=bool(ok), attempted=run["points"],
               failed=0 if ok else run["points"], metrics=metrics,
               device=info)
    if summary is not None:
        out["breakdown"] = dict(device_ops=summary["device_ops"],
                                idle_gaps=summary["idle_gaps"])
    print(f"# {cell} seed {seed}: {run['iterations']} iterations, "
          f"{run['points']} points in {run['window_s']:.3f} s, target "
          f"{run['target_s']:.3f} s, timers {timers}", file=log)
    return out, checks


def _num(v):
    """A number for the JSON line: non-finite values as strings."""
    return v if math.isfinite(v) else str(v)


def result_line(out, checks):
    """Print each number compared with its limit as the last lines of
    standard error, and return the result's JSON line with ``checks``
    last."""
    from benchmark.correct import compared

    checks = compared(checks)
    out = dict(out)
    out["checks"] = {k: dict(value=_num(c["value"]), limit=c["limit"])
                     for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread, set before NumPy and torch are imported: a steadier
    # load than a pool that competes with the launches
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        out, checks = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    except SystemExit as e:
        if e.code == 2:
            print("benchmark: needs a CUDA device (torch.cuda.is_available() "
                  "and enough of them for the cell)", file=sys.stderr)
        raise
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    print(result_line(out, checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
