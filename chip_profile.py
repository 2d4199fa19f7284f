#!/usr/bin/env python3
"""How busy the GPU is during a short `vbmc` run of the PyTorch port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_profile.py [--target mvn_6d|halfnorm2_noisy] [--evals N]
    python3 chip_profile.py --kernel-phases

It builds the sweep kernels, then runs `vbmc_tpu_torch.vbmc` on one target
of `chip_smoke.py` twice in one process: once plainly, then under
`torch.profiler` with CUDA activity only. The targets: the 6-D Gaussian
(seed 3; the noiseless path) and the noisy 2-D half-normal (seed 1, the
target returns its value and SD 1; the noisy path). From the profiled run's
device events (kernels, copies, sets) it reports their number, the union of
their intervals ("busy"), the busy share of the profiled run's own wall time
(measured), and busy over the plain run's wall time (an estimate across the
two runs, since the profiler slows the host but not the device), with the
five names that took the most device time. Device time is read from the raw
kineto events: a run makes millions of them, too many for
`key_averages()` to finish in minutes.

With `--kernel-phases` it profiles the two sweep kernels instead: it builds
them with `-DVBMC_PROFILE`, launches each at the
shapes of `chip_smoke.py` (N=128 like the main paths' last GPs, N=256,
N=512, N=1024) and prints, per launch, the cycles each phase of pass 1 took
summed over blocks, as shares, beside the launch's time by CUDA events (the
marks cost a few percent). The phases are those of `csrc/gp_tile.cuh`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def run(torch, target, evals):
    from vbmc_tpu_torch import VBMCOptions, vbmc

    if target == "mvn_6d":
        D = 6
        sd = np.linspace(0.6, 1.4, D)
        lnz = 1.7

        def logp(x):
            return (-0.5 * np.sum((x / sd) ** 2) - 0.5 * D * np.log(2 * np.pi)
                    - np.sum(np.log(sd)) + lnz)

        kw = dict(x0=np.full(D, 0.3), plb=np.full(D, -4.0),
                  pub=np.full(D, 4.0),
                  options=VBMCOptions(display="off", max_fun_evals=evals,
                                      seed=3, min_final_components=20))
    else:
        D, seed = 2, 1
        sd = np.array([1.0, 0.6])
        noise = np.random.default_rng(1000 + seed)

        def logp(x):
            y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
                 - np.sum(np.log(sd)))
            return float(y + noise.standard_normal()), 1.0

        kw = dict(x0=np.array([0.5, 0.5]), lb=np.zeros(D),
                  ub=np.full(D, 10.0), plb=np.full(D, 0.05),
                  pub=np.full(D, 3.0),
                  options=VBMCOptions(display="off", max_fun_evals=evals,
                                      seed=seed, min_final_components=20,
                                      specify_target_noise=True))
    t = time.monotonic()
    res = vbmc(logp, device="cuda", dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    return res, time.monotonic() - t


def busy_union_s(intervals):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


# (N, S, K, M, D): like the noiseless and the noisy main path's last GPs,
# then the mid, an upper and the top bucket.
PHASE_SHAPES = ((128, 16, 8, 8192, 6), (128, 8, 8, 8192, 2),
                (256, 16, 16, 8192, 6), (512, 16, 16, 8192, 6),
                (1024, 80, 64, 8192, 10))


def kernel_phases(torch, smi):
    """Both kernels, built with the cycle marks, at PHASE_SHAPES in
    float64: one JSON line per launch."""
    import chip_smoke as cs
    from vbmc_tpu_torch import kernels

    kernels.build_all(profile=True)
    for (N, S, K, M, D) in PHASE_SHAPES:
        cfg, gp, vp, Xs, ymax, tol = cs.make_case(torch, N, S, K, M, D)
        calls = [(kernels.prospective_acq, lambda: kernels.prospective_acq(
            cfg, Xs, gp, vp, ymax, tol, True))]
        cfg_n, gp_n, vp_n, Xs_n, _, _ = cs.make_case(torch, N, S, K, M, D,
                                                     noisy=True)
        ais, sn2c = cs.viqr_inputs(torch, cfg_n, gp_n, vp_n, Xs_n)
        calls.append((kernels.viqr_acq, lambda: kernels.viqr_acq(
            cfg_n, Xs_n, gp_n, ais, sn2c, tol, True)))
        for kern, call in calls:
            kern.load(profile=True)
            ms = cs.cuda_time_ms(torch, call)
            kern.read_phases(reset=True)
            call()
            cycles = kern.read_phases(reset=True)
            total = sum(cycles.values())
            print(json.dumps({
                "device": smi, "kernel": kern.name,
                "shape": dict(N=N, S=S, K=K, M=M, D=D,
                              Na=ais.Xa.shape[0]),
                "ms": ms, "block_cycles_total": total,
                "share": {k: round(v / total, 4)
                          for k, v in cycles.items()}}), flush=True)
        del gp, vp, Xs, gp_n, vp_n, Xs_n, ais, sn2c, calls
        torch.cuda.empty_cache()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", choices=("mvn_6d", "halfnorm2_noisy"),
                    default="mvn_6d")
    ap.add_argument("--evals", type=int, default=35,
                    help="max_fun_evals of each run (default 35; the options "
                         "raise it to min_fun_evals, 35 at D=6)")
    ap.add_argument("--kernel-phases", action="store_true",
                    help="profile the phases of the two sweep kernels "
                         "instead of a run")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    if args.kernel_phases:
        return kernel_phases(torch, smi)
    from vbmc_tpu_torch import kernels
    kernels.build_all()
    kernels.prospective_acq.load()
    kernels.viqr_acq.load()

    res, plain_s = run(torch, args.target, args.evals)
    print(f"plain run: {plain_s:.3f} s, {res.func_count} evaluations",
          flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, prof_s = run(torch, args.target, args.evals)
    print(f"profiled run: {prof_s:.3f} s, {res.func_count} evaluations",
          flush=True)

    intervals, by_name = [], defaultdict(int)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        s, d = ev.start_ns(), ev.duration_ns()
        intervals.append((s, s + d))
        by_name[ev.name()] += d
    busy = busy_union_s(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({
        "device": smi, "target": args.target, "evals": res.func_count,
        "timers": {k: round(v, 3) for k, v in res.timers.items()},
        "device_events": len(intervals),
        "device_busy_s": busy,
        "device_sum_s": sum(by_name.values()) / 1e9,
        "profiled_wall_s": prof_s, "plain_wall_s": plain_s,
        "busy_share_of_profiled_wall": busy / prof_s,
        "busy_over_plain_wall_estimate": busy / plain_s,
        "mean_event_us": sum(by_name.values()) / max(len(intervals), 1) / 1e3,
        "top": [[name[:80], ns / 1e9] for name, ns in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
