"""The self-test suite of the reference's `vbmc('test')`
(`test/runtest_vbmc.m`): six full runs against analytic targets with a
known log normaliser, each held to |ELBO - lnZ| < 0.5 and posterior-mean
RMSE < 0.5 with a non-negative exit flag.

The port's own copy of the blocks of `bench.py` (`_blocks`, `run_block`),
free of jax; `python -m vbmc_tpu_torch test` runs them, on the card unless
``--device cpu`` is given, and `python -m vbmc_tpu_torch.bench` (the twin
of `bench.py`) times them.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _blocks():
    """The six targets of `runtest_vbmc.m`."""
    blocks = []

    # 1) D=6 multivariate normal, unconstrained (runtest:17-26).
    D = 6
    sd6 = np.linspace(0.5, 1.5, D)

    def mvn6(x, sd=sd6, D_=D):
        return float(-0.5 * np.sum((x / sd) ** 2)
                     - 0.5 * D_ * np.log(2 * np.pi) - np.sum(np.log(sd)))
    blocks.append(dict(name="mvn6", fun=mvn6, D=6, lnz=0.0,
                       mean=np.zeros(6), x0=np.full(6, 0.3),
                       lb=None, ub=None, plb=np.full(6, -3.0),
                       pub=np.full(6, 3.0), noisy=False))

    # 2) D=2 half-normal, constrained (runtest:28-37).
    sd2 = np.array([1.0, 0.6])

    def halfnorm(x, sd=sd2):
        return float(-0.5 * np.sum((x / sd) ** 2)
                     - np.log(2 * np.pi) - np.sum(np.log(sd)))
    blocks.append(dict(name="halfnorm2", fun=halfnorm, D=2,
                       lnz=float(np.log(0.25)),
                       mean=sd2 * np.sqrt(2 / np.pi),
                       x0=np.array([0.5, 0.5]), lb=np.zeros(2),
                       ub=np.full(2, 10.0), plb=np.full(2, 0.05),
                       pub=np.full(2, 3.0), noisy=False))

    # 3) D=3 correlated "cigar" normal, unconstrained (runtest:39-47).
    D = 3
    rng = np.random.default_rng(0)
    A = rng.standard_normal((D, D))
    Q, _ = np.linalg.qr(A)
    scales = np.array([2.0, 0.5, 0.1])
    cov3 = Q @ np.diag(scales ** 2) @ Q.T
    prec3 = np.linalg.inv(cov3)
    lognorm3 = -0.5 * D * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(cov3)[1]

    def cigar(x, P=prec3, ln=lognorm3):
        return float(-0.5 * x @ P @ x + ln)
    blocks.append(dict(name="cigar3", fun=cigar, D=3, lnz=0.0,
                       mean=np.zeros(3), x0=np.full(3, 0.25),
                       lb=None, ub=None, plb=np.full(3, -4.0),
                       pub=np.full(3, 4.0), noisy=False))

    # 4) D=3 cigar, constrained (runtest:49-57): the box [-5, 5]^3 holds
    # essentially all the mass, so lnZ ~ 0.
    def cigar_c(x, P=prec3, ln=lognorm3):
        return float(-0.5 * x @ P @ x + ln)
    blocks.append(dict(name="cigar3_box", fun=cigar_c, D=3, lnz=0.0,
                       mean=np.zeros(3), x0=np.full(3, 0.25),
                       lb=np.full(3, -5.0), ub=np.full(3, 5.0),
                       plb=np.full(3, -4.0), pub=np.full(3, 4.0),
                       noisy=False))

    # 5) D=2 noisy half-normal (sigma=1 additive noise, runtest:59-67),
    # the noise stream made per run from the run's seed.
    def make_noisy(seed, sd=sd2):
        nr = np.random.default_rng(1000 + seed)

        def halfnorm_noisy(x):
            y = (-0.5 * np.sum((x / sd) ** 2)
                 - np.log(2 * np.pi) - np.sum(np.log(sd)))
            return float(y + nr.standard_normal()), 1.0
        return halfnorm_noisy
    blocks.append(dict(name="halfnorm2_noisy", make_fun=make_noisy, D=2,
                       lnz=float(np.log(0.25)),
                       mean=sd2 * np.sqrt(2 / np.pi),
                       x0=np.array([0.5, 0.5]), lb=np.zeros(2),
                       ub=np.full(2, 10.0), plb=np.full(2, 0.05),
                       pub=np.full(2, 3.0), noisy=True))

    # 6) D=1 smooth box: flat inside [-1, 1], Gaussian falloff outside
    # (runtest:69-78).
    def unif1(x):
        s = 0.2
        lo, hi = -1.0, 1.0
        v = x[0]
        if v < lo:
            return float(-0.5 * ((v - lo) / s) ** 2 - np.log(hi - lo + s * np.sqrt(2 * np.pi)))
        if v > hi:
            return float(-0.5 * ((v - hi) / s) ** 2 - np.log(hi - lo + s * np.sqrt(2 * np.pi)))
        return float(-np.log(hi - lo + s * np.sqrt(2 * np.pi)))
    blocks.append(dict(name="smoothbox1", fun=unif1, D=1, lnz=0.0,
                       mean=np.zeros(1), x0=np.zeros(1),
                       lb=None, ub=None, plb=np.full(1, -2.0),
                       pub=np.full(1, 2.0), noisy=False))
    return blocks


def run_block(blk, seed, max_fun_evals=100, device="cuda", deadline=None):
    """One full VBMC run of a block on ``device``, its progress on stderr
    (``VBMC_BENCH_PROGRESS=0`` silences it). ``deadline`` (an absolute
    `time.monotonic()`) stops the run after the iteration in which it
    passes, through the ``output_fcn`` stop protocol, as in
    `bench.run_block` (``cut`` then says so). A block may carry
    ``options``, VBMCOptions fields that replace the suite's own
    (``min_final_components=20``).

    Returns the reference's gate (|ELBO - lnZ| < 0.5, posterior-mean RMSE
    < 0.5, exit flag >= 0) with its values, the components ``K`` of the
    best iteration's VP before the final boost (`bench.py`'s K,
    ``res.vp_train``) and ``K_final`` of the final, boosted VP, and what
    each layer of the run cost: ``timers`` (`VBMCResult.timers`), the
    seconds of each iteration (``s_per_iter``, ``s_per_iter_median``), the
    sweep kernels' launches during the run (``launches``, the difference of
    the wrappers' counters: 0 on the CPU, where the wrappers run their
    plain versions), the acquired points and, on the card, the peak device
    memory in MiB (after `torch.cuda.reset_peak_memory_stats`). Unlike
    `bench.run_block`, a failure in the run raises instead of being
    reported as a failed block."""
    import torch

    from vbmc_tpu_torch import kernels, vbmc, VBMCOptions, vp_moments
    t_blk = time.monotonic()
    print(f"# >> block {blk['name']} start", file=sys.stderr, flush=True)
    progress = os.environ.get("VBMC_BENCH_PROGRESS", "1") == "1"
    iter_ends = [t_blk]
    cut = False

    def _hook(info):
        nonlocal cut
        iter_ends.append(time.monotonic())
        if progress:
            print(f"#    {blk['name']} iter {info['iteration']:3d} "
                  f"fc={info['func_count']:3d} elbo={info['elbo']:8.3f} "
                  f"K={info['K']:3d} t={time.monotonic() - t_blk:7.1f}s "
                  f"timer={info.get('timer')}", file=sys.stderr, flush=True)
        cut = deadline is not None and time.monotonic() > deadline
        return cut

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sweeps = (kernels.prospective_acq, kernels.viqr_acq)
    launches0 = [k.launches for k in sweeps]
    fields = {"min_final_components": 20, **blk.get("options", {})}
    opts = VBMCOptions(display="off", max_fun_evals=max_fun_evals,
                       seed=seed, specify_target_noise=blk["noisy"],
                       output_fcn=_hook, **fields)
    fun = blk["make_fun"](seed) if "make_fun" in blk else blk["fun"]
    res = vbmc(fun, x0=blk["x0"], lb=blk["lb"], ub=blk["ub"],
               plb=blk["plb"], pub=blk["pub"], options=opts, device=device)
    elapsed = time.monotonic() - t_blk
    launches = {k.name: k.launches - n0 for k, n0 in zip(sweeps, launches0)}
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if on_card else None)
    gen = torch.Generator(device=res.vp.mu.device).manual_seed(0)
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    err_elbo = abs(res.elbo - blk["lnz"])
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - blk["mean"]) ** 2)))
    ok = (res.exitflag >= 0) and err_elbo < 0.5 and rmse < 0.5
    iter_s = np.diff(iter_ends)
    start = opts.resolve(blk["D"]).fun_eval_start
    return dict(name=blk["name"], seed=seed, ok=bool(ok), cut=cut,
                elbo=float(res.elbo), elbo_err=float(err_elbo), rmse=rmse,
                exitflag=int(res.exitflag), func_count=res.func_count,
                iters=res.iterations,
                acquired=res.func_count - start,
                K=int(res.vp_train.kmask.sum()),
                K_final=int(res.vp.kmask.sum()), launches=launches,
                timers=dict(res.timers), peak_device_mib=peak_mib,
                s_per_iter=elapsed / max(res.iterations, 1),
                s_per_iter_median=(float(np.median(iter_s)) if iter_s.size
                                   else None),
                elapsed_s=elapsed)
