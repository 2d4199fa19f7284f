#!/usr/bin/env python3
"""Drive the PyTorch port (`vbmc_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). Exits 2 without CUDA: there is no CPU fallback.
2. Build: compile both kernel sources (`vbmc_tpu_torch/csrc/*.cu`) with
   nvcc, one process each, started together.
3. Each kernel against its plain PyTorch version on the card, float64 and
   float32, with CUDA-event times of both:
   - `prospective_acq` at N=256 S=16 K=16 M=8192 D=6 and N=1024 S=80 K=64
     M=8192 D=10, with Binv from a real GP factorisation;
   - `viqr_acq` at N=256 S=16 K=16 M=8192 D=6 and N=1024 S=80 K=64 M=8192
     D=10, with a real GP with user noise and a real importance-sampling
     set (Na = 298 at the default option values).
4. The noiseless path: `vbmc(..., device="cuda", dtype=torch.float64)` on a
   6-D Gaussian (ensemble hyperparameter sampler) and a correlated 3-D cigar
   (rotoscale warping), each held to |ELBO - lnZ| < 0.5 and posterior-mean
   RMSE < 0.5; `prospective_acq` must have launched at least once per
   acquired point. Then that kernel at the shapes of the 6-D run's last GP.
5. The noisy path: the same call with `specify_target_noise=True` on the
   2-D half-normal with sigma=1 additive noise (the target returns its
   value and SD 1), held to the same gate; `viqr_acq` must have launched at
   least once per acquired point and at least one per-point full update
   must have run. Then that kernel at the shapes of the run's last GP.
6. A JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

The launch counts of a path are set to 0 just before it runs and read just
after; the comparisons' own launches do not count. The script imports
only the port (`vbmc_tpu_torch`), torch and numpy.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# float64: the kernel against the plain version, and the same argmin.
F64_TOL = {"prospective_acq": (1e-6, 1e-12), "viqr_acq": (1e-6, 1e-9)}
# float32: fs2 = sf2 - qf cancels (qf is close to sf2 near the training
# points), so acq carries a relative error of about eps32 * sf2 / vtot in
# ANY float32 implementation, and two float32 implementations disagree by
# that much. The kernel's float32 result is therefore held to the float64
# truth on the same inputs, and must be no worse than twice the error of
# PyTorch's own float32 plain version (plus 1e-6 of max |acq|).
F32_VS_PLAIN = 2.0
NA_DEFAULT = 3 * 66 + 100   # IS set size at the default option values


def log(msg: str):
    print(msg, flush=True)


def phase_env(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    return smi


def _hyps(cfg, rng, S, D):
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8 * np.sqrt(D)) + 0.05 * rng.standard_normal((S, D))
    hyps[:, D] = 0.1 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.05)
    i_m = cfg.ncov + cfg.nnoise
    hyps[:, i_m] = 0.3
    hyps[:, i_m + 1 + D:] = np.log(1.2 * np.sqrt(D))
    return hyps


def make_case(torch, N, S, K, M, D, seed=0, noisy=False):
    """Kernel inputs from a numpy seed: a real build_gp (with user noise
    variances of about 1 when ``noisy``), a K-component VP and M
    candidates."""
    from vbmc_tpu_torch.gp.config import GPConfig
    from vbmc_tpu_torch.gp.gp import gp_from_host
    from vbmc_tpu_torch.transforms import create_trinfo
    from vbmc_tpu_torch.vp import make_vp

    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, user_noise=1 if noisy else 0)
    X = rng.uniform(-2, 2, (N, D))
    y = -0.5 * np.sum(X ** 2, 1)
    s2 = None
    if noisy:
        y = y + rng.standard_normal(N)
        s2 = rng.uniform(0.8, 1.2, N)
    gp = gp_from_host(cfg, X, y, s2, _hyps(cfg, rng, S, D), n_bucket=N,
                      s_bucket=S, device="cuda", dtype=torch.float64)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                           [2.0] * D, device="cuda", dtype=torch.float64)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)), 0.4 + 0.2 * rng.random(K),
                 np.ones(D), w=w / w.sum(), k_max=K)
    Xs = torch.as_tensor(rng.uniform(-2.5, 2.5, (M, D)), device="cuda")
    return cfg, gp, vp, Xs, 0.7, 1e-4


def viqr_inputs(torch, cfg, gp, vp, Xs, seed=0):
    """A real importance-sampling set at the default option values and the
    nearest-noise estimate at Xs: the inputs `sweep_is_acquisition` gives
    the kernel."""
    from vbmc_tpu_torch.acquisitions import AcqState, _nearest_noise
    from vbmc_tpu_torch.active_is import build_is_state_core

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        ais = build_is_state_core(gen, cfg, "viqr", vp, gp, 100, 100, 100,
                                  mh_steps=3, fess_thresh=0.9)
        hm = gp.hyp_mask.to(gp.hyp.dtype)
        gls = torch.exp((gp.hyp[:, :cfg.D] * hm[:, None]).sum(0) / hm.sum())
        dev = torch.full((cfg.D,), np.inf, device="cuda", dtype=Xs.dtype)
        state = AcqState(ymax=None, tol_var=None, lb_eps_orig=-dev,
                         ub_eps_orig=dev, gp_length_scale=gls)
        sn2c = _nearest_noise(cfg, gp, Xs, state)
    return ais, sn2c


def cast_tree(torch, obj, dtype):
    """A copy of a dataclass with its floating-point tensors (recursively
    through nested dataclasses) cast to dtype."""
    import dataclasses

    def cast(v):
        if dataclasses.is_dataclass(v):
            return cast_tree(torch, v, dtype)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(dtype)
        return v

    return dataclasses.replace(obj, **{
        f.name: cast(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if f.init})


def cuda_time_ms(torch, fn, repeats=7, inner=3):
    """Median over repeats of the mean time of ``inner`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def compare(torch, name, tag, kernel, plain, gflop, truth=None):
    """A kernel (``kernel()`` calls its wrapper) against its plain version
    (``plain()``) on the same inputs; asserts the tolerance and returns the
    numbers. ``truth``: the float64 plain result on the same inputs, for a
    float32 case. ``gflop``: the kernel's product work."""
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    dt = ref.dtype
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{name} {tag}: non-finite acquisition values")
    err = (got - ref).abs()
    max_abs = float(err.max())
    scale = float(ref.abs().max())
    max_rel = float((err / ref.abs().clamp_min(torch.finfo(dt).tiny)).max())
    same_argmin = int(got.argmin()) == int(ref.argmin())
    if dt == torch.float64:
        rtol, atol = F64_TOL[name]
        ok = bool(torch.allclose(got, ref, rtol=rtol, atol=atol))
        rule = f"rtol {rtol} atol {atol} and same argmin"
        ok = ok and same_argmin
    else:
        err_k = float((got.double() - truth).abs().max())
        err_p = float((ref.double() - truth).abs().max())
        ok = err_k <= F32_VS_PLAIN * err_p + 1e-6 * float(truth.abs().max())
        rule = (f"vs float64 truth: kernel {err_k:.3e} <= {F32_VS_PLAIN} x "
                f"plain {err_p:.3e} + 1e-6 max|acq|")
    ms = cuda_time_ms(torch, kernel)
    plain_ms = cuda_time_ms(torch, plain, repeats=5, inner=1)
    log(f"[kernel] {name} {tag}: max_abs_err {max_abs:.3e} max_rel_err "
        f"{max_rel:.3e} max|acq| {scale:.3e} argmin_equal {same_argmin} "
        f"({rule}): {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms "
        f"({gflop / ms:.1f} TFLOP/s on {gflop:.2f} GFLOP), plain "
        f"{plain_ms:.3f} ms")
    if not ok:
        raise AssertionError(f"{name} {tag}: kernel disagrees with plain "
                             f"version")
    return dict(tag=tag, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                plain_ms=plain_ms, argmin_equal=same_argmin, ref=ref)


def compare_prospective(torch, kernels, tag, cfg, gp, vp, Xs, ymax, tol_var,
                        truth=None):
    N, S = gp.X.shape[0], gp.hyp.shape[0]
    return compare(
        torch, "prospective_acq", tag,
        lambda: kernels.prospective_acq(cfg, Xs, gp, vp, ymax, tol_var, True),
        lambda: kernels.prospective_acq_reference(cfg, Xs, gp, vp, ymax,
                                                  tol_var, True),
        2.0 * S * Xs.shape[0] * N * N / 1e9, truth)


def compare_viqr(torch, kernels, tag, cfg, gp, ais, sn2c, Xs, tol_var,
                 truth=None):
    N, S = gp.X.shape[0], gp.hyp.shape[0]
    Na = ais.Xa.shape[0]
    return compare(
        torch, "viqr_acq", tag,
        lambda: kernels.viqr_acq(cfg, Xs, gp, ais, sn2c, tol_var, True),
        lambda: kernels.viqr_acq_reference(cfg, Xs, gp, ais, sn2c, tol_var,
                                           True),
        2.0 * S * Xs.shape[0] * N * (N + Na) / 1e9, truth)


def phase_kernels(torch, kernels):
    """Both kernels against their plain versions at two shapes each, in
    float64 and float32. Returns {kernel name: [results]}."""
    out = {"prospective_acq": [], "viqr_acq": []}
    for (N, S, K, M, D) in ((256, 16, 16, 8192, 6), (1024, 80, 64, 8192, 10)):
        shape = f"N={N} S={S} K={K} M={M} D={D}"
        cfg, gp, vp, Xs, ymax, tol_var = make_case(torch, N, S, K, M, D)
        r64 = compare_prospective(torch, kernels, f"{shape} float64", cfg, gp,
                                  vp, Xs, ymax, tol_var)
        r32 = compare_prospective(
            torch, kernels, f"{shape} float32", cfg,
            cast_tree(torch, gp, torch.float32),
            cast_tree(torch, vp, torch.float32), Xs.float(), ymax, tol_var,
            truth=r64["ref"])
        out["prospective_acq"] += [r64, r32]
        del gp, vp, Xs
        for r in out["prospective_acq"]:
            r.pop("ref", None)
        torch.cuda.empty_cache()

        cfg, gp, vp, Xs, _, tol_var = make_case(torch, N, S, K, M, D,
                                                noisy=True)
        ais, sn2c = viqr_inputs(torch, cfg, gp, vp, Xs)
        shape = f"N={N} S={S} K={K} M={M} D={D} Na={ais.Xa.shape[0]}"
        r64 = compare_viqr(torch, kernels, f"{shape} float64", cfg, gp, ais,
                           sn2c, Xs, tol_var)
        r32 = compare_viqr(
            torch, kernels, f"{shape} float32", cfg,
            cast_tree(torch, gp, torch.float32),
            cast_tree(torch, ais, torch.float32), sn2c.float(), Xs.float(),
            tol_var, truth=r64["ref"])
        out["viqr_acq"] += [r64, r32]
        del gp, vp, Xs, ais, sn2c
        for r in out["viqr_acq"]:
            r.pop("ref", None)
        torch.cuda.empty_cache()
    return out


def run_target(torch, kernels, kernel, name, logp, D, x0, lnz, mean_true,
               options, lb=None, ub=None, plb=None, pub=None):
    """One `vbmc` run on the card, held to the gate. ``kernel``: the launch
    counter the run must advance at least once per acquired point."""
    from vbmc_tpu_torch.main import vbmc
    from vbmc_tpu_torch.vp import vp_moments

    torch.cuda.reset_peak_memory_stats()
    kernels.prospective_acq.launches = 0
    kernels.viqr_acq.launches = 0
    t = time.monotonic()
    res = vbmc(logp, x0=x0, lb=lb, ub=ub, plb=plb, pub=pub, options=options,
               device="cuda", dtype=torch.float64)
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    launches = {"prospective_acq": kernels.prospective_acq.launches,
                "viqr_acq": kernels.viqr_acq.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    mean = mean.cpu().numpy()
    err = abs(res.elbo - lnz)
    rmse = float(np.sqrt(np.mean((mean - mean_true) ** 2)))
    acquired = res.func_count - options.resolve(D).fun_eval_start
    ok = (err < 0.5 and rmse < 0.5 and np.isfinite(res.elbo)
          and launches[kernel] >= acquired > 0)
    log(f"[e2e] {name}: elbo {res.elbo:.4f} (lnZ {lnz:.4f}, err {err:.4f}) "
        f"elbo_sd {res.elbo_sd:.4f} rmse {rmse:.4f} func_count "
        f"{res.func_count} iterations {res.iterations} seconds {secs:.1f} "
        f"peak_device_MiB {peak_mib:.1f} kernel_launches {launches} "
        f"acquired_points {acquired} quick_updates {res.quick_updates} "
        f"warps_made {res.warps_made} warps_undone {res.warps_undone} timers "
        f"{ {k: round(v, 2) for k, v in res.timers.items()} }: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: end-to-end gate failed")
    return res, launches[kernel], secs


def _candidates(torch, res, D):
    """A real 2^13 candidate set around the last VP of a run."""
    from vbmc_tpu_torch.active_sample import _gen_candidates

    gp_last = res.stats.iterations[-1].gp
    vp_last = res.stats.iterations[-1].vp
    gen = torch.Generator(device="cuda").manual_seed(1)
    lbig = torch.full((D,), -1e3, device="cuda", dtype=torch.float64)
    with torch.no_grad():
        Xs, _ = _gen_candidates(gen, vp_last, gp_last, lbig, -lbig, 8192,
                                2048, 2048, 2048)
    return gp_last, vp_last, Xs


def phase_noiseless(torch, kernels):
    """vbmc on the card on two noiseless targets, then `prospective_acq`
    against its plain version at the shapes of the 6-D run's last GP and
    VP. Returns the kernel's launches in the two runs and the comparison."""
    from vbmc_tpu_torch import VBMCOptions
    from vbmc_tpu_torch.gp.config import GPConfig

    D = 6
    sd = np.linspace(0.6, 1.4, D)
    lnz = 1.7

    def logp6(x):
        return (-0.5 * np.sum((x / sd) ** 2) - 0.5 * D * np.log(2 * np.pi)
                - np.sum(np.log(sd)) + lnz)

    res6, l6, _ = run_target(
        torch, kernels, "prospective_acq", "mvn_6d", logp6, D,
        np.full(D, 0.3), lnz, np.zeros(D),
        VBMCOptions(display="off", max_fun_evals=100, seed=3,
                    min_final_components=20),
        plb=np.full(D, -4.0), pub=np.full(D, 4.0))

    D3 = 3
    rng0 = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng0.standard_normal((D3, D3)))
    cov = Q @ np.diag(np.array([2.0, 0.5, 0.1]) ** 2) @ Q.T
    prec = np.linalg.inv(cov)
    lognorm = -0.5 * D3 * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(cov)[1]

    def logp_cigar(x):
        return float(-0.5 * x @ prec @ x + lognorm)

    _, l3, _ = run_target(
        torch, kernels, "prospective_acq", "cigar_rotoscale_3d", logp_cigar,
        D3, np.full(D3, 0.25), 0.0, np.zeros(D3),
        VBMCOptions(display="off", max_fun_evals=100, seed=3,
                    min_final_components=20),
        plb=np.full(D3, -4.0), pub=np.full(D3, 4.0))

    gp_last, vp_last, Xs = _candidates(torch, res6, D)
    tag = (f"main-path N={gp_last.X.shape[0]} S={gp_last.hyp.shape[0]} "
           f"K={vp_last.mu.shape[0]} M=8192 D={D} float64")
    r = compare_prospective(torch, kernels, tag, GPConfig(D=D), gp_last,
                            vp_last, Xs, float(res6.logger.ymax), 1e-4)
    r.pop("ref")
    return l6 + l3, r


def phase_noisy(torch, kernels, seed=1):
    """vbmc on the card on the noisy 2-D half-normal (sigma=1 additive noise,
    the target returns its SD; `bench.py` block `halfnorm2_noisy`), then
    `viqr_acq` against its plain version at the shapes of the run's last
    GP. Returns the kernel's launches in the run and the comparison."""
    from vbmc_tpu_torch import VBMCOptions
    from vbmc_tpu_torch.gp.config import GPConfig

    D = 2
    sd = np.array([1.0, 0.6])
    noise = np.random.default_rng(1000 + seed)

    def halfnorm_noisy(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + noise.standard_normal()), 1.0

    res, launches, _ = run_target(
        torch, kernels, "viqr_acq", "halfnorm2_noisy", halfnorm_noisy, D,
        np.array([0.5, 0.5]), float(np.log(0.25)), sd * np.sqrt(2 / np.pi),
        VBMCOptions(display="off", max_fun_evals=100, seed=seed,
                    min_final_components=20, specify_target_noise=True),
        lb=np.zeros(D), ub=np.full(D, 10.0), plb=np.full(D, 0.05),
        pub=np.full(D, 3.0))
    if res.quick_updates < 1:
        raise AssertionError("halfnorm2_noisy: no per-point full update ran")

    gp_last, vp_last, Xs = _candidates(torch, res, D)
    cfg = GPConfig(D=D, user_noise=1)
    ais, sn2c = viqr_inputs(torch, cfg, gp_last, vp_last, Xs, seed=2)
    tag = (f"main-path N={gp_last.X.shape[0]} S={gp_last.hyp.shape[0]} "
           f"M=8192 D={D} Na={ais.Xa.shape[0]} float64")
    r = compare_viqr(torch, kernels, tag, cfg, gp_last, ais, sn2c, Xs, 1e-4)
    r.pop("ref")
    return launches, r


def main():
    import torch

    smi = phase_env(torch)
    if not os.path.isdir(os.path.join(ROOT, "vbmc_tpu_torch")):
        print(f"chip_smoke: no vbmc_tpu_torch package beside {__file__}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vbmc_tpu_torch import kernels

    t = time.monotonic()
    libs = kernels.build_all(verbose=True)
    kernels.prospective_acq.load()
    kernels.viqr_acq.load()
    log(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in libs.values())}"
        f" in {time.monotonic() - t:.1f} s")

    results = phase_kernels(torch, kernels)
    launches = {}
    launches["prospective_acq"], main_p = phase_noiseless(torch, kernels)
    launches["viqr_acq"], main_v = phase_noisy(torch, kernels)
    main_path = {"prospective_acq": main_p, "viqr_acq": main_v}

    replaces = {"prospective_acq": "vbmc_tpu/pallas_kernels.py:157",
                "viqr_acq": "vbmc_tpu/pallas_kernels.py:336"}
    log(f"[env] nvidia-smi: {smi}")
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"vbmc_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"]
                           for r in results[name] + [main_path[name]]
                           if "float64" in r["tag"]),
        "ms": main_path[name]["ms"], "plain_ms": main_path[name]["plain_ms"],
        "timed_at": main_path[name]["tag"],
        "all": results[name] + [main_path[name]]}
        for name in ("prospective_acq", "viqr_acq")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
