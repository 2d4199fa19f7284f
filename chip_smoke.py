#!/usr/bin/env python3
"""Drive the PyTorch port (`vbmc_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). Exits 2 without CUDA: there is no CPU fallback.
2. Build: compile every kernel source (`vbmc_tpu_torch/csrc/*.cu`) with
   nvcc, one process each, started together; the float64 products of the
   two sweep kernels must show as DMMA (FP64 tensor-core) opcodes in
   `cuobjdump -sass`.
3. Each kernel against its plain PyTorch version on the card, float64 and
   float32, with CUDA-event times of both:
   - `prospective_acq` at N=256 S=16 K=16 M=8192 D=6 and N=1024 S=80 K=64
     M=8192 D=10, with Binv from a real GP factorisation;
   - `viqr_acq` at N=256 S=16 K=16 M=8192 D=6 and N=1024 S=80 K=64 M=8192
     D=10, with a real GP with user noise and a real importance-sampling
     set (Na = 298 at the default option values);
   - the edges, float64: 150 valid training points in the 192 rung, 5 valid
     samples of 8, M=8191, at D=1 and D=20, and for VIQR Na=273 (odd, no
     multiple of the kernel's tile) with a tenth of the weights at -inf;
   - both kernels at N=512 in float64 (the 32-candidate plan; the shapes
     above take the two 64-candidate plans and the 16-candidate one);
   - `viqr_acq` on a GP with an output scale of 3e4, float64 and float32:
     predictive SDs at the integration points above 1100, where 2 sinh of
     u SD overflows either type and only a log-domain fold holds;
   - both kernels at the N=640 and N=768 rungs of `utils.math.N_BUCKETS`
     (S=16 K=16 M=8192 D=6, float64): the 16-candidate plan below its top
     rung, where the reference's default D=10 budget of 600 evaluations
     goes.
   Beside each float64 time stand the bound (the product flops of the valid
   samples and training points over 67 TFLOP/s, the H100's FP64 tensor-core
   peak, or every input and output byte once over 3.35 TB/s if that is
   larger) and a yardstick, `library_ms`: the products alone (Binv ks, and
   for VIQR also invKzk^T ks) through `torch.bmm`, which is cuBLAS DGEMM.
   That is the products' time only, not the function's, and the port never
   calls it. Also the exp and expm1 evaluations of the launch's pass 1,
   counted over the whole tiles it evaluates (masked training rows and the
   candidates a ragged M rounds up to included), and, in the log lines
   only, the time of the design before this one at the same shape.
   Then `sym_eig`, CMA-ES's eigensolver, at D = 1, 2, 3, 6, 10, 32, 64 and
   128 in float64 and float32 on seeded SPD matrices (eigenvalues 1e-3 to
   1e3) against the float64 `torch.linalg.eigh`: eigenvalues,
   reconstruction and orthogonality (`SYM_EIG_TOL`), and the CUDA-event
   time of both at D=2 and D=10.
4. The stress configuration, `stress_d10`, starts in a child process
   (`stress_child`, one host thread) and runs beside phases 5 to 7: the
   D=10 / K=50 configuration of `tests/test_stress.py:14-26` (the
   anisotropic 10-D Gaussian, lnZ 0; 250 evaluations pinned by
   `min_fun_evals`; `min_final_components=50`; float64), held to that
   file's assertions (|ELBO| < 1, RMSE < 0.5, each marginal variance
   ratio in (0.35, 2.8), at least 50 components, at least 240
   evaluations) and to one `prospective_acq` launch per acquired point.
   Its line gives the timers, the seconds per iteration (`bench.py`'s
   metric), the N, S and K rungs reached and the child's peak device
   memory; it leaves its last GP and VP for phase 8. Beside it, in a
   second child process (`example_child`, one host thread, its display in
   a file), worked example 6, the noisy IBS psychometric model, through
   its own function `vbmc_tpu_torch.examples.example_6_noisy_ibs` at its
   bundled width (200 trials, two IBS repeats a point, D=3, hard bounds
   on every parameter) and E6 = 100 evaluations of its default 375. Once
   both are gathered the run is held to the quadrature oracle
   `example_truth(6)` (`phase_examples`): exit flag >= 0, |ELBO - lnZ| and
   the posterior-mean RMSE within E6_TOL, at least one `viqr_acq` launch
   per acquired point, at least one per-point full update, and observed
   SDs that vary (the largest at least E6_SD_RATIO times the smallest).
   From the start of the children until both are gathered nothing is
   timed.
5. The noiseless path: `vbmc(..., device="cuda", dtype=torch.float64)` on a
   6-D Gaussian (50 evaluations; ensemble hyperparameter sampler) and a
   correlated 3-D cigar (`cigar_3d`, 40 evaluations; rotoscale warping is
   on, but this run makes no warp), each held to
   |ELBO - lnZ| < 0.5 and posterior-mean RMSE < 0.5; `prospective_acq` must
   have launched at least once per acquired point.
   Then `cigar3_families`: the cigar with `gp_mean_fun="negquadse"`,
   `fitness_shaping=True` and `search_acq_fcn=("prospective_log",)`, 60
   evaluations, held to the same gate: the sweep's dispatch must have
   chosen the plain evaluation, so both kernels must count 0 launches.
   Then `cigar3_families_warp`, the same at 100 evaluations and held to
   the same gate, must make at least one rotoscale warp (`warp_gp_and_vp`
   on the negquadse-mean, output-warped GP, retraining and the undo
   check): a warp falls due six iterations after warm-up ends, which at
   60 evaluations (11 iterations) only some seeds reach.
6. The noisy path: the same call with `specify_target_noise=True` on the
   2-D half-normal with sigma=1 additive noise (the target returns its
   value and SD 1; 80 evaluations), held to the same gate; `viqr_acq` must
   have launched at least once per acquired point, at least one per-point
   full update must have run and at least one rotoscale warp must have
   been made.
   Then `halfnorm2_noisy_repeat`, beside the surface runs of phase 7 in
   other processes: the same target with `max_repeated_observations=2`
   and `repeated_acq_discount=0.5` (the discount of
   `tests/test_torch_e2e_repeat.py`), 30 evaluations, same gate: the
   proposals take the host-side search path, which must still sweep
   through `viqr_acq` once per acquired point, and at least one
   evaluation must repeat a point already observed.
7. The user surface on the 2-D Gaussian of `tests/test_e2e.py:21-36`
   (lnZ -1.3, mean (0.5, -0.3)), each run held to the same gate and, with
   the launch counts of the process it runs in, to one `prospective_acq`
   launch per acquired point. Three processes start together before
   `halfnorm2_noisy_repeat` and are gathered after `mvn2_retry`:
   - `mvn2_sweep`: `vbmc_sweep` with two worker processes on the card, 20
     evaluations each; both runs held to the gate, then
     `vbmc_diagnostics`;
   - a child process (`surface_child`): `mvn2_tempered` (`temperature=2`,
     30 evaluations; the gate on the real posterior that `vp_train2real`
     gives), then `mvn2_resume` (`save_result` of the tempered run,
     `load_checkpoint` onto the card, and a new run from its evaluations
     as `x0` and `fvals`, ten evaluations past the checkpoint's budget: the
     target must not be called at a pre-evaluated point), then
     `mvn2_float32` (30 evaluations with `dtype=torch.float32`: a float32
     posterior and GP, and one float32 `prospective_acq` launch per
     acquired point).
   In this process, after `halfnorm2_noisy_repeat`: `mvn2_retry` (20
   evaluations end without stability, and the retry from the best
   posterior, a warm start from a VP, takes 30 more; the check fails
   unless the target saw more than 20 calls, the retry's own result
   passes the gate as the returned one does, and the returned run is the
   one `vbmc`'s rule picks: the retry where it won, and where the first
   run is returned, a retry that is neither stable nor better by its
   safe ELBO; which of the two close runs wins is the random stream's).
8. Once every other process is gathered, the timed comparisons at the
   runs' last GPs: `prospective_acq` against its plain version at the
   shapes of the 6-D run's last GP and VP; the posterior and GP queries
   at that GP and VP, on the card against the same call on CPU copies,
   float64, each with its CUDA-event time: `vp_pdf`,
   `vp_power`/`vp_train2real` (relative 1e-10), `vp_mode` (1e-6),
   `gp_quantile_pred` (1e-8), `gp_fmin` (the point to 1e-6), and by their
   moments within Monte-Carlo error, as the two generators differ:
   `gp_rnd`; `vp_mtv` of the last VP against the first iteration's, six
   seeds a side; `gp_sample` and `mala_sample` by the means of four
   independent chains a side. Then `viqr_acq` at the shapes of the noisy
   run's last GP, and every acquisition that needs no importance-sampling
   set (`prospective`, `prospective_sn2`, `prospective_log`, `us`, `eig`)
   through `evaluate_acquisition` there on 8192 candidates: the card
   against the same call on CPU copies of the tensors (float64, rtol 1e-8
   plus 1e-6 of the largest value where the GP's variance cancels, same
   argmin), with the CUDA-event time of each. The same two checks at
   example 6's last GP and VP (D=3, its own N and S rungs; `(e6)` in
   PERF.md), and there CMA-ES on "viqr" through the importance-sampling
   set as active sampling runs it on the card (generation 0 eager, one
   CUDA graph replayed for the rest) against the same generations run
   eagerly, from one seed: x_best, f_best and x_mean bit for bit, with the
   device time of one replayed generation. Last, `prospective_acq` at the
   shapes of the stress run's last GP and VP, and the same CMA-ES check
   on "prospective" there (D=10, 375 generations).
9. The microbenchmark `python -m vbmc_tpu_torch.bench_kernels` (the twin
   of `bench_kernels.py`), in this process at its default shape (N=256
   S=16 K=16 M=8192 D=6) with a 50 ms pipelined window, its rows logged
   as `[bench_kernels]` lines: the probe's DGEMM must be at most 1.05x the
   card's documented FP64 peak, every row's numbers finite, and each
   `_cuda` row must have moved its kernel's launch counter (those
   launches are not the main path's and are not counted in the line
   below).
10. A JSON line with every kernel's numbers (the headline ones at the
   stress run's last GP for `prospective_acq`, at the noisy run's for
   `viqr_acq` and at D=10 float64 for `sym_eig`, whose bound is one
   Jacobi sweep on one SM; launches summed over every run of this process
   and of the three child processes, example 6's included; the sweep's
   workers are not counted; `sym_eig`'s are counted at each replay of the
   CMA-ES graph that recorded it), then the last line {"ok": true,
   "device": {...}}.

The launch counts of a path are set to 0 just before it runs and read just
after; the comparisons' own launches do not count. No kernel or query is
timed while another process of the script runs. The script imports only
the port (`vbmc_tpu_torch`), torch, numpy and, for the examples' oracle
`example_truth` (grid quadrature; no torch), scipy.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# The card's peaks (NVIDIA's H100 SXM data sheet): FP64 on the tensor cores,
# and device memory.
PEAK_FP64_TC = 67e12
# One SM's FP64 FMA rate (34 TFLOP/s over 132 SMs): `sym_eig` runs on one
# CTA and no tensor core.
PEAK_FP64_SM = 34e12 / 132
PEAK_BYTES = 3.35e12
# Float64 kernel ms of the design before this one (FP64 FMA micro-tile, ks
# recomputed per 64-row tile, single-buffered loads), H100 80GB HBM3 at
# 700 W: PERF.md section 6, "earlier" column. Keys: kernel, then (N, S) of
# the two shapes both designs were timed at. Printed beside the new time in
# the log; no part of the JSON line, which holds this run's numbers only.
PREV_MS = {
    "prospective_acq": {(256, 16): 2.601, (1024, 80): 205.2},
    "viqr_acq": {(256, 16): 6.435, (1024, 80): 275.1},
}


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


def _hyps(cfg, rng, S, D, log_sf=0.0):
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8 * np.sqrt(D)) + 0.05 * rng.standard_normal((S, D))
    hyps[:, D] = log_sf + 0.1 * rng.standard_normal(S)
    hyps[:, cfg.ncov] = np.log(0.05)
    i_m = cfg.ncov + cfg.nnoise
    hyps[:, i_m] = 0.3
    hyps[:, i_m + 1 + D:] = np.log(1.2 * np.sqrt(D))
    return hyps


def make_case(torch, N, S, K, M, D, seed=0, noisy=False, n_valid=None,
              s_valid=None, log_sf=0.0):
    """Kernel inputs from a numpy seed: a real build_gp (with user noise
    variances of about 1 when ``noisy``), a K-component VP and M
    candidates. ``n_valid`` training points fill the N slots and
    ``s_valid`` samples the S slots (default: all), the rest masked;
    ``log_sf`` is the mean log output scale of the GP's samples."""
    from vbmc_tpu_torch.gp.config import GPConfig
    from vbmc_tpu_torch.gp.gp import gp_from_host
    from vbmc_tpu_torch.transforms import create_trinfo
    from vbmc_tpu_torch.vp import make_vp

    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D, user_noise=1 if noisy else 0)
    n = N if n_valid is None else n_valid
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1)
    s2 = None
    if noisy:
        y = y + rng.standard_normal(n)
        s2 = rng.uniform(0.8, 1.2, n)
    gp = gp_from_host(cfg, X, y, s2,
                      _hyps(cfg, rng, S if s_valid is None else s_valid, D,
                            log_sf),
                      n_bucket=N, s_bucket=S, device="cuda",
                      dtype=torch.float64)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                           [2.0] * D, device="cuda", dtype=torch.float64)
    w = rng.random(K) + 0.3
    vp = make_vp(trinfo, rng.uniform(-1, 1, (K, D)), 0.4 + 0.2 * rng.random(K),
                 np.ones(D), w=w / w.sum(), k_max=K)
    Xs = torch.as_tensor(rng.uniform(-2.5, 2.5, (M, D)), device="cuda")
    return cfg, gp, vp, Xs, 0.7, 1e-4


def viqr_inputs(torch, cfg, gp, vp, Xs, seed=0, n_box=100, drop=0.0):
    """A real importance-sampling set (at the default option values: 298
    points) and the nearest-noise estimate at Xs: the inputs
    `sweep_is_acquisition` gives the kernel. ``drop``: the share of the
    log weights set to -inf, as padded or zero-weight points carry."""
    import dataclasses

    from vbmc_tpu_torch.acquisitions import AcqState, _nearest_noise
    from vbmc_tpu_torch.active_is import build_is_state_core

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        ais = build_is_state_core(gen, cfg, "viqr", vp, gp, 100, n_box, 100,
                                  mh_steps=3, fess_thresh=0.9)
        if drop:
            gone = torch.rand(ais.ln_weights.shape, generator=gen,
                              device="cuda") < drop
            ais = dataclasses.replace(ais, ln_weights=torch.where(
                gone, -np.inf, ais.ln_weights).contiguous())
        hm = gp.hyp_mask.to(gp.hyp.dtype)
        gls = torch.exp((gp.hyp[:, :cfg.D] * hm[:, None]).sum(0) / hm.sum())
        dev = torch.full((cfg.D,), np.inf, device="cuda", dtype=Xs.dtype)
        state = AcqState(ymax=None, tol_var=None, lb_eps_orig=-dev,
                         ub_eps_orig=dev, gp_length_scale=gls)
        sn2c = _nearest_noise(cfg, gp, Xs, state)
    return ais, sn2c


def cast_tree(torch, obj, dtype=None, device=None):
    """A copy of a dataclass with its floating-point tensors (recursively
    through nested dataclasses) cast to ``dtype`` and, with ``device``, all
    of its tensors moved there."""
    import dataclasses

    def cast(v):
        if dataclasses.is_dataclass(v):
            return cast_tree(torch, v, dtype, device)
        if isinstance(v, torch.Tensor):
            if dtype is not None and v.is_floating_point():
                v = v.to(dtype)
            return v if device is None else v.to(device)
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


def compare(torch, name, tag, kernel, plain, work, truth=None):
    """A kernel (``kernel()`` calls its wrapper) against its plain version
    (``plain()``) on the same inputs; asserts the tolerance and returns the
    numbers. ``truth``: the float64 plain result on the same inputs, for a
    float32 case. ``work``: the product flops and the bytes these inputs
    need, the exp evaluations of one launch, ``library()`` (the products
    alone through torch.bmm) and ``prev_ms`` (the earlier design's time at
    this shape, or None; logged only)."""
    gflop = work["flops"] / 1e9
    bound_ops = work["flops"] / PEAK_FP64_TC * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    bound_by = "operations" if bound_ops >= bound_bytes else "bytes"
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
    log(f"[kernel] {name} {tag}: max_abs_err {max_abs:.3e} max_rel_err "
        f"{max_rel:.3e} max|acq| {scale:.3e} argmin_equal {same_argmin} "
        f"({rule}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {tag}: kernel disagrees with plain "
                             f"version")
    ms = cuda_time_ms(torch, kernel)
    plain_ms = cuda_time_ms(torch, plain, repeats=5, inner=1)
    library_ms = cuda_time_ms(torch, work["library"], repeats=5, inner=1)
    log(f"[kernel] {name} {tag}: kernel {ms:.3f} ms ({gflop / ms:.1f} "
        f"TFLOP/s on {gflop:.2f} GFLOP; bound {bound_ms:.4f} ms by "
        f"{bound_by}, {100 * bound_ms / ms:.1f}% of it reached), plain "
        f"{plain_ms:.3f} ms, products alone by torch.bmm {library_ms:.3f} "
        f"ms, earlier design {work['prev_ms']} ms, exp evaluations "
        f"{work['exp_evals']}")
    return dict(tag=tag, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms,
                exp_evals=work["exp_evals"], gflop=gflop,
                argmin_equal=same_argmin, ref=ref)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _valid(gp):
    """Valid hyperparameter samples and training points of a GP."""
    return int(gp.hyp_mask.sum()), int(gp.mask.sum())


def _tile_work(kernel, gp, Xs):
    """(sample, candidate) pairs that pass 1 of ``kernel`` evaluates (the
    valid samples times M rounded up to the candidate tile of the plan taken
    at this N) and the training slots it evaluates ks at for each (the whole
    bucket: masked rows are computed and discarded)."""
    M, D = Xs.shape
    N = gp.X.shape[0]
    mt = kernel.tile_width(N, D, Xs.dtype)
    return int(gp.hyp_mask.sum()) * -(-M // mt) * mt, N


def _prev_ms(name, gp, dtype):
    if str(dtype) != "torch.float64":
        return None
    return PREV_MS[name].get((gp.X.shape[0], gp.hyp.shape[0]))


def compare_prospective(torch, kernels, tag, cfg, gp, vp, Xs, ymax, tol_var,
                        truth=None):
    M = Xs.shape[0]
    S, N = _valid(gp)
    pairs, slots = _tile_work(kernels.prospective_acq, gp, Xs)
    ks = torch.randn((gp.hyp.shape[0], gp.X.shape[0], M), device=Xs.device,
                     dtype=Xs.dtype)
    work = dict(
        flops=2.0 * S * M * N * N,
        bytes=_nbytes(Xs, gp.X, gp.hyp, gp.alpha, gp.Binv, vp.mu, vp.sigma,
                      vp.lam, vp.w) + M * Xs.element_size(),
        # ks once per (sample, candidate, training slot); pass 2 adds at
        # most K + 2 per candidate.
        exp_evals=pairs * slots,
        prev_ms=_prev_ms("prospective_acq", gp, Xs.dtype),
        library=lambda: torch.bmm(gp.Binv, ks))
    return compare(
        torch, "prospective_acq", tag,
        lambda: kernels.prospective_acq(cfg, Xs, gp, vp, ymax, tol_var, True),
        lambda: kernels.prospective_acq_reference(cfg, Xs, gp, vp, ymax,
                                                  tol_var, True),
        work, truth)


def compare_viqr(torch, kernels, tag, cfg, gp, ais, sn2c, Xs, tol_var,
                 truth=None):
    M = Xs.shape[0]
    S, N = _valid(gp)
    Na = ais.Xa.shape[0]
    pairs, slots = _tile_work(kernels.viqr_acq, gp, Xs)
    # Integration points with a finite weight, over the valid samples (the
    # kernel skips the others).
    finite = int(torch.isfinite(ais.ln_weights[gp.hyp_mask]).sum())
    ks = torch.randn((gp.hyp.shape[0], gp.X.shape[0], M), device=Xs.device,
                     dtype=Xs.dtype)
    invKzk_t = ais.invKzk.transpose(1, 2)

    def library():
        torch.bmm(gp.Binv, ks)
        torch.bmm(invKzk_t, ks)

    work = dict(
        flops=2.0 * S * M * N * (N + Na),
        bytes=_nbytes(Xs, gp.X, gp.hyp, gp.alpha, gp.Binv, ais.Xa,
                      ais.ln_weights, ais.f_s2, ais.invKzk, sn2c)
        + M * Xs.element_size(),
        # ks as above; per (sample, candidate, weighted integration point)
        # the exp of k(C, Xa), the epilogue's expm1 and its one exp.
        exp_evals=pairs * slots + 3 * (pairs // S) * finite,
        prev_ms=_prev_ms("viqr_acq", gp, Xs.dtype),
        library=library)
    return compare(
        torch, "viqr_acq", tag,
        lambda: kernels.viqr_acq(cfg, Xs, gp, ais, sn2c, tol_var, True),
        lambda: kernels.viqr_acq_reference(cfg, Xs, gp, ais, sn2c, tol_var,
                                           True),
        work, truth)


# (N, S, K, M, D) of the comparisons of phase 3: the mid and the top bucket.
SHAPES = ((256, 16, 16, 8192, 6), (1024, 80, 64, 8192, 10))
# The edges: 150 valid points in the 192 rung, 5 valid samples of 8, a
# ragged M, the narrowest and the widest D; VIQR adds an odd Na (198 VP
# draws + 75 box draws = 273) with a tenth of its weights at -inf.
EDGES = (dict(N=192, S=8, K=8, M=8191, D=1, n_valid=150, s_valid=5),
         dict(N=192, S=8, K=8, M=8191, D=20, n_valid=150, s_valid=5))
EDGE_N_BOX, EDGE_DROP = 75, 0.1
# The 32-candidate plan (float64: N from 288 to 512), which SHAPES and EDGES
# do not reach.
MID = dict(N=512, S=16, K=16, M=8192, D=6)
# VIQR on a GP with an output scale of 3e4 (at D=6 the 128 training points
# leave most of that at the integration points): the largest predictive SD
# at the integration points must exceed WIDE_MIN_SD, beyond which
# 2 sinh(u SD) overflows float64 (float32 from an SD of 131).
WIDE = dict(N=128, S=8, K=8, M=8192, D=6, log_sf=float(np.log(3e4)))
WIDE_MIN_SD = 1100.0
# The rungs below the top that the shapes above skip: the 16-candidate plan
# at N=640 and 768.
RUNGS = tuple(dict(N=N, S=16, K=16, M=8192, D=6) for N in (640, 768))


def phase_kernels(torch, kernels):
    """Both kernels against their plain versions: at two shapes each in
    float64 and float32, at the edges and at N=512 in float64, and VIQR at a
    large output scale in both types. Returns {kernel name: [results]}."""
    out = {"prospective_acq": [], "viqr_acq": []}

    def shape_of(tag, case, gp):
        S, N = _valid(gp)
        return (f"{tag}N={case['N']} S={case['S']} K={case['K']} "
                f"M={case['M']} D={case['D']} valid N={N} S={S}")

    def prospective(tag, case, float32):
        cfg, gp, vp, Xs, ymax, tol_var = make_case(torch, **case)
        shape = shape_of(tag, case, gp)
        r64 = compare_prospective(torch, kernels, f"{shape} float64", cfg, gp,
                                  vp, Xs, ymax, tol_var)
        out["prospective_acq"].append(r64)
        if float32:
            out["prospective_acq"].append(compare_prospective(
                torch, kernels, f"{shape} float32", cfg,
                cast_tree(torch, gp, torch.float32),
                cast_tree(torch, vp, torch.float32), Xs.float(), ymax,
                tol_var, truth=r64["ref"]))
        del gp, vp, Xs, r64
        for r in out["prospective_acq"]:
            r.pop("ref", None)
        torch.cuda.empty_cache()

    def viqr(tag, case, float32, min_sd=None, **viqr_kw):
        cfg, gp, vp, Xs, _, tol_var = make_case(torch, noisy=True, **case)
        ais, sn2c = viqr_inputs(torch, cfg, gp, vp, Xs, **viqr_kw)
        n_inf = int(torch.isinf(ais.ln_weights).sum())
        sd = float(ais.f_s2[gp.hyp_mask].max().sqrt())
        shape = (f"{shape_of(tag, case, gp)} Na={ais.Xa.shape[0]} weights at "
                 f"-inf {n_inf} max SD at Xa {sd:.4g}")
        if min_sd is not None and not sd > min_sd:
            raise AssertionError(f"viqr_acq {shape}: the case does not reach "
                                 f"an SD of {min_sd}")
        r64 = compare_viqr(torch, kernels, f"{shape} float64", cfg, gp, ais,
                           sn2c, Xs, tol_var)
        out["viqr_acq"].append(r64)
        if float32:
            out["viqr_acq"].append(compare_viqr(
                torch, kernels, f"{shape} float32", cfg,
                cast_tree(torch, gp, torch.float32),
                cast_tree(torch, ais, torch.float32), sn2c.float(),
                Xs.float(), tol_var, truth=r64["ref"]))
        del gp, vp, Xs, ais, sn2c, r64
        for r in out["viqr_acq"]:
            r.pop("ref", None)
        torch.cuda.empty_cache()

    for (N, S, K, M, D) in SHAPES:
        case = dict(N=N, S=S, K=K, M=M, D=D)
        prospective("", case, float32=True)
        viqr("", case, float32=True)
    for case in EDGES:
        prospective("edges ", case, float32=False)
        viqr("edges ", case, float32=False, n_box=EDGE_N_BOX, drop=EDGE_DROP)
    prospective("mid ", MID, float32=False)
    viqr("mid ", MID, float32=False)
    viqr("wide ", WIDE, float32=True, min_sd=WIDE_MIN_SD)
    for case in RUNGS:
        prospective("rung ", case, float32=False)
        viqr("rung ", case, float32=False)
    return out


def gate(torch, vp, elbo, lnz, mean_true):
    """|ELBO - lnZ| and the posterior-mean RMSE of a VP on the card."""
    from vbmc_tpu_torch.vp import vp_moments

    gen = torch.Generator(device="cuda").manual_seed(0)
    mean, _ = vp_moments(vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    mean = mean.cpu().numpy()
    return abs(elbo - lnz), float(np.sqrt(np.mean((mean - mean_true) ** 2)))


def run_target(torch, kernels, kernel, name, logp, D, x0, lnz, mean_true,
               options, lb=None, ub=None, plb=None, pub=None, acquired=None,
               note="", min_warps=0, require=None, tol_elbo=0.5,
               dtype=None):
    """One `vbmc` run on the card, held to the gate. ``kernel``: the launch
    counter the run must advance at least once per acquired point; None for
    a run whose sweeps the dispatch gives to the plain evaluation, which
    must launch neither kernel. ``acquired``: the acquired points as a
    function of the result, where they are not the evaluations past the
    initial design (a retry, pre-evaluated points); ``note``: a function of
    the result giving more text for the log line; ``min_warps``: the
    rotoscale warps the run must make; ``require``: a further condition,
    a function of the result; ``tol_elbo``: the gate's bound on |ELBO -
    lnZ|; ``dtype``: the run's (float64 by default), whose launches are
    the ones counted."""
    from vbmc_tpu_torch.main import vbmc

    dtype = dtype or torch.float64
    f32 = dtype == torch.float32
    torch.cuda.reset_peak_memory_stats()
    for k in (kernels.prospective_acq, kernels.viqr_acq):
        k.launches = k.launches_f32 = 0
    eig0 = kernels.sym_eig.launches
    t = time.monotonic()
    res = vbmc(logp, x0=x0, lb=lb, ub=ub, plb=plb, pub=pub, options=options,
               device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    launches = {k.name: k.launches_f32 if f32 else k.launches
                for k in (kernels.prospective_acq, kernels.viqr_acq)}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    err, rmse = gate(torch, res.vp, res.elbo, lnz, mean_true)
    if acquired is None:
        acquired = res.func_count - options.resolve(D).fun_eval_start
    else:
        acquired = acquired(res)
    if kernel is None:
        launched_ok = not any(launches.values()) and acquired > 0
    else:
        launched_ok = launches[kernel] >= acquired > 0
    ok = (err < tol_elbo and rmse < 0.5 and np.isfinite(res.elbo)
          and launched_ok and res.warps_made >= min_warps
          and (require is None or bool(require(res))))
    repeats = _repeats(res)
    log(f"[e2e] {name}: elbo {res.elbo:.4f} (lnZ {lnz:.4f}, err {err:.4f}) "
        f"elbo_sd {res.elbo_sd:.4f} rmse {rmse:.4f} func_count "
        f"{res.func_count} iterations {res.iterations} seconds {secs:.1f} "
        f"{note(res) + ' ' if note else ''}"
        f"peak_device_MiB {peak_mib:.1f} "
        f"{'float32_' if f32 else ''}kernel_launches {launches} "
        f"sym_eig_launches {kernels.sym_eig.launches - eig0} "
        f"acquired_points {acquired} repeated_observations {repeats} "
        f"quick_updates {res.quick_updates} "
        f"warps_made {res.warps_made} (at least {min_warps}) warps_undone "
        f"{res.warps_undone} timers "
        f"{ {k: round(v, 2) for k, v in res.timers.items()} }: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: end-to-end gate failed")
    return res, launches.get(kernel, 0), secs, peak_mib


def _last(res):
    """(gp, vp, ymax) of a run's last iteration."""
    it = res.stats.iterations[-1]
    return it.gp, it.vp, float(res.logger.ymax)


def _candidates(torch, gp, vp, D):
    """A real 2^13 candidate set around a run's last VP and GP."""
    from vbmc_tpu_torch.active_sample import _gen_candidates

    gen = torch.Generator(device="cuda").manual_seed(1)
    lbig = torch.full((D,), -1e3, device="cuda", dtype=torch.float64)
    with torch.no_grad():
        Xs, _ = _gen_candidates(gen, vp, gp, lbig, -lbig, 8192, 2048, 2048,
                                2048)
    return Xs


# `sym_eig` against torch.linalg.eigh: every width of VBMC's range and the
# kernel's ceiling; the errors relative to max |C| (eigenvalues and the
# reconstruction) or absolute (B^T B - I).
SYM_EIG_DS = (1, 2, 3, 6, 10, 32, 64, 128)
SYM_EIG_TOL = {"float64": 1e-12, "float32": 1e-4}


def _spd(torch, D, seed, dtype):
    """A seeded symmetric positive definite matrix with eigenvalues from
    1e-3 to 1e3, the spread CMA-ES's covariance reaches on an
    ill-conditioned acquisition."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    C = Q @ np.diag(np.logspace(-3, 3, D)) @ Q.T
    return torch.as_tensor(0.5 * (C + C.T), dtype=dtype, device="cuda")


def phase_sym_eig(torch, kernels):
    """`sym_eig` at every D of SYM_EIG_DS, float64 and float32, against
    the float64 `torch.linalg.eigh` of the same matrix: the sorted
    eigenvalues, B diag(L) B^T against C, and B^T B against I, within
    SYM_EIG_TOL; the CUDA-event time of both at D=2 and D=10, against a
    bound: one Jacobi sweep (6 D^3 flops, the least a solve does) at one
    SM's FP64 rate, or the bytes of A, w and V at the card's, the larger.
    Returns the numbers of each case, as `compare` does."""
    out = []
    for D in SYM_EIG_DS:
        for dt in (torch.float64, torch.float32):
            C = _spd(torch, D, D, dt)
            L, B = kernels.sym_eig(C)
            C64, L64, B64 = C.double(), L.double(), B.double()
            scale = float(C64.abs().max())
            ev = float((torch.sort(L64).values
                        - torch.linalg.eigvalsh(C64)).abs().max()) / scale
            rec = float((B64 @ torch.diag(L64) @ B64.T - C64).abs().max()) \
                / scale
            orth = float((B64.T @ B64 - torch.eye(
                D, dtype=torch.float64, device="cuda")).abs().max())
            tol = SYM_EIG_TOL[str(dt).split(".")[-1]]
            ok = max(ev, rec, orth) < tol
            times = ""
            ms = ms_eigh = bound_ms = bound_by = None
            if D in (2, 10):
                ms = cuda_time_ms(torch, lambda: kernels.sym_eig(C),
                                  repeats=7, inner=20)
                ms_eigh = cuda_time_ms(torch, lambda: torch.linalg.eigh(C),
                                       repeats=7, inner=20)
                bound_ops = 6 * D ** 3 / PEAK_FP64_SM * 1e3
                bound_bytes = (2 * D * D + D) * C.element_size() \
                    / PEAK_BYTES * 1e3
                bound_ms = max(bound_ops, bound_bytes)
                bound_by = "operations" if bound_ops >= bound_bytes \
                    else "bytes"
                times = (f"; sym_eig {ms * 1e3:.1f} us, torch.linalg.eigh "
                         f"{ms_eigh * 1e3:.1f} us (CUDA events), bound "
                         f"{bound_ms * 1e3:.4f} us by {bound_by}")
            out.append(dict(tag=f"D={D} {str(dt).split('.')[-1]}",
                            max_abs_err=max(ev, rec, orth), ms=ms,
                            plain_ms=ms_eigh, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            exp_evals=None))
            log(f"[sym_eig] D={D} {str(dt).split('.')[-1]}: eigenvalues "
                f"{ev:.2e}, reconstruction {rec:.2e} (of max|C| {scale:.4g}), "
                f"B^T B - I {orth:.2e}, tolerance {tol}{times}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"sym_eig D={D} {dt}: off eigh")
    return out


def compare_cmaes_capture(torch, name, f_batch, x0, insigma, lb, ub,
                          max_evals):
    """CMA-ES as the program runs it on the card (`start`, `finish`:
    generation 0 eager, one graph replayed n_gen - 1 times) against the
    same generation function run n_gen times eagerly on the card, from one
    generator seed (the same normals) on the same objective: x_best, f_best
    and x_mean must agree bit for bit, and n_evals be n_gen times 16. Logs
    the device time of one replayed generation (CUDA events over the
    replays), `start`'s host time and an eager generation's."""
    from vbmc_tpu_torch.samplers.cmaes import CMAES

    def make():
        gen = torch.Generator(device="cuda").manual_seed(5)
        return CMAES(gen, f_batch, x0, insigma, lb, ub, max_evals,
                     popsize=16)

    with torch.no_grad():
        eager = make()
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(eager.n_gen):
            eager.generation()
        want = eager.result()
        torch.cuda.synchronize()
        eager_s = time.monotonic() - t
        es = make()
        t = time.monotonic()
        es.start()
        torch.cuda.synchronize()
        start_s = time.monotonic() - t
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = es.finish()
        b.record()
        torch.cuda.synchronize()
        replay_ms = a.elapsed_time(b) / (es.n_gen - 1)
    same = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
            for f in ("x_best", "f_best", "x_mean")}
    ok = all(same.values()) and got.n_evals == es.n_gen * 16 == want.n_evals
    log(f"[cmaes] {name} D={x0.shape[0]}: {es.n_gen} generations of 16; "
        f"graph against eager bit for bit {same}, f_best "
        f"{float(got.f_best):.6g}; one replayed generation "
        f"{replay_ms * 1e3:.1f} us of device time, an eager one "
        f"{eager_s / eager.n_gen * 1e3:.2f} ms of wall, start (generation "
        f"0, capture, instantiation) {start_s * 1e3:.1f} ms: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the captured CMA-ES is not the eager "
                             "one")
    return replay_ms


def _refine_inputs(torch, cfg, gp, vp, Xs, f_batch):
    """What active sampling hands CMA-ES: the winner of ``f_batch`` over
    the candidates, the VP's per-dimension scales and the candidates' box
    (`active_sample._propose_point`)."""
    from vbmc_tpu_torch.vp import vp_moments

    with torch.no_grad():
        acq = f_batch(Xs)
        x0 = Xs[int(torch.argmin(torch.where(torch.isfinite(acq), acq,
                                             torch.inf)))]
        _, cov = vp_moments(vp, orig_flag=False)
        insigma = torch.sqrt(torch.diagonal(cov).clamp_min(1e-12))
    big = torch.full_like(x0, 1e3)
    return x0, insigma, torch.minimum(x0, -big), torch.maximum(x0, big)


def compare_cmaes_prospective(torch, name, last, D):
    """`compare_cmaes_capture` on "prospective" at a noiseless run's last
    GP and VP, ``last`` = (gp, vp, ymax), with the default budget at D."""
    from vbmc_tpu_torch import VBMCOptions
    from vbmc_tpu_torch.acquisitions import AcqState, evaluate_acquisition
    from vbmc_tpu_torch.gp.config import GPConfig

    gp, vp, ymax = last
    cfg = GPConfig(D=D)
    inf = torch.full((D,), np.inf, device="cuda", dtype=torch.float64)
    opt = VBMCOptions().resolve(D)
    state = AcqState(ymax=torch.tensor(float(ymax), device="cuda",
                                       dtype=torch.float64),
                     tol_var=torch.tensor(opt.tol_gp_var, device="cuda",
                                          dtype=torch.float64),
                     lb_eps_orig=-inf, ub_eps_orig=inf)

    def f_batch(xs):
        return evaluate_acquisition(cfg, "prospective", xs, vp, gp, state)

    Xs = _candidates(torch, gp, vp, D)
    return compare_cmaes_capture(torch, name, f_batch,
                                 *_refine_inputs(torch, cfg, gp, vp, Xs,
                                                 f_batch),
                                 opt.search_max_fun_evals)


def compare_cmaes_viqr(torch, last):
    """`compare_cmaes_capture` on "viqr" at example 6's last GP and VP,
    ``last`` = (gp, vp, meta), through its importance-sampling set, with
    the default budget of a noisy target at D=3."""
    from vbmc_tpu_torch import VBMCOptions
    from vbmc_tpu_torch.acquisitions import AcqState
    from vbmc_tpu_torch.active_is import evaluate_is_acquisition
    from vbmc_tpu_torch.gp.config import GPConfig

    gp, vp, meta = last
    D = vp.D
    cfg = GPConfig(D=D, user_noise=1)
    opt = VBMCOptions(specify_target_noise=True).resolve(D)
    Xs = _candidates(torch, gp, vp, D)
    ais, _ = viqr_inputs(torch, cfg, gp, vp, Xs, seed=2)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device="cuda")

    hm = gp.hyp_mask.to(gp.hyp.dtype)
    state = AcqState(
        ymax=t(meta["ymax"]), tol_var=t(opt.tol_gp_var),
        lb_eps_orig=t(meta["lb_eps"]), ub_eps_orig=t(meta["ub_eps"]),
        gp_length_scale=torch.exp((gp.hyp[:, :D] * hm[:, None]).sum(0)
                                  / hm.sum()))

    def f_batch(xs):
        return evaluate_is_acquisition(cfg, "viqr", xs, vp, gp, state, ais)

    return compare_cmaes_capture(torch, "example_6_noisy_ibs viqr", f_batch,
                                 *_refine_inputs(torch, cfg, gp, vp, Xs,
                                                 f_batch),
                                 opt.search_max_fun_evals)


def phase_noiseless(torch, kernels):
    """vbmc on the card on two noiseless targets and on the cigar with
    another mean family and acquisition. Returns the kernel's launches in
    the runs and the 6-D run's result, whose last GP and VP the timed
    comparisons take later."""
    from vbmc_tpu_torch import VBMCOptions

    D = 6
    sd = np.linspace(0.6, 1.4, D)
    lnz = 1.7

    def logp6(x):
        return (-0.5 * np.sum((x / sd) ** 2) - 0.5 * D * np.log(2 * np.pi)
                - np.sum(np.log(sd)) + lnz)

    res6, l6, _, _ = run_target(
        torch, kernels, "prospective_acq", "mvn_6d", logp6, D,
        np.full(D, 0.3), lnz, np.zeros(D),
        VBMCOptions(display="off", max_fun_evals=50, seed=3,
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

    # rotoscale warping is on in every cigar (the default): this run makes
    # no warp
    _, l3, _, _ = run_target(
        torch, kernels, "prospective_acq", "cigar_3d", logp_cigar,
        D3, np.full(D3, 0.25), 0.0, np.zeros(D3),
        VBMCOptions(display="off", max_fun_evals=40, seed=3,
                    min_final_components=20),
        plb=np.full(D3, -4.0), pub=np.full(D3, 4.0))

    # a mean family and an acquisition outside the kernel: the plain sweep;
    # then, in a run long enough for a warp to fall due, the warp path on
    # that GP
    for name, evals, warps in (("cigar3_families", 60, 0),
                               ("cigar3_families_warp", 100, 1)):
        run_target(
            torch, kernels, None, name, logp_cigar, D3,
            np.full(D3, 0.25), 0.0, np.zeros(D3),
            VBMCOptions(display="off", max_fun_evals=evals, seed=3,
                        min_final_components=20, gp_mean_fun="negquadse",
                        fitness_shaping=True,
                        search_acq_fcn=("prospective_log",)),
            plb=np.full(D3, -4.0), pub=np.full(D3, 4.0), min_warps=warps)
    return l6 + l3, res6


def compare_at_last_gp(torch, kernels, name, last, D):
    """`prospective_acq` against its plain version at the shapes of a
    noiseless run's last GP and VP, ``last`` = (gp, vp, ymax), on a real
    candidate set."""
    from vbmc_tpu_torch.gp.config import GPConfig

    gp_last, vp_last, ymax = last
    Xs = _candidates(torch, gp_last, vp_last, D)
    tag = (f"{name} N={gp_last.X.shape[0]} S={gp_last.hyp.shape[0]} "
           f"K={vp_last.mu.shape[0]} M=8192 D={D} float64")
    r = compare_prospective(torch, kernels, tag, GPConfig(D=D), gp_last,
                            vp_last, Xs, ymax, 1e-4)
    r.pop("ref")
    return r


ACQ_NAMES = ("prospective", "prospective_sn2", "prospective_log", "us",
             "eig")
# The card against the CPU, element-wise: |card - cpu| <= ACQ_RTOL |cpu| +
# ACQ_ATOL_OF_MAX max|cpu|. Both sides run the same float64 PyTorch code and
# differ in the order of their sums only; fs2 = sf2 - qf and the kernel
# integral of "eig" are differences of N-term sums of size sf2, so a value
# carries about N eps sf2 / vtot of relative error on either device. At the
# last GP of the noisy target's run the largest sf2 among the samples was
# 1552 to 2101 against a vtot of 0.05 to 0.09 (80 and 100 evaluations; NVIDIA
# H100 80GB HBM3 at 700 W, torch 2.11), the largest relative difference 4e-9
# to 2.7e-8, for "eig" 3.9e-6. The relative bound alone holds only at a
# well-conditioned GP; the second term allows the ill-conditioned values an
# error of a millionth of the largest value, twenty times what was seen.
ACQ_RTOL = 1e-8
ACQ_ATOL_OF_MAX = 1e-6


def phase_acquisitions(torch, cfg, gp, vp, Xs, ymax, eps, opt):
    """`evaluate_acquisition` for every name of ACQ_NAMES at the GP and VP
    of a finished run, with its logger's ``ymax``, its hard-bound epsilon
    box ``eps`` = (lb_eps, ub_eps) and resolved options ``opt``: on the card
    against the same call on CPU copies of the tensors (float64, ACQ_RTOL
    and ACQ_ATOL_OF_MAX, same argmin, the same finite values), and the
    CUDA-event time of each on the card."""
    from vbmc_tpu_torch.acquisitions import AcqState, evaluate_acquisition
    from vbmc_tpu_torch.active_sample import _var_log_joint
    from vbmc_tpu_torch.gp.predict import gp_predict

    lb_eps, ub_eps = eps

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device="cuda")

    with torch.no_grad():
        hm = gp.hyp_mask.to(gp.hyp.dtype)
        state = AcqState(
            ymax=t(ymax), tol_var=t(opt.tol_gp_var),
            lb_eps_orig=t(lb_eps), ub_eps_orig=t(ub_eps), regularize=True,
            gp_length_scale=torch.exp((gp.hyp[:, :cfg.D] * hm[:, None]).sum(0)
                                      / hm.sum()),
            var_log_joint=_var_log_joint(cfg, gp, vp))
        gp_c, vp_c, state_c = (cast_tree(torch, o, device="cpu")
                               for o in (gp, vp, state))
        Xs_c = Xs.cpu()
        # what the relative differences below come from: the largest output
        # scale among the samples against the candidates' total variance
        vtot = gp_predict(cfg, gp_c, Xs_c)[1]
        sf2 = float(torch.exp(2.0 * gp_c.hyp[gp_c.hyp_mask,
                                             cfg.idx_log_sf]).max())
        for name in ACQ_NAMES:
            got = evaluate_acquisition(cfg, name, Xs, vp, gp, state)
            ref = evaluate_acquisition(cfg, name, Xs_c, vp_c, gp_c, state_c)
            got_c = got.cpu()
            fin = torch.isfinite(ref)
            err = torch.where(fin, (got_c - ref).abs(), 0.0)
            top = float(ref[fin].abs().max())
            rel = err / ref.abs().clamp_min(1e-300)
            worst = int(rel.argmax())
            same = int(got_c.argmin()) == int(ref.argmin())
            ok = (bool(torch.allclose(got_c, ref, rtol=ACQ_RTOL,
                                      atol=ACQ_ATOL_OF_MAX * top))
                  and same and bool((torch.isfinite(got_c) == fin).all()))
            ms = cuda_time_ms(
                torch, lambda: evaluate_acquisition(cfg, name, Xs, vp, gp,
                                                    state),
                repeats=5, inner=2)
            log(f"[acq] {name} N={gp.X.shape[0]} S={gp.hyp.shape[0]} "
                f"K={vp.mu.shape[0]} M={Xs.shape[0]} D={cfg.D} float64: card "
                f"vs CPU max_rel_err {float(rel[worst]):.3e} (value "
                f"{float(ref[worst]):.4g}, vtot {float(vtot[worst]):.4g} "
                f"there; largest sf2 {sf2:.5g}; "
                f"{int((rel > ACQ_RTOL).sum())} candidates above rtol) "
                f"max_abs_err/max|acq| {float(err.max()) / top:.3e} (rule: "
                f"rtol {ACQ_RTOL} + {ACQ_ATOL_OF_MAX} max|acq|) finite "
                f"{int(fin.sum())} argmin_equal {same} min "
                f"{float(ref.min()):.6g}; plain PyTorch on the card "
                f"{ms:.3f} ms: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: the card and the CPU disagree")


def run_halfnorm_noisy(torch, kernels, name, evals, seed=1, min_warps=0,
                       require=None, **kw):
    """vbmc on the card on the noisy 2-D half-normal (sigma=1 additive noise,
    the target returns its SD; `bench.py` block `halfnorm2_noisy`), with
    option values ``kw``: `run_target`'s result."""
    from vbmc_tpu_torch import VBMCOptions

    D = 2
    sd = np.array([1.0, 0.6])
    noise = np.random.default_rng(1000 + seed)

    def halfnorm_noisy(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + noise.standard_normal()), 1.0

    return run_target(
        torch, kernels, "viqr_acq", name, halfnorm_noisy, D,
        np.array([0.5, 0.5]), float(np.log(0.25)), sd * np.sqrt(2 / np.pi),
        VBMCOptions(display="off", max_fun_evals=evals, seed=seed,
                    min_final_components=20, specify_target_noise=True,
                    **kw),
        lb=np.zeros(D), ub=np.full(D, 10.0), plb=np.full(D, 0.05),
        pub=np.full(D, 3.0), min_warps=min_warps, require=require)


def phase_noisy(torch, kernels):
    """`halfnorm2_noisy` on the card: at least one per-point full update and
    one warp. Returns the kernel's launches in the run and its result."""
    res, launches, _, _ = run_halfnorm_noisy(
        torch, kernels, "halfnorm2_noisy", 80, min_warps=1)
    if res.quick_updates < 1:
        raise AssertionError("halfnorm2_noisy: no per-point full update ran")
    return launches, res


def compare_noisy(torch, kernels, name, gp_last, vp_last, ymax, eps, opt):
    """`viqr_acq` against its plain version and every plain acquisition
    against the CPU (`phase_acquisitions`, with ``ymax``, ``eps`` and
    ``opt``) at the shapes of a noisy run's last GP and VP. Returns the
    kernel's comparison."""
    from vbmc_tpu_torch.gp.config import GPConfig

    D = vp_last.D
    Xs = _candidates(torch, gp_last, vp_last, D)
    cfg = GPConfig(D=D, user_noise=1)
    ais, sn2c = viqr_inputs(torch, cfg, gp_last, vp_last, Xs, seed=2)
    S, N = _valid(gp_last)
    tag = (f"{name} N={gp_last.X.shape[0]} (valid {N}) "
           f"S={gp_last.hyp.shape[0]} (valid {S}) M=8192 D={D} "
           f"Na={ais.Xa.shape[0]} float64")
    r = compare_viqr(torch, kernels, tag, cfg, gp_last, ais, sn2c, Xs, 1e-4)
    r.pop("ref")
    phase_acquisitions(torch, cfg, gp_last, vp_last, Xs, ymax, eps, opt)
    return r


def compare_halfnorm_noisy(torch, kernels, res):
    """`compare_noisy` at the last GP of the `halfnorm2_noisy` run."""
    from vbmc_tpu_torch import VBMCOptions
    from vbmc_tpu_torch.active_sample import _hard_bound_eps

    gp_last, vp_last, ymax = _last(res)
    opt = VBMCOptions().resolve(2)
    return compare_noisy(torch, kernels, "halfnorm2_noisy", gp_last, vp_last,
                         ymax, _hard_bound_eps(res.logger, opt), opt)


def _repeats(res):
    """Evaluations that measured a point already observed."""
    lg = res.logger
    return int(lg.nevals[:lg.Xn].sum()) - lg.Xn


def phase_repeat(torch, kernels):
    """`halfnorm2_noisy_repeat`: the host-side search path, still one sweep
    through `viqr_acq` a point, with the winner's value discounted by half
    where it repeats a point (the discount of
    `tests/test_torch_e2e_repeat.py`), so that the re-measure branch runs:
    at least one evaluation must repeat a point. Returns the kernel's
    launches."""
    _, launches, _, _ = run_halfnorm_noisy(
        torch, kernels, "halfnorm2_noisy_repeat", 30,
        max_repeated_observations=2, repeated_acq_discount=0.5,
        require=lambda res: _repeats(res) >= 1)
    return launches


class Mvn2:
    """The 2-D Gaussian of `tests/test_e2e.py:21-36` (lnZ = -1.3, mean
    (0.5, -0.3)), counting its calls. The sweep's workers unpickle it from
    this module, which they import from the repository's root."""

    D = 2
    SD = np.array([1.0, 0.8])
    MU = np.array([0.5, -0.3])
    LNZ = -1.3

    def __init__(self):
        self.calls = []

    def __call__(self, x):
        self.calls.append(np.array(x, float))
        return float(-0.5 * np.sum(((x - self.MU) / self.SD) ** 2)
                     - 0.5 * self.D * np.log(2 * np.pi)
                     - np.sum(np.log(self.SD)) + self.LNZ)


# Budgets of the surface runs: the first run of `mvn2_retry` ends without
# stability and the retry gets its own budget; `mvn2_resume` runs ten
# evaluations past the checkpoint of `mvn2_tempered`.
RETRY_EVALS, RETRY_SECOND = 20, 30
TEMPERED_EVALS = 30
SWEEP_EVALS = 20
# `mvn2_float32`: the same Gaussian in float32 (`tests/test_float32.py` at
# the 2-D Gaussian of the surface runs).
F32_EVALS = 30
# Seconds the surface runs in other processes may take, and their host
# threads: one each, so that three processes beside this one do not crowd
# the host's cores with idle-spinning thread pools.
SURFACE_TIMEOUT = 900.0
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _mvn2_opts(**kw):
    from vbmc_tpu_torch import VBMCOptions

    return VBMCOptions(display="off", seed=1, min_final_components=10, **kw)


MVN2_BOX = dict(plb=np.full(Mvn2.D, -3.0), pub=np.full(Mvn2.D, 3.0))


def _write_launches(workdir, name, launches):
    """A child process's launch counts, for the parent's JSON line."""
    with open(os.path.join(workdir, f"{name}_launches.json"), "w") as f:
        json.dump(launches, f)


def _read_launches(workdir, name):
    with open(os.path.join(workdir, f"{name}_launches.json")) as f:
        return json.load(f)


def surface_child(workdir):
    """`mvn2_tempered`, then `mvn2_resume` from its checkpoint in
    ``workdir``, then `mvn2_float32`: the child process of
    `SurfaceAlongside`, on the card with launch counts of its own (the
    parent has built the kernels), which it leaves in ``workdir``. Returns
    0; a failed check raises."""
    import torch

    sys.path.insert(0, ROOT)
    from vbmc_tpu_torch import kernels
    from vbmc_tpu_torch.serialize import load_checkpoint, save_result
    from vbmc_tpu_torch.vp import vp_pdf

    kernels.prospective_acq.load()
    kernels.viqr_acq.load()
    D, lnz, mu = Mvn2.D, Mvn2.LNZ, Mvn2.MU
    f = Mvn2()
    res_t, l_t, _, _ = run_target(
        torch, kernels, "prospective_acq", "mvn2_tempered", f, D,
        np.zeros(D), lnz, mu, _mvn2_opts(max_fun_evals=TEMPERED_EVALS,
                                         temperature=2), **MVN2_BOX,
        note=lambda res: f"temperature {res.logger.T} vp_K_real "
                         f"{int(res.vp.kmask.sum())} vp_K_train "
                         f"{int(res.vp_train.kmask.sum())}")

    path = os.path.join(workdir, "mvn2_tempered.npz")
    save_result(path, res_t)
    vp_ck, evals, meta = load_checkpoint(path, device="cuda")
    Xq = torch.as_tensor(evals["X_orig"], device="cuda")
    if not torch.equal(vp_pdf(vp_ck, Xq), vp_pdf(res_t.vp, Xq)):
        raise AssertionError("mvn2_resume: the checkpoint's VP differs")
    g = Mvn2()
    pre = {tuple(x) for x in evals["X_orig"]}
    # the logger keeps tempered values, y / T (ROADMAP Queue 3 w)
    _, l_r, _, _ = run_target(
        torch, kernels, "prospective_acq", "mvn2_resume", g, D,
        evals["X_orig"], lnz, mu,
        _mvn2_opts(max_fun_evals=meta["func_count"] + 10, temperature=2,
                   fvals=2.0 * evals["y_orig"]), **MVN2_BOX,
        acquired=lambda res: len(g.calls),
        require=lambda res: not any(tuple(c) in pre for c in g.calls),
        note=lambda res: f"checkpoint_evals {len(pre)} pre_evaluated_kept "
                         f"{res.logger.cache_count} target_calls "
                         f"{len(g.calls)} calls_at_pre_evaluated_points "
                         f"{sum(tuple(c) in pre for c in g.calls)}")

    # the float32 lane: every tensor of the run, and so every launch, in
    # float32 (`launches_f32` counts them)
    _, l_f, _, _ = run_target(
        torch, kernels, "prospective_acq", "mvn2_float32", Mvn2(), D,
        np.zeros(D), lnz, mu, _mvn2_opts(max_fun_evals=F32_EVALS),
        **MVN2_BOX, dtype=torch.float32,
        require=lambda res: (res.vp.mu.dtype == torch.float32
                             and res.stats.iterations[-1].gp.Binv.dtype
                             == torch.float32),
        note=lambda res: f"dtype {res.vp.mu.dtype} all_launches "
                         f"{kernels.prospective_acq.launches}")
    _write_launches(workdir, "surface_child",
                    {"prospective_acq": l_t + l_r + l_f, "viqr_acq": 0,
                     "sym_eig": kernels.sym_eig.launches})
    return 0


# The D=10 / K=50 stress configuration of `tests/test_stress.py:14-26`: the
# anisotropic 10-D Gaussian (lnZ 0), 250 evaluations pinned by
# `min_fun_evals`, the final boost to 50 components; held to that file's
# assertions (|ELBO| < 1, RMSE < 0.5, each variance ratio in (0.35, 2.8),
# at least 50 components, at least 240 evaluations).
STRESS_D = 10
STRESS_SD = np.linspace(0.5, 2.0, STRESS_D)
STRESS_EVALS = 250
STRESS_RATIO = (0.35, 2.8)
STRESS_TIMEOUT = 1000.0


def stress_child(workdir):
    """`stress_d10` on the card: the child process of `StressAlongside`
    (the parent has built the kernels). Leaves in ``workdir`` its launch
    counts, its numbers, and its last iteration's GP (`gp.npz`) and VP
    (`vp.npz`, `serialize.save_vp`, with the logger's ymax in its
    metadata), where the parent holds the kernel against its plain
    version. Returns 0; a
    failed check raises."""
    import torch

    sys.path.insert(0, ROOT)
    from vbmc_tpu_torch import VBMCOptions, kernels
    from vbmc_tpu_torch.serialize import save_vp
    from vbmc_tpu_torch.vp import vp_moments

    kernels.prospective_acq.load()
    kernels.viqr_acq.load()
    D, sd = STRESS_D, STRESS_SD

    def mvn10(x):
        return float(-0.5 * np.sum((x / sd) ** 2)
                     - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)))

    def ratio(res):
        gen = torch.Generator(device="cuda").manual_seed(0)
        _, cov = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5,
                            gen=gen)
        return np.diag(cov.cpu().numpy()) / sd ** 2

    def rungs(res):
        its = res.stats.iterations
        return dict(N=max(it.gp.X.shape[0] for it in its),
                    S=max(it.gp.hyp.shape[0] for it in its),
                    K_iterations=max(it.vp.k_max for it in its),
                    K_final=res.vp.k_max)

    def require(res):
        r = ratio(res)
        return (bool(np.all((r > STRESS_RATIO[0]) & (r < STRESS_RATIO[1])))
                and int(res.vp.kmask.sum()) >= 50 and res.func_count >= 240)

    res, launches, secs, peak = run_target(
        torch, kernels, "prospective_acq", "stress_d10", mvn10, D,
        np.full(D, 0.5), 0.0, np.zeros(D),
        VBMCOptions(display="off", max_fun_evals=STRESS_EVALS, seed=3,
                    min_fun_evals=STRESS_EVALS, min_final_components=50),
        plb=np.full(D, -4.0), pub=np.full(D, 4.0), tol_elbo=1.0,
        require=require,
        note=lambda res: f"K {int(res.vp.kmask.sum())} (train "
                         f"{int(res.vp_train.kmask.sum())}) variance_ratios "
                         f"{np.round(ratio(res), 3).tolist()} "
                         f"seconds_per_iteration "
                         f"{res.timers['total'] / res.iterations:.3f} "
                         f"rungs {rungs(res)}")
    it = res.stats.iterations[-1]
    save_vp(os.path.join(workdir, "vp.npz"), it.vp,
            metadata={"ymax": float(res.logger.ymax)})
    np.savez(os.path.join(workdir, "gp.npz"),
             **{f: getattr(it.gp, f).cpu().numpy()
                for f in ("X", "y", "s2", "mask", "hyp", "hyp_mask", "alpha",
                          "L", "Binv", "sn2")})
    _write_launches(workdir, "stress_child",
                    {"prospective_acq": launches, "viqr_acq": 0,
                     "sym_eig": kernels.sym_eig.launches, "seconds": secs, "peak_device_MiB": peak,
                     "iterations": res.iterations, "rungs": rungs(res)})
    return 0


# Example 6 on the card (`phase_examples`): E6 evaluations, the suite
# blocks' budget, of the default 375. E6_TOL bounds |ELBO - lnZ| and the
# posterior-mean RMSE against `example_truth(6)` by what
# `vbmc_tpu.examples.example_6_noisy_ibs(max_fun_evals=E6, seed=s)` gives on
# the CPU at seeds 6 to 10: the standard 0.5 where it met that at every
# seed (the RMSE: 0.0335 to 0.3289), else 1.5 times its largest error (the
# ELBO: 2.0046 to 8.1937 below lnZ; CHANGES.md, PR 12). One seed does not
# fix a bound: the port's generator is not the JAX package's, and the JAX
# package's own seed-6 run gave 2.0046 and 4.1317 with two thread counts.
# E6_SD_RATIO: the largest observed SD over the smallest, which a target of
# constant SD fails (1.118 to 1.189 in the JAX package at those seeds: the
# IBS variance estimate sums trigamma(K) over the trials, near 11^2
# everywhere; ROADMAP Queue 3 ae).
E6 = 100
E6_TOL = (12.29, 0.5)
E6_SD_RATIO = 1.05
EXAMPLE_TIMEOUT = 1000.0


class StressAlongside:
    """`stress_d10` in a child process (`stress_child`), started on entry
    with one host thread; `gather` waits for it and loads its last GP and
    VP onto the card. On exit the child is killed if it still runs."""

    def __init__(self, workdir):
        self.workdir = os.path.join(workdir, "stress")

    def __enter__(self):
        os.makedirs(self.workdir)
        self.child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.stress_child(sys.argv[1]))", self.workdir],
            cwd=ROOT, env={**os.environ, **ONE_THREAD})
        return self

    def gather(self, torch):
        """The child's numbers and its run's last (gp, vp, ymax)."""
        from vbmc_tpu_torch.gp.gp import GP
        from vbmc_tpu_torch.serialize import load_vp

        rc = self.child.wait(timeout=STRESS_TIMEOUT)
        if rc != 0:
            raise AssertionError(f"stress_child (stress_d10) exited {rc}")
        out = _read_launches(self.workdir, "stress_child")
        with np.load(os.path.join(self.workdir, "gp.npz")) as z:
            gp = GP(**{k: torch.as_tensor(z[k], device="cuda")
                       for k in z.files})
        vp, meta = load_vp(os.path.join(self.workdir, "vp.npz"),
                           device="cuda")
        return out, (gp, vp, meta["ymax"])

    def __exit__(self, *exc):
        if self.child.poll() is None:
            self.child.kill()
            self.child.wait()
        return False


class SurfaceAlongside:
    """The surface runs in other processes, started on entry: `vbmc_sweep`'s
    two worker processes (waited on by a thread) and one child process
    running `surface_child`. On exit the child is killed if it still runs;
    the sweep's workers end at their own timeout."""

    def __init__(self, workdir):
        self.workdir = workdir

    def __enter__(self):
        from concurrent.futures import ThreadPoolExecutor

        import chip_smoke   # the module the sweep's workers import
        from vbmc_tpu_torch.main import vbmc_sweep

        def sweep():
            t = time.monotonic()
            out = vbmc_sweep(chip_smoke.Mvn2(), x0=np.zeros(Mvn2.D),
                             options=_mvn2_opts(max_fun_evals=SWEEP_EVALS),
                             n_runs=2, dispatch="subprocess", device="cuda",
                             workdir=self.workdir, timeout=SURFACE_TIMEOUT,
                             env_per_run=[ONE_THREAD] * 2, **MVN2_BOX)
            return out, time.monotonic() - t

        self.pool = ThreadPoolExecutor(1)
        self.sweep = self.pool.submit(sweep)
        self.child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.surface_child(sys.argv[1]))", self.workdir],
            cwd=ROOT, env={**os.environ, **ONE_THREAD})
        return self

    def __exit__(self, *exc):
        if self.child.poll() is None:
            self.child.kill()
            self.child.wait()
        self.pool.shutdown(wait=True)
        return False


def phase_surface(torch, kernels, alongside):
    """The user surface on the card, each run on `Mvn2` held to the gate:
    here the retry from the best posterior (a warm start from a VP); then
    the runs of ``alongside`` are gathered: the child's tempered target,
    resume of its checkpoint through pre-evaluated values and float32 run,
    and the run sweep in two worker processes with its diagnostics.
    Returns `prospective_acq`'s launches in the retry and the child."""
    import vbmc_tpu_torch.main as vmain
    from vbmc_tpu_torch import VBMCOptions

    D, lnz, mu = Mvn2.D, Mvn2.LNZ, Mvn2.MU
    start = VBMCOptions().resolve(D).fun_eval_start

    f = Mvn2()
    safe_sd = VBMCOptions().resolve(D).best_safe_sd
    # every result `vbmc` returns, the retry's (its inner call) first
    results = []
    real_vbmc = vmain.vbmc

    def recording_vbmc(*args, **kw):
        results.append(real_vbmc(*args, **kw))
        return results[-1]

    def retry_gate(res):
        """The retry's result and the rule's choice, beside the returned
        run's gate: ((err, rmse) of the retry, whether the rule holds)."""
        if len(results) != 2:
            return (np.inf, np.inf), False
        second = results[0]
        if res is second:
            rule = "first_run" in res.timers
        else:
            rule = "first_run" not in res.timers and not (
                second.exitflag >= 1 or second.elbo - safe_sd
                * second.elbo_sd > res.elbo - safe_sd * res.elbo_sd)
        return gate(torch, second.vp, second.elbo, lnz, mu), rule

    def retry_ok(res):
        (err, rmse), rule = retry_gate(res)
        return len(f.calls) > RETRY_EVALS and rule and err < 0.5 \
            and rmse < 0.5

    def retry_note(res):
        (err, rmse), rule = retry_gate(res)
        won = bool(results) and res is results[0]
        return (f"target_calls {len(f.calls)} retry_ran "
                f"{len(f.calls) > RETRY_EVALS} returned the "
                f"{'second' if won else 'first'} run (the rule's choice "
                f"{rule}); the retry's elbo {results[0].elbo:.4f} elbo_sd "
                f"{results[0].elbo_sd:.4f} err {err:.4f} rmse {rmse:.4f}"
                if results else "the retry did not run")

    vmain.vbmc = recording_vbmc
    try:
        _, launches, _, _ = run_target(
            torch, kernels, "prospective_acq", "mvn2_retry", f, D,
            np.zeros(D), lnz, mu,
            _mvn2_opts(max_fun_evals=RETRY_EVALS,
                       retry_max_fun_evals=RETRY_SECOND), **MVN2_BOX,
            # each run's initial design of `start` points is not acquired
            acquired=lambda res: len(f.calls) - 2 * start,
            require=retry_ok, note=retry_note)
    finally:
        vmain.vbmc = real_vbmc

    rc = alongside.child.wait(timeout=SURFACE_TIMEOUT)
    if rc != 0:
        raise AssertionError(f"surface_child (mvn2_tempered, mvn2_resume, "
                             f"mvn2_float32) exited {rc}")
    launches += _read_launches(alongside.workdir,
                               "surface_child")["prospective_acq"]
    (diag, runs), secs = alongside.sweep.result()
    gates = [gate(torch, vp, elbo, lnz, mu) for vp, elbo, _, _ in runs]
    ok = all(e < 0.5 and r < 0.5 for e, r in gates)
    log(f"[e2e] mvn2_sweep: 2 worker processes on the card, {secs:.1f} s "
        f"from their start to the diagnostics; "
        f"elbos {[round(r[1], 4) for r in runs]} (lnZ {lnz}) errs "
        f"{[round(e, 4) for e, _ in gates]} rmses "
        f"{[round(r, 4) for _, r in gates]} func_counts "
        f"{[r[3]['func_count'] for r in runs]}; diagnostics exitflag "
        f"{diag.exitflag} best {diag.best} sKL {diag.skl_matrix[0, 1]:.4g} "
        f"MTV {diag.mtv_matrix[0, 1]:.4g} ({diag.message}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mvn2_sweep: end-to-end gate failed")
    return launches


def phase_queries(torch, res6):
    """The posterior and GP queries at the last VP and GP of the `mvn_6d`
    run: on the card against the same call on CPU copies, float64. The
    deterministic ones to a stated tolerance, the sampled ones by their
    moments within Monte-Carlo error (the card's and the CPU's generators
    differ), each with its CUDA-event time on the card."""
    from vbmc_tpu_torch.gp.config import GPConfig
    from vbmc_tpu_torch.gp.sample import (gp_fmin, gp_quantile_pred, gp_rnd,
                                          gp_sample)
    from vbmc_tpu_torch.optim import value_and_grad
    from vbmc_tpu_torch.samplers.mala import mala_sample
    from vbmc_tpu_torch.vp import (vp_log_pdf_trans, vp_mode, vp_mtv, vp_pdf,
                                   vp_power, vp_rnd, vp_train2real)

    it = res6.stats.iterations[-1]
    # vp_mtv compares the last VP with the first iteration's, whose
    # marginals differ from it by far more than the Monte-Carlo error
    gp, vp, vp2 = it.gp, it.vp, res6.stats.iterations[0].vp
    cfg = GPConfig(D=vp.D)
    gp_c, vp_c, vp2_c = (cast_tree(torch, o, device="cpu")
                         for o in (gp, vp, vp2))
    shape = (f"N={gp.X.shape[0]} S={gp.hyp.shape[0]} K={int(vp.kmask.sum())} "
             f"D={vp.D} float64")

    def gen(dev, seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def report(name, ok, what, ms):
        log(f"[query] {name} {shape}: {what}; card {ms:.3f} ms: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: the card and the CPU disagree")

    def once(fn):
        """One call on the card and its CUDA-event time."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    X = vp_rnd(vp_c, gen("cpu", 5), 4096)
    Xd = X.cuda()
    with torch.no_grad():
        got = vp_pdf(vp, Xd, log_flag=True).cpu()
        ref = vp_pdf(vp_c, X, log_flag=True)
        err = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
        report("vp_pdf", err <= QUERY_RTOL,
               f"4096 points, max |card - cpu| / max(|cpu|, 1) {err:.3e} "
               f"(rule {QUERY_RTOL})",
               cuda_time_ms(torch, lambda: vp_pdf(vp, Xd, log_flag=True)))

        (pw, lnz_pow), ms = once(lambda: vp_power(vp, return_lnz=True))
        pw_c, lnz_c = vp_power(vp_c, return_lnz=True)
        _, e_card, _ = vp_train2real(vp, 2, res6.elbo, res6.elbo_sd)
        _, e_cpu, _ = vp_train2real(vp_c, 2, res6.elbo, res6.elbo_sd)
        errs = [abs(lnz_pow - lnz_c) / abs(lnz_c), abs(e_card - e_cpu)
                / abs(e_cpu)] + [float(((getattr(pw, k).cpu() - getattr(
                    pw_c, k)).abs() / getattr(pw_c, k).abs().clamp_min(
                    1e-300)).max()) for k in ("w", "mu", "sigma")]
        report("vp_power/vp_train2real", max(errs) <= QUERY_RTOL,
               f"{int(pw.kmask.sum())} product components, lnZ_pow "
               f"{lnz_pow:.6f}, largest relative difference {max(errs):.3e} "
               f"(rule {QUERY_RTOL})", ms)

    xm, ms = once(lambda: vp_mode(vp))
    xm_c = vp_mode(vp_c)
    err = float((xm.cpu() - xm_c).abs().max())
    report("vp_mode", err <= 1e-6, f"mode {np.round(xm_c.numpy(), 4)}, max "
           f"|card - cpu| {err:.3e} (rule 1e-6)", ms)

    with torch.no_grad():
        Xs = gp.X[gp.mask][:64]
        q, ms = once(lambda: gp_quantile_pred(cfg, gp, Xs))
        q_c = gp_quantile_pred(cfg, gp_c, Xs.cpu())
        err = float(((q.cpu() - q_c).abs() / q_c.abs().clamp_min(1.0)).max())
        report("gp_quantile_pred", err <= 1e-8,
               f"{Xs.shape[0]} points, 3 quantiles, max |card - cpu| / "
               f"max(|cpu|, 1) {err:.3e} (rule 1e-8)", ms)
    (xf, ff), ms = once(lambda: gp_fmin(cfg, gp, maximize=True))
    xf_c, ff_c = gp_fmin(cfg, gp_c, maximize=True)
    err_x = float((xf.cpu() - xf_c).abs().max())
    err_f = abs(ff - ff_c) / max(abs(ff_c), 1.0)
    report("gp_fmin", err_x <= 1e-6 and err_f <= 1e-9,
           f"maximum {ff_c:.6f}, max |x card - x cpu| {err_x:.3e} (rule "
           f"1e-6), |f card - f cpu| {err_f:.3e} (rule 1e-9)", ms)

    n = 20000
    Xr = gp.X[gp.mask][:8]
    F, ms = once(lambda: gp_rnd(cfg, gp, Xr, gen=gen("cuda", 1), n_draws=n))
    F_c = gp_rnd(cfg, gp_c, Xr.cpu(), gen=gen("cpu", 1), n_draws=n)
    F, F_c = F.cpu().numpy(), F_c.numpy()
    var = np.maximum(F_c.var(0), 1e-300)
    err_m = float(np.max(np.abs(F.mean(0) - F_c.mean(0))
                         / np.sqrt(2 * var / n)))
    err_c = float(np.max(np.abs(np.cov(F.T) - np.cov(F_c.T)))
                  / (2 * var.max() / np.sqrt(n)))
    report("gp_rnd", err_m < 5 and err_c < 5,
           f"{n} joint draws at 8 points; means differ by {err_m:.2f} and "
           f"covariances by {err_c:.2f} of their standard errors (rule 5)",
           ms)

    seeds = range(2, 2 + MTV_SEEDS)
    m, ms = once(lambda: vp_mtv(vp, vp2, gen=gen("cuda", seeds[0])))
    card = np.stack([m.cpu().numpy()] + [vp_mtv(vp, vp2, gen=gen(
        "cuda", s)).cpu().numpy() for s in seeds[1:]])
    cpu = np.stack([vp_mtv(vp_c, vp2_c, gen=gen("cpu", s)).numpy()
                    for s in seeds])
    se = np.sqrt((card.var(0, ddof=1) + cpu.var(0, ddof=1)) / MTV_SEEDS)
    z = np.abs(card.mean(0) - cpu.mean(0)) / se
    report("vp_mtv", bool(np.all(z <= 5)),
           f"last VP against the first iteration's, 1e5 draws, {MTV_SEEDS} "
           f"seeds a side: card {np.round(card.mean(0), 4)} cpu "
           f"{np.round(cpu.mean(0), 4)}, {np.round(cpu.mean(0) / se, 1)} "
           f"standard errors; they differ by {np.round(z, 2)} of them "
           f"(rule 5)", ms)

    def by_replicates(name, draw, what):
        """Both sides' mean over REPLICATES independent chains each (seeds
        1, 2, ...): the difference of the two against the standard error
        that the spread of the replicates' means gives (a chain's own
        batch means underestimate it: its draws are correlated over more
        sweeps than a short chain has batches). Times the card's first
        chain."""
        card, ms = [], 0.0
        for k in range(REPLICATES):
            out, t = once(lambda: draw("cuda", k + 1))
            card.append(out.cpu().numpy().mean(0))
            ms = ms or t
        cpu = np.stack([draw("cpu", k + 1).numpy().mean(0)
                        for k in range(REPLICATES)])
        card = np.stack(card)
        se = np.sqrt((card.var(0, ddof=1) + cpu.var(0, ddof=1)) / REPLICATES)
        z = np.abs(card.mean(0) - cpu.mean(0)) / se
        report(name, bool(np.all(z <= 5)),
               f"{what}, {REPLICATES} chains a side: means differ by "
               f"{np.round(z, 2)} of their standard error (rule 5)", ms)

    by_replicates("gp_sample", lambda dev, k: gp_sample(
        cfg, gp if dev == "cuda" else gp_c, 700, gen=gen(dev, k)),
        "700 draws a chain from exp(GP mean)")

    def lp_grad(v):
        return lambda x: tuple(a[0] for a in value_and_grad(
            lambda z: vp_log_pdf_trans(v, z), x[None, :]))

    x0 = (vp.w[:, None] * vp.mu).sum(0)
    by_replicates("mala_sample", lambda dev, k: mala_sample(
        gen(dev, k), lp_grad(vp if dev == "cuda" else vp_c), x0.to(dev),
        1000, step0=0.5, burn=300)[0],
        "1000 steps a chain after 300 on the last VP's density")


# Independent chains a side for the sampled queries, and seeds a side for
# `vp_mtv`.
REPLICATES = 4
MTV_SEEDS = 6
# The card against the CPU for the deterministic queries in float64: both
# run the same PyTorch code and differ in the order of their sums only.
QUERY_RTOL = 1e-10


# The pipelined window of the microbenchmark's rows here (its command line
# takes 200 ms).
TWIN_WINDOW_S = 0.05
TWIN_NUMBERS = ("ms_pipelined", "ms_single", "tflops", "mfu_f64roof")


def phase_bench_kernels(torch):
    """`vbmc_tpu_torch.bench_kernels` at its default shape: the probe and
    every row, each row's numbers finite and each `_cuda` row with its
    kernel launched. Returns the rows."""
    from vbmc_tpu_torch import bench_kernels

    rows = bench_kernels.run(
        *bench_kernels.DEFAULTS, "cuda", window_s=TWIN_WINDOW_S,
        emit=lambda r: log(f"[bench_kernels] {json.dumps(r)}"))
    probe, timed = rows[0], rows[1:]
    if not np.isfinite(probe["value"]) or probe["value"] <= 0:
        raise AssertionError(f"bench_kernels: probe reads {probe['value']}")
    if len(timed) != 8:
        raise AssertionError(f"bench_kernels: {len(timed)} rows, not 8")
    for r in timed:
        bad = [k for k in TWIN_NUMBERS if not np.isfinite(r[k])]
        bad += [k for k in ("launches", "device_ms", "mfu")
                if r[k] is not None and not np.isfinite(r[k])]
        if bad:
            raise AssertionError(f"bench_kernels {r['metric']}: {bad} not "
                                 f"finite")
    by_metric = {r["metric"]: r for r in timed}
    for row, name in (("acquisition_sweep_8k_cuda", "prospective_acq"),
                      ("viqr_sweep_8k_cuda", "viqr_acq")):
        if not by_metric[f"kernel_{row}_ms"]["sweep_launches"][name] > 0:
            raise AssertionError(f"bench_kernels {row}: {name} was not "
                                 f"launched")
    log(f"[bench_kernels] {len(timed)} rows at N=256 S=16 K=16 M=8192: ok")
    return rows


def check_dmma(libs):
    """The float64 products of both sweep libraries must have compiled to
    DMMA (FP64 tensor-core) opcodes: count them in the SASS."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("prospective_acq", "viqr_acq"):
        lib = libs[name]
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        dmma = [ln.strip() for ln in sass.splitlines() if "DMMA" in ln]
        log(f"[build] {name}: {len(dmma)} DMMA opcodes in the SASS"
            + (f", e.g. `{' '.join(dmma[0].split())}`" if dmma else ""))
        if not dmma:
            raise AssertionError(f"{name}: no DMMA opcode in the SASS; "
                                 "the float64 products are not on the "
                                 "tensor cores")


# The oracle of the bundled worked examples (`vbmc_tpu_torch/examples.py`):
# their targets written out again here in numpy and scipy, integrated on a
# grid. Each axis is cut into equal panels with TRUTH_NODES Gauss-Legendre
# nodes each; ``refine`` multiplies the panels.
TRUTH_NODES = 8
# The share of the mass allowed within one grid step of a box edge that is
# not the prior's own bound (a cut of the grid, not of the target).
TRUTH_EDGE_MASS = 1e-6
# Example 6: the psychometric model's data (`examples.py:119-122`), its hard
# bounds and the Laplace box's half-width in SDs.
PSYCHO_TRIALS, PSYCHO_TRUE = 200, (0.5, 0.0, 0.05)
PSYCHO_LB, PSYCHO_UB = (-5.0, -3.0, 0.005), (5.0, 3.0, 0.5)
PSYCHO_BOX_SDS = 8.0


def _gl_axis(lo, hi, panels):
    """Nodes and weights of ``panels`` equal Gauss-Legendre panels on
    [lo, hi]."""
    t, w = np.polynomial.legendre.leggauss(TRUTH_NODES)
    edges = np.linspace(lo, hi, panels + 1)[:, None]
    half = (edges[1:] - edges[:-1]) / 2
    return (edges[:-1] + half + half * t).ravel(), (half * w).ravel()


def psycho_data():
    """Stimuli, responses and the per-trial sign of example 6: the data of
    `example_6_noisy_ibs` (`default_rng(0)`, then the simulator at the true
    parameters, whose probit link is ``ndtr``)."""
    from scipy import special

    rng = np.random.default_rng(0)
    s = rng.uniform(-3, 3, PSYCHO_TRIALS)
    mu, log_sigma, lapse = PSYCHO_TRUE
    p = lapse / 2 + (1 - lapse) * special.ndtr((s - mu) / np.exp(log_sigma))
    r = (rng.random(PSYCHO_TRIALS) < p).astype(int)
    return s, r


def psycho_loglike(theta, s, r):
    """The exact log-likelihood of example 6 at parameters ``theta`` (..., 3):
    sum over trials of log p(response), with p(right) = lapse/2 + (1 -
    lapse) Phi((s - mu) / sigma). The lapse floor (lapse/2 >= 0.0025 on the
    box) keeps every log finite."""
    theta = np.asarray(theta, float)
    mu, ls, lam = (theta[..., i, None] for i in range(3))
    return np.log(lam / 2 + (1 - lam) * _psycho_q(mu, ls, s, r)).sum(-1)


def _psycho_q(mu, log_sigma, s, r):
    """Phi((s - mu) / sigma) for a right response, its complement for a
    left one: the probability of each observed response without lapses."""
    from scipy import special

    return special.ndtr(np.where(r == 1, 1.0, -1.0) * (s - mu)
                        / np.exp(log_sigma))


def _psycho_box():
    """Example 6's mode (L-BFGS-B on the exact log-likelihood in the hard
    bounds), its value, and the box of PSYCHO_BOX_SDS Laplace SDs (from a
    central-difference Hessian) around it, clipped to the bounds."""
    from scipy import optimize

    s, r = psycho_data()
    lb, ub = np.array(PSYCHO_LB), np.array(PSYCHO_UB)
    opt = optimize.minimize(lambda t: -psycho_loglike(t, s, r),
                            np.array(PSYCHO_TRUE), method="L-BFGS-B",
                            bounds=list(zip(lb, ub)))
    x, h = opt.x, 1e-4 * (ub - lb)
    H = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            d = [np.eye(3)[i] * h[i] * a + np.eye(3)[j] * h[j] * b
                 for a, b in ((1, 1), (1, -1), (-1, 1), (-1, -1))]
            f = psycho_loglike(x + np.array(d), s, r)
            H[i, j] = -(f[0] - f[1] - f[2] + f[3]) / (4 * h[i] * h[j])
    if not np.all(np.linalg.eigvalsh(H) > 0):
        raise AssertionError(f"example 6: the Hessian at the mode {x} is not "
                             f"positive definite")
    sd = np.sqrt(np.diag(np.linalg.inv(H)))
    return (x, -opt.fun, np.maximum(x - PSYCHO_BOX_SDS * sd, lb),
            np.minimum(x + PSYCHO_BOX_SDS * sd, ub))


def _rosenbrock(x1, x2):
    return -((x1 ** 2 - x2) ** 2) / 2 - (x1 ** 2 + x2 ** 2) / 2


def _smoothbox(x, a=-2.0, b=2.0, sigma=0.4):
    """The smooth-box prior's log density (`msmoothboxpdf.m`): flat on
    [a, b], Gaussian tails of scale sigma."""
    out = np.where(x < a, x - a, np.where(x > b, x - b, 0.0))
    return (-0.5 * (out / sigma) ** 2
            - np.log(b - a + sigma * np.sqrt(2 * np.pi)))


# The 2-D examples: (log density, per-axis box, whether each box edge is the
# prior's own bound, panels per axis). The grids reach where the density is
# below e^-40 of its peak, so the mass within a step of a cut edge is far
# below 1e-10; their panel edges fall on the smooth-box prior's kinks.
_HALFNORM_SD = np.array([1.0, 0.6])
TRUTH_2D = {
    1: (_rosenbrock, (-9.0, 9.0), False, 144),
    2: (lambda x1, x2: (-0.5 * ((x1 / _HALFNORM_SD[0]) ** 2
                                + (x2 / _HALFNORM_SD[1]) ** 2)
                        - np.log(2 * np.pi) - np.sum(np.log(_HALFNORM_SD))),
        (0.0, 10.0), True, 80),
    5: (lambda x1, x2: (-0.5 * (x1 ** 2 + x2 ** 2) / 0.8 ** 2
                        + _smoothbox(x1) + _smoothbox(x2)),
        (-8.0, 8.0), False, 128),
}
TRUTH_2D[3] = TRUTH_2D[4] = TRUTH_2D[1]


def example_truth(n, refine=1):
    """lnZ, the posterior mean and the marginal variances of worked example
    ``n``'s target (the log of the integral of exp(target) over its box) by
    grid quadrature, with the grid's points and the largest share of the
    mass within one grid step of a box edge that is not a bound of the
    prior. Examples 1, 3 and 4: `rosenbrock_test` on [-9, 9]^2; 2: the
    half-normal on [0, 10]^2 (lnZ = log 0.25); 5: the Gaussian likelihood
    times the smooth-box prior on [-8, 8]^2; 6: the psychometric model's
    exact likelihood over (mu, log sigma, lapse), flat on the hard bounds,
    on the box of PSYCHO_BOX_SDS Laplace SDs around the mode, clipped to
    the bounds (about 10^6 points). ``refine``: panels per axis times this.
    Raises if the mass within a step of a cut edge exceeds
    TRUTH_EDGE_MASS."""
    if n == 6:
        mode, top, lo, hi = _psycho_box()
        bound = [(lo[i] == PSYCHO_LB[i], hi[i] == PSYCHO_UB[i])
                 for i in range(3)]
        axes = [_gl_axis(lo[i], hi[i], p * refine)
                for i, p in enumerate((16, 16, 8))]
        s, r = psycho_data()
        M, LS = np.meshgrid(axes[0][0], axes[1][0], indexing="ij")
        q = _psycho_q(M[..., None], LS[..., None], s, r)
        w2 = axes[0][1][:, None] * axes[1][1][None, :]
        dens = np.empty([len(a[0]) for a in axes])
        for k, (lam, wl) in enumerate(zip(*axes[2])):
            ll = np.log(lam / 2 + (1 - lam) * q).sum(-1)
            dens[:, :, k] = np.exp(ll - top) * w2 * wl
    else:
        logp, (a, b), is_bound, panels = TRUTH_2D[n]
        axes = [_gl_axis(a, b, panels * refine)] * 2
        bound = [(is_bound, is_bound)] * 2
        X1, X2 = np.meshgrid(axes[0][0], axes[1][0], indexing="ij")
        lp = logp(X1, X2)
        top = lp.max()
        dens = np.exp(lp - top) * axes[0][1][:, None] * axes[1][1][None, :]
    Z = dens.sum()
    mean, var, edge = [], [], 0.0
    for i, (x, _) in enumerate(axes):
        marg = dens.sum(tuple(j for j in range(dens.ndim) if j != i)) / Z
        m = float(marg @ x)
        mean.append(m)
        var.append(float(marg @ (x - m) ** 2))
        step = (x[-1] - x[0]) / (len(x) - 1)
        for near, is_bound in ((x < x[0] + step, bound[i][0]),
                               (x > x[-1] - step, bound[i][1])):
            if not is_bound:
                edge = max(edge, float(marg[near].sum()))
    if edge > TRUTH_EDGE_MASS:
        raise AssertionError(f"example {n}: {edge:.3g} of the mass lies "
                             f"within a grid step of a cut edge (limit "
                             f"{TRUTH_EDGE_MASS})")
    return dict(lnz=float(np.log(Z) + top), mean=np.array(mean),
                var=np.array(var), points=dens.size, edge_mass=edge)


def example_child(workdir):
    """Example 6, `example_6_noisy_ibs(max_fun_evals=E6, device="cuda")`, the
    example's own function at its bundled 200 trials and two IBS repeats:
    the child process of `ExampleAlongside` (the parent has built the
    kernels), whose display goes to ``workdir``/display.txt. Leaves in
    ``workdir`` its numbers (`example6.json`: ELBO, exit flag, launches,
    acquired points, per-point full updates, the observed SDs' range, the
    posterior mean on the card, timers), its last iteration's GP (`gp.npz`)
    and VP (`vp.npz`, with the logger's ymax and the hard-bound epsilon box
    in its metadata). Returns 0."""
    import torch

    sys.path.insert(0, ROOT)
    from vbmc_tpu_torch import VBMCOptions, kernels
    from vbmc_tpu_torch.active_sample import _hard_bound_eps
    from vbmc_tpu_torch.examples import example_6_noisy_ibs
    from vbmc_tpu_torch.serialize import save_vp
    from vbmc_tpu_torch.vp import vp_moments

    kernels.prospective_acq.load()
    kernels.viqr_acq.load()
    sweeps = (kernels.prospective_acq, kernels.viqr_acq, kernels.sym_eig)
    torch.cuda.reset_peak_memory_stats()
    for k in sweeps:
        k.launches = k.launches_f32 = 0
    t = time.monotonic()
    res = example_6_noisy_ibs(max_fun_evals=E6, device="cuda")
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    launches = {k.name: k.launches for k in sweeps}
    opt = VBMCOptions(specify_target_noise=True).resolve(3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5, gen=gen)
    lg = res.logger
    sd = lg.S[:lg.Xn]
    it = res.stats.iterations[-1]
    lb_eps, ub_eps = _hard_bound_eps(lg, opt)
    save_vp(os.path.join(workdir, "vp.npz"), it.vp,
            metadata={"ymax": float(lg.ymax), "lb_eps": lb_eps.tolist(),
                      "ub_eps": ub_eps.tolist()})
    np.savez(os.path.join(workdir, "gp.npz"),
             **{f: getattr(it.gp, f).cpu().numpy()
                for f in ("X", "y", "s2", "mask", "hyp", "hyp_mask", "alpha",
                          "L", "Binv", "sn2")})
    with open(os.path.join(workdir, "example6.json"), "w") as f:
        json.dump(dict(
            elbo=res.elbo, elbo_sd=res.elbo_sd, exitflag=int(res.exitflag),
            func_count=int(res.func_count), iterations=res.iterations,
            acquired=int(res.func_count) - opt.fun_eval_start,
            launches=launches, quick_updates=int(res.quick_updates),
            sd_min=float(sd.min()), sd_max=float(sd.max()),
            mean=mean.cpu().tolist(), seconds=secs,
            peak_device_MiB=torch.cuda.max_memory_allocated() / 2 ** 20,
            timers={k: round(v, 2) for k, v in res.timers.items()}), f)
    return 0


class ExampleAlongside(StressAlongside):
    """Example 6 in a child process (`example_child`), started on entry with
    one host thread, its display in a file; `gather` waits for it and loads
    its numbers and its last GP and VP onto the card. On exit the child is
    killed if it still runs."""

    def __init__(self, workdir):
        self.workdir = os.path.join(workdir, "example6")

    def __enter__(self):
        os.makedirs(self.workdir)
        self.display = open(os.path.join(self.workdir, "display.txt"), "w")
        self.child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.example_child(sys.argv[1]))", self.workdir],
            cwd=ROOT, env={**os.environ, **ONE_THREAD}, stdout=self.display)
        return self

    def gather(self, torch):
        """The child's numbers and its run's last (gp, vp, meta)."""
        from vbmc_tpu_torch.gp.gp import GP
        from vbmc_tpu_torch.serialize import load_vp

        rc = self.child.wait(timeout=EXAMPLE_TIMEOUT)
        self.display.close()
        with open(os.path.join(self.workdir, "display.txt")) as f:
            tail = f.read().splitlines()[-3:]
        log("[e2e] example_6_noisy_ibs display: " + " | ".join(tail))
        if rc != 0:
            raise AssertionError(f"example_child (example_6_noisy_ibs) "
                                 f"exited {rc}")
        with open(os.path.join(self.workdir, "example6.json")) as f:
            out = json.load(f)
        with np.load(os.path.join(self.workdir, "gp.npz")) as z:
            gp = GP(**{k: torch.as_tensor(z[k], device="cuda")
                       for k in z.files})
        vp, meta = load_vp(os.path.join(self.workdir, "vp.npz"),
                           device="cuda")
        return out, (gp, vp, meta)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.display.close()
        return False


def phase_examples(out, truth):
    """Example 6's run (the numbers `example_child` left, ``out``) against
    its quadrature oracle ``truth`` (`example_truth(6)`): exit flag >= 0, at
    least one `viqr_acq` launch per acquired point, at least one per-point
    full update, observed SDs whose largest is at least E6_SD_RATIO times
    the smallest, and |ELBO - lnZ| and the posterior-mean RMSE within
    E6_TOL. Depth: E6 evaluations of the default 375 (`max_fun_evals`); the
    width is the example's own (200 trials, two IBS repeats, D=3)."""
    err = abs(out["elbo"] - truth["lnz"])
    rmse = float(np.sqrt(np.mean((np.array(out["mean"]) - truth["mean"])
                                 ** 2)))
    ratio = out["sd_max"] / out["sd_min"]
    ok = (out["exitflag"] >= 0 and np.isfinite(out["elbo"])
          and out["launches"]["viqr_acq"] >= out["acquired"] > 0
          and out["quick_updates"] >= 1 and ratio >= E6_SD_RATIO
          and err < E6_TOL[0] and rmse < E6_TOL[1])
    log(f"[e2e] example_6_noisy_ibs (in a child process): elbo "
        f"{out['elbo']:.4f} (lnZ {truth['lnz']:.4f} by quadrature on "
        f"{truth['points']} points, err {err:.4f}, bound {E6_TOL[0]}) elbo_sd "
        f"{out['elbo_sd']:.4f} mean {np.round(out['mean'], 4).tolist()} "
        f"(oracle {np.round(truth['mean'], 4).tolist()}, rmse {rmse:.4f}, "
        f"bound {E6_TOL[1]}) exitflag {out['exitflag']} func_count "
        f"{out['func_count']} iterations {out['iterations']} seconds "
        f"{out['seconds']:.1f} kernel_launches {out['launches']} "
        f"acquired_points {out['acquired']} quick_updates "
        f"{out['quick_updates']} observed SDs {out['sd_min']:.4f} to "
        f"{out['sd_max']:.4f} (ratio {ratio:.4f}, at least {E6_SD_RATIO}) "
        f"peak_device_MiB {out['peak_device_MiB']:.1f} timers "
        f"{out['timers']}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("example_6_noisy_ibs: end-to-end gate failed")


def compare_example(torch, kernels, last):
    """`viqr_acq` against its plain version and every plain acquisition
    against the CPU at example 6's last GP and VP, ``last`` = (gp, vp,
    meta), as `compare_noisy` does at the noisy half-normal's. Returns the
    kernel's comparison."""
    from vbmc_tpu_torch import VBMCOptions

    gp, vp, meta = last
    return compare_noisy(torch, kernels, "example_6_noisy_ibs", gp, vp,
                         meta["ymax"], (np.array(meta["lb_eps"]),
                                        np.array(meta["ub_eps"])),
                         VBMCOptions(specify_target_noise=True).resolve(3))


def kernels_line(results, main_path, launches):
    """The JSON line of every kernel's numbers: the headline numbers are
    those at the main path's shape, `all` has every shape."""
    replaces = {"prospective_acq": "vbmc_tpu/pallas_kernels.py:157",
                "viqr_acq": "vbmc_tpu/pallas_kernels.py:337",
                "sym_eig": "no TPU kernel: jnp.linalg.eigh in "
                           "vbmc_tpu/samplers/cmaes.py"}
    head = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "exp_evals")
    return json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"vbmc_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"]
                           for r in results[name] + [main_path[name]]
                           if "float64" in r["tag"]),
        **{k: main_path[name][k] for k in head},
        "timed_at": main_path[name]["tag"],
        "all": results[name] + [main_path[name]]}
        for name in ("prospective_acq", "viqr_acq", "sym_eig")]})


def main():
    import torch

    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} (no arguments)", file=sys.stderr)
        return 2
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
    check_dmma(libs)

    results = phase_kernels(torch, kernels)
    results["sym_eig"] = phase_sym_eig(torch, kernels)
    launches = {"prospective_acq": 0, "viqr_acq": 0}
    kernels.sym_eig.launches = kernels.sym_eig.launches_f32 = 0
    # From here until the stress run is gathered other processes share the
    # card, so nothing is timed: the comparisons at the runs' last GPs and
    # the queries come after.
    with tempfile.TemporaryDirectory() as workdir:
        with StressAlongside(workdir) as stress, \
                ExampleAlongside(workdir) as example:
            launches["prospective_acq"], res6 = phase_noiseless(torch,
                                                                kernels)
            launches["viqr_acq"], res_noisy = phase_noisy(torch, kernels)
            with SurfaceAlongside(workdir) as alongside:
                launches["viqr_acq"] += phase_repeat(torch, kernels)
                launches["prospective_acq"] += phase_surface(
                    torch, kernels, alongside)
            out_e6, last_e6 = example.gather(torch)
            out, last_stress = stress.gather(torch)
        launches["prospective_acq"] += out["prospective_acq"]
        launches["sym_eig"] = kernels.sym_eig.launches + out["sym_eig"] \
            + out_e6["launches"]["sym_eig"] \
            + _read_launches(alongside.workdir, "surface_child")["sym_eig"]
    log(f"[e2e] stress_d10 (in a child process): {out}")
    phase_examples(out_e6, example_truth(6))
    launches["viqr_acq"] += out_e6["launches"]["viqr_acq"]
    launches["prospective_acq"] += out_e6["launches"]["prospective_acq"]

    r6 = compare_at_last_gp(torch, kernels, "mvn_6d", _last(res6), 6)
    phase_queries(torch, res6)
    del res6
    main_v = compare_halfnorm_noisy(torch, kernels, res_noisy)
    del res_noisy
    results["viqr_acq"].append(compare_example(torch, kernels, last_e6))
    compare_cmaes_viqr(torch, last_e6)
    del last_e6
    main_p = compare_at_last_gp(torch, kernels, "stress_d10", last_stress,
                                STRESS_D)
    compare_cmaes_prospective(torch, "stress_d10 prospective", last_stress,
                              STRESS_D)
    results["prospective_acq"].append(r6)
    main_path = {"prospective_acq": main_p, "viqr_acq": main_v,
                 "sym_eig": results["sym_eig"].pop(next(
                     i for i, r in enumerate(results["sym_eig"])
                     if r["tag"] == "D=10 float64"))}
    phase_bench_kernels(torch)

    log(f"[env] nvidia-smi: {smi}")
    log(kernels_line(results, main_path, launches))
    if not launches["sym_eig"] > 0:
        raise AssertionError("sym_eig: no launch counted on the main path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
