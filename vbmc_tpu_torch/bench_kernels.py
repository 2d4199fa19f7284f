"""Microbenchmarks of the port's hot layers on one NVIDIA GPU: the jax-free
twin of the JAX package's `bench_kernels.py`.

    python -m vbmc_tpu_torch.bench_kernels [N] [S] [K] [M] [--device cpu]

N training points, S hyperparameter samples, K VP components, M candidates
(defaults 256, 16, 16, 8192) at D=6, float64 (the main path's dtype). The
inputs are `bench_kernels.py`'s own, drawn from ``default_rng(0)`` in its
order; every draw on the device takes an explicit `torch.Generator`. It
runs on the card unless ``--device cpu`` is given; without a card the
default exits 2, and nothing moves to the CPU on its own.

Rows, one JSON line each on stdout under `bench_kernels.py`'s metric names
and fields (progress and a readable summary go to stderr):

- ``device_probe``: cuBLAS DGEMM and SGEMM (``allow_tf32=False``) at 4096
  by CUDA events, beside the documented FP64 peak of the card (`peak_for`).
  A DGEMM over 1.05x the documented peak means the timer is broken: the
  script says so and exits 1.
- ``kernel_<name>_ms`` for ``gp_posterior_build`` (`gp.gp.build_gp`),
  ``acquisition_sweep_8k`` (`acquisitions.evaluate_acquisition`, plain),
  ``acquisition_sweep_8k_cuda`` (`kernels.prospective_acq`, card only),
  ``viqr_sweep_8k`` (`active_is.evaluate_is_acquisition`, plain),
  ``viqr_sweep_8k_cuda`` (`active_is.sweep_is_acquisition`, which
  launches `kernels.viqr_acq`; card only), ``elbo_value_and_grad``
  (`elbo.negelcbo` and `torch.autograd.grad`), ``slice_sweep_nlz`` (one
  sweep of `samplers.slice.slice_sample_chains` over the hyperparameters
  on -nlZ) and ``ensemble_sweep_nlz`` (`samplers.ensemble.
  ensemble_slice_final` for one step on -nlZ), each with the FLOP count
  `bench_kernels.py` gives it.

Each row carries ``ms_pipelined`` (R distinct calls, input i perturbed by
i * 1e-12, between two CUDA events; R grows until the window is at least
200 ms) and ``ms_single`` (the median of 5 single calls on the host clock,
each ending in `torch.cuda.synchronize`). What separates them is host
launch cost and host syncs. From `torch.profiler` over one call: the CUDA
kernels it launched (``launches``), their summed device time
(``device_ms``) and its device-to-host copies (``dtoh_copies``; each
`bool()` or `float()` of a device tensor is one, and a host sync); null,
and said so on stderr, where the profiler saw no kernel or on the CPU.
``sweep_launches`` is how far each sweep kernel's launch counter moved
over the row: a ``_cuda`` row that launched nothing fails. Then
``flops``, ``tflops``, ``peak_tflops`` and ``mfu`` against the documented
peak, ``mfu_f64roof`` against the measured DGEMM, the device and N, S, K,
M. The L2 cache is not flushed between pipelined calls, as in
`bench_kernels.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from vbmc_tpu_torch import kernels
from vbmc_tpu_torch import elbo as eb
from vbmc_tpu_torch.acquisitions import AcqState, evaluate_acquisition
from vbmc_tpu_torch.active_is import (build_is_state_core,
                                      evaluate_is_acquisition,
                                      sweep_is_acquisition)
from vbmc_tpu_torch.bench import device_info
from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.core import neg_log_marginal_likelihood
from vbmc_tpu_torch.gp.gp import build_gp, gp_from_host
from vbmc_tpu_torch.samplers.ensemble import ensemble_slice_final
from vbmc_tpu_torch.samplers.slice import slice_sample_chains
from vbmc_tpu_torch.transforms import create_trinfo
from vbmc_tpu_torch.vp import make_vp

D = 6
DEFAULTS = (256, 16, 16, 8192)   # N, S, K, M of `bench_kernels.py`
DTYPE = torch.float64
# Documented dense FP64 peak of a card, TFLOP/s, by the name
# `torch.cuda.get_device_name` gives: NVIDIA's H100 SXM data sheet, FP64 on
# the tensor cores, at its 700 W power limit.
DOCUMENTED_PEAK_F64 = {"NVIDIA H100 80GB HBM3": 67.0}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, FP64 tensor core, 700 W"
# A DGEMM over this multiple of the documented peak means the timer is
# broken.
MAX_FRAC_OF_PEAK = 1.05
PROBE_N = 4096
WINDOW_S = 0.2
MAX_REPS = 4096
SINGLE_REPS = 5


class BrokenTimer(RuntimeError):
    """The measured DGEMM beats the documented peak."""


def peak_for(kind: str):
    """(peak TFLOP/s, key) of the longest documented name that ``kind``
    starts with, or (None, None)."""
    for key in sorted(DOCUMENTED_PEAK_F64, key=len, reverse=True):
        if kind.lower().startswith(key.lower()):
            return DOCUMENTED_PEAK_F64[key], key
    return None, None


@dataclasses.dataclass
class Inputs:
    cfg: GPConfig
    N: int
    S: int
    K: int
    M: int
    hyps: np.ndarray          # (S, nhyp) host hyperparameter samples
    gp: object                # gp.gp.GP
    vp: object                # vp.VariationalPosterior
    Xs: torch.Tensor          # (M, D) candidates
    state: AcqState
    ais: object               # active_is.ISState


def host_inputs(N: int, S: int, K: int, M: int):
    """The numpy draws of `bench_kernels.py:174-231`, from ``default_rng(0)``
    in its order: (cfg, X, y, hyps, VP means, candidates)."""
    rng = np.random.default_rng(0)
    cfg = GPConfig(D=D)
    X = rng.uniform(-2, 2, (N, D))
    y = -0.5 * np.sum(X ** 2, 1)
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8)
    hyps[:, D] = 0.0
    hyps[:, cfg.ncov] = np.log(0.05)
    hyps[:, cfg.ncov + cfg.nnoise + 1 + D:] = np.log(1.2)
    hyps += 0.03 * rng.standard_normal(hyps.shape)
    mu = rng.uniform(-1, 1, (K, D))
    Xs = rng.uniform(-2, 2, (M, D))
    return cfg, X, y, hyps, mu, Xs


def build_inputs(N: int, S: int, K: int, M: int, device) -> Inputs:
    """The GP, VP, candidates, acquisition state and importance-sampling set
    of `bench_kernels.py` on ``device``."""
    cfg, X, y, hyps, mu, Xs = host_inputs(N, S, K, M)
    gp = gp_from_host(cfg, X, y, None, hyps, n_bucket=N, s_bucket=S,
                      device=device, dtype=DTYPE)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                           [2.0] * D, device=device, dtype=DTYPE)
    vp = make_vp(trinfo, mu, 0.5, np.ones(D))

    def full(v, shape=()):
        return torch.full(shape, v, device=device, dtype=DTYPE)

    state = AcqState(ymax=full(0.0), tol_var=full(1e-4),
                     lb_eps_orig=full(-math.inf, (D,)),
                     ub_eps_orig=full(math.inf, (D,)),
                     gp_length_scale=full(1.0, (D,)),
                     var_log_joint=full(1.0, (S,)), regularize=True)
    gen = torch.Generator(device=device).manual_seed(2)
    ais = build_is_state_core(gen, cfg, "viqr", vp, gp, 100, 100, 100,
                              mh_steps=3)
    return Inputs(cfg=cfg, N=N, S=S, K=K, M=M, hyps=hyps, gp=gp, vp=vp,
                  Xs=torch.as_tensor(Xs, device=device, dtype=DTYPE),
                  state=state, ais=ais)


@dataclasses.dataclass
class Row:
    name: str
    call: Callable[[int], object]   # call(i): the i-th distinct call
    flops: float
    # the sweep kernel a `_cuda` row must launch
    kernel: Optional[object] = None


def nlz_logp(cfg: GPConfig, gp):
    """The samplers' target: -nlZ of hyperparameter rows (B, nhyp) -> (B,)."""
    def logp(h):
        return -neg_log_marginal_likelihood(cfg, h, gp.X, gp.y, gp.s2,
                                            gp.mask)
    return logp


def make_rows(inp: Inputs) -> list:
    """Every row at these inputs, with `bench_kernels.py`'s FLOP counts; the
    ``_cuda`` rows only on the card."""
    cfg, gp, vp, Xs, state, ais = (inp.cfg, inp.gp, inp.vp, inp.Xs,
                                   inp.state, inp.ais)
    N, S, K, M = inp.N, inp.S, inp.K, inp.M
    dev = Xs.device
    on_card = dev.type == "cuda"
    rows = []

    # 1. posterior build: S x (chol(N,N) + inverse) ~ S * (N^3/3 + N^3)
    rows.append(Row("gp_posterior_build", lambda i: build_gp(
        cfg, gp.X, gp.y, gp.s2, gp.mask, gp.hyp + i * 1e-12, gp.hyp_mask),
        S * (N ** 3 / 3 + N ** 3 + 2 * N ** 2 * D)))

    # 2. acquisition sweep: per sample kernel cross N*M*D, Binv@ks N*N*M,
    # products 2*N*M
    flops = S * (2 * N * M * D + 2 * N * N * M + 4 * N * M) + 2 * K * M * D
    rows.append(Row("acquisition_sweep_8k", lambda i: evaluate_acquisition(
        cfg, "prospective", Xs + i * 1e-12, vp, gp, state), flops))
    if on_card:
        # the twin of the `_pallas` row: the kernel alone, ymax and tol_var
        # as numbers
        rows.append(Row("acquisition_sweep_8k_cuda",
                        lambda i: kernels.prospective_acq(
                            cfg, Xs + i * 1e-12, gp, vp, 0.0, 1e-4),
                        flops, kernel=kernels.prospective_acq))

    # 2c. VIQR sweep: per sample kma (M,Na), kmx (M,N), kmx @ invK
    # (M,N)x(N,Na), variance reduction + sinh + logsumexp over Na
    Na = ais.Xa.shape[0]
    flops_v = S * (2 * N * M * D + 2 * M * Na * D + 2 * M * N * Na
                   + 6 * M * Na)
    rows.append(Row("viqr_sweep_8k", lambda i: evaluate_is_acquisition(
        cfg, "viqr", Xs + i * 1e-12, vp, gp, state, ais), flops_v))
    if on_card:
        rows.append(Row("viqr_sweep_8k_cuda", lambda i: sweep_is_acquisition(
            cfg, "viqr", Xs + i * 1e-12, vp, gp, state, ais), flops_v,
            kernel=kernels.viqr_acq))

    # 3. ELBO value and gradient (weights optimised, deterministic entropy)
    flags = eb.VPFlags(opt_weights=True)
    eta = torch.zeros((1, K), device=dev, dtype=DTYPE)
    theta = eb.pack_theta(flags, vp.mu[None], vp.sigma[None], vp.lam[None],
                          eta)
    gen_e = torch.Generator(device=dev).manual_seed(0)

    def elbo_step(i):
        th = (theta + i * 1e-12).requires_grad_(True)
        F, _ = eb.negelcbo(cfg, th, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                           vp.kmask, flags, 0.0, 0, 1, gen_e)
        (g,) = torch.autograd.grad(F.sum(), th)
        return F.detach(), g

    # z matrix 2x(S,K,N) einsums over D + J data term 2 GEMMs (S,K,N)x(N,N)
    rows.append(Row("elbo_value_and_grad", elbo_step,
                    2 * (S * (4 * K * N * D)
                         + S * (2 * K * N * N + 2 * K * K * N))))

    # 4. one slice-sampling sweep over all hyperparameters of one chain
    logp = nlz_logp(cfg, gp)
    h0 = torch.as_tensor(inp.hyps[0], device=dev, dtype=DTYPE)
    gen_s = torch.Generator(device=dev)

    def slice_sweep(i):
        h = h0 + i * 1e-12
        gen_s.manual_seed(1)
        return slice_sample_chains(gen_s, logp, h[None], torch.ones_like(h),
                                   h - 10.0, h + 10.0, n_keep=1, burn=0,
                                   thin=1, n_keep_max=1)

    rows.append(Row("slice_sweep_nlz", slice_sweep,
                    cfg.nhyp * 4 * (N ** 3 / 3)))   # ~4 nlZ per coordinate

    # 4b. one ensemble sweep: 2 half-moves x ~4 batched shrink evaluations,
    # each a (S/2, N, N) Cholesky
    walkers0 = torch.as_tensor(inp.hyps, device=dev, dtype=DTYPE)
    lo, hi = walkers0.amin(0) - 10.0, walkers0.amax(0) + 10.0
    gen_en = torch.Generator(device=dev)

    def ensemble_sweep(i):
        gen_en.manual_seed(3)
        return ensemble_slice_final(gen_en, logp, walkers0 + i * 1e-12, lo,
                                    hi, 1)

    rows.append(Row("ensemble_sweep_nlz", ensemble_sweep,
                    2 * 4 * (S // 2) * (N ** 3 / 3)))
    return rows


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def check_finite(name: str, out):
    """Raise unless every floating-point tensor of a row's output is
    finite."""
    for t in _tensors(out):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{name}: non-finite output")


class Clock:
    """Wall time of work on ``device``: CUDA events and a synchronize on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def seconds(self, work: Callable[[], None]) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            work()
            return time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        work()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 1e3


def time_pipelined(clock: Clock, call, window_s: float = WINDOW_S):
    """Seconds per call of R distinct calls ``call(0..R-1)`` issued back to
    back, and R; R grows until the R calls take at least ``window_s``. The
    caller has warmed ``call`` up."""
    def run(R):
        def work():
            for i in range(R):
                call(i)
        return clock.seconds(work)

    reps = 1
    elapsed = run(reps)
    while elapsed < window_s and reps < MAX_REPS:
        reps = min(MAX_REPS, max(2 * reps, math.ceil(
            1.2 * reps * window_s / max(elapsed, 1e-9))))
        elapsed = run(reps)
    return elapsed / reps, reps


def time_single(clock: Clock, call, reps: int = SINGLE_REPS) -> float:
    """Median seconds of single calls on the host clock, each ending in a
    synchronize."""
    ts = []
    for i in range(reps):
        clock.sync()
        t0 = time.perf_counter()
        call(i + 1)
        clock.sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def profile_call(call):
    """(kernels launched, their summed device ms, device-to-host copies) of
    one call on the card, from `torch.profiler`'s CUDA events; the first
    two are None where it saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(0)
        torch.cuda.synchronize()
    n, ns, dtoh = 0, 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name()
        if name.startswith(("Memcpy", "Memset")):
            dtoh += "DtoH" in name
            continue
        n += 1
        ns += ev.duration_ns()
    if n == 0:
        return None, None, dtoh
    return n, ns / 1e6, dtoh


def gemm_tflops(n: int, dtype, device, windows: int = 3,
                reps: int = 10) -> float:
    """cuBLAS GEMM TFLOP/s at n x n x n, the best of ``windows`` runs of
    ``reps`` calls by CUDA events."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    b = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    c = torch.empty_like(a)
    clock = Clock(torch.device(device))
    torch.mm(a, b, out=c)
    clock.sync()

    def work():
        for _ in range(reps):
            torch.mm(a, b, out=c)

    best = min(clock.seconds(work) for _ in range(windows)) / reps
    return 2 * n ** 3 / best / 1e12


def device_probe(info: dict, device: torch.device) -> dict:
    """The ``device_probe`` row: the measured DGEMM and SGEMM against the
    documented FP64 peak. Raises BrokenTimer past `MAX_FRAC_OF_PEAK`."""
    peak, key = peak_for(info["kind"])
    row = {"metric": "device_probe", "value": None,
           "unit": f"TFLOP/s_f64_dgemm_{PROBE_N}", "device": info["kind"],
           "platform": info["platform"], "nvidia_smi": info["nvidia_smi"],
           "documented_peak_f64_tflops": peak,
           "documented_peak_key": key,
           "documented_peak_source": PEAK_SOURCE if peak else None,
           "measured_sgemm_tflops": None,
           "measured_dgemm_frac_of_documented": None, "dtype": "float64"}
    if device.type != "cuda":
        row["note"] = "not measured: no card"
        return row
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dgemm = gemm_tflops(PROBE_N, torch.float64, device)
        sgemm = gemm_tflops(PROBE_N, torch.float32, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    row.update(value=dgemm, measured_sgemm_tflops=sgemm)
    if peak:
        row["measured_dgemm_frac_of_documented"] = dgemm / peak
    return row


def check_probe(row: dict):
    frac = row["measured_dgemm_frac_of_documented"]
    if frac is not None and frac > MAX_FRAC_OF_PEAK:
        raise BrokenTimer(
            f"measured DGEMM {row['value']:.2f} TFLOP/s is {frac:.3f}x the "
            f"documented {row['documented_peak_f64_tflops']} TFLOP/s "
            f"(over {MAX_FRAC_OF_PEAK}x): the timer is broken, so no row "
            f"would be true")


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _emit(row: dict):
    print(json.dumps(row), flush=True)


def time_row(row: Row, inp: Inputs, clock: Clock, probe: dict,
             info: dict, window_s: float = WINDOW_S) -> dict:
    """One row's JSON object: its output checked finite once, then both
    timings, the profile of one call and the rates."""
    sweeps = (kernels.prospective_acq, kernels.viqr_acq)
    n0 = [k.launches for k in sweeps]
    check_finite(row.name, row.call(0))
    clock.sync()
    t_pipe, reps = time_pipelined(clock, row.call, window_s)
    t_single = time_single(clock, row.call)
    launches = device_ms = dtoh = None
    if clock.cuda:
        launches, device_ms, dtoh = profile_call(row.call)
        if launches is None:
            _log(f"# {row.name}: torch.profiler saw no CUDA kernel; "
                 f"launches and device_ms are null")
    moved = {k.name: k.launches - n for k, n in zip(sweeps, n0)}
    if row.kernel is not None and not moved[row.kernel.name] > 0:
        raise RuntimeError(f"{row.name}: {row.kernel.name} was not launched")
    tflops = row.flops / t_pipe / 1e12
    peak = probe["documented_peak_f64_tflops"]
    roof = probe["value"]
    return {"metric": f"kernel_{row.name}_ms", "value": t_pipe * 1e3,
            "unit": "ms", "ms_pipelined": t_pipe * 1e3,
            "ms_single": t_single * 1e3, "pipeline_reps": reps,
            "launches": launches, "device_ms": device_ms,
            "dtoh_copies": dtoh, "sweep_launches": moved,
            "flops": int(row.flops), "tflops": tflops, "dtype": "float64",
            "device": info["kind"], "nvidia_smi": info["nvidia_smi"],
            "N": inp.N, "S": inp.S, "K": inp.K, "M": inp.M,
            "peak_tflops": peak, "mfu": tflops / peak if peak else None,
            "mfu_f64roof": tflops / roof if roof else None}


def run(N: int, S: int, K: int, M: int, device="cuda",
        window_s: float = WINDOW_S, emit=_emit) -> list:
    """Every row at this shape on ``device``, each passed to ``emit`` as it
    is measured; returns them, the probe first. Raises BrokenTimer (after
    emitting the probe) when the DGEMM beats the documented peak."""
    device = torch.device(device)
    info = device_info(device.type)
    clock = Clock(device)
    if clock.cuda:
        kernels.build_all()
    probe = device_probe(info, device)
    _log(f"# device {info['kind']} ({info['nvidia_smi']}): documented FP64 "
         f"peak {probe['documented_peak_f64_tflops']} TFLOP/s, measured "
         f"DGEMM {probe['value']} TFLOP/s, SGEMM (no TF32) "
         f"{probe['measured_sgemm_tflops']} TFLOP/s")
    emit(probe)
    check_probe(probe)
    inp = build_inputs(N, S, K, M, device)
    out = [probe]
    for row in make_rows(inp):
        _log(f"# timing {row.name} ...")
        r = time_row(row, inp, clock, probe, info, window_s)
        _log(f"# {row.name}: {r['ms_pipelined']:.3f} ms pipelined / "
             f"{r['ms_single']:.3f} ms single, {r['launches']} kernels "
             f"taking {r['device_ms']} ms on the device, "
             f"{r['dtoh_copies']} copies to the host, "
             f"{r['tflops']:.4f} TFLOP/s, mfu {r['mfu']}")
        emit(r)
        out.append(r)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vbmc_tpu_torch.bench_kernels",
        description="Microbenchmarks of the port's hot layers (the twin "
                    "of bench_kernels.py).")
    for name, default in zip("NSKM", DEFAULTS):
        parser.add_argument(name, type=int, nargs="?", default=default)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("python -m vbmc_tpu_torch.bench_kernels runs on the card "
              "unless --device cpu is given, and torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    try:
        run(args.N, args.S, args.K, args.M, args.device)
    except BrokenTimer as e:
        print(f"bench_kernels: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
