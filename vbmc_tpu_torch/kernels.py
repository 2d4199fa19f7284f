"""The acquisition sweeps and CMA-ES's eigensolver as hand-written CUDA
kernels, each beside its plain PyTorch version:

- `prospective_acq` (`csrc/prospective_acq.cu`, the port of
  `vbmc_tpu/pallas_kernels.py:fused_prospective_acq`), the noiseless path;
- `viqr_acq` (`csrc/viqr_acq.cu`, the port of
  `vbmc_tpu/pallas_kernels.py:fused_viqr_acq`), the noisy path;
- `sym_eig` (`csrc/sym_eig.cu`, no TPU kernel: one symmetric D x D matrix,
  D <= 128, by cyclic Jacobi on one CTA), the eigendecomposition of a CMA-ES
  generation, which has to run inside a CUDA graph where
  `torch.linalg.eigh`, its plain version, cannot.

Each wrapper runs its plain version on a CPU tensor; on a CUDA tensor it
launches the kernel or raises, with no fallback. Each launch adds one to the
wrapper's ``launches``, and a float32 one also to its ``launches_f32``; a
launch recorded into a CUDA graph counts at each of the graph's replays, as
`samplers/cmaes.py` charges them (`launch_counts`, `add_launches`), and not
at the capture.

Both kernels share `csrc/gp_tile.cuh`: per block, the ks tile computed once
in dynamic shared memory, the left operands (Binv, invKzk) streamed through
a cp.async ring, and the float64 products on the FP64 tensor cores
(`mma.sync`, DMMA); float32 uses IEEE FMAs, never TF32.

The kernels are compiled with nvcc, one shared library with a plain C
interface per source, at first use (into ``build/`` beside the package,
which git ignores) and loaded with ctypes; nothing is built or imported
from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from vbmc_tpu_torch.gp.config import (GPConfig, COV_SEARD, MEAN_ZERO,
                                      MEAN_CONST, MEAN_NEGQUAD)
from vbmc_tpu_torch.gp.kernels import kernel_cross
from vbmc_tpu_torch.gp.predict import gp_predict
from vbmc_tpu_torch.vp import vp_log_pdf_trans

_LOG_REALMIN = -708.0
_MAX_D = 32
# The largest matrix `sym_eig` takes: A of 128 x 128 float64 fills 128 KB of
# a block's shared memory.
_EIG_MAX_D = 128
# The kernels stage the training axis up to 32 rows at a time, and their narrowest
# candidate tile holds N = 1024 float64 rows in a block's shared memory.
_N_STEP = 32
_MAX_N = 1024
# Bound on S * M * Na elements of one chunk of the plain VIQR sweep (its
# (S, M, Na) temporaries): 2^23 float64 values = 64 MB each.
_VIQR_CHUNK_ELEMS = 2 ** 23
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def kernel_supports(cfg: GPConfig) -> bool:
    """Configurations the kernels compute (ROADMAP Queue 3 a and b: the
    covariance is checked here, not asserted inside a kernel)."""
    return (cfg.covfun == COV_SEARD and cfg.intmean == 0 and cfg.outwarp == 0
            and cfg.meanfun in (MEAN_ZERO, MEAN_CONST, MEAN_NEGQUAD))


def prospective_acq_reference(cfg: GPConfig, Xs, gp, vp, ymax, tol_var,
                              regularize=True) -> torch.Tensor:
    """Plain PyTorch version: the "prospective" branch of
    `vbmc_tpu/acquisitions.py:evaluate_acquisition` before the hard-bound
    rejection. Returns raw acquisition values (M,); lower is better."""
    fbar, vtot, _, _ = gp_predict(cfg, gp, Xs)
    logp = vp_log_pdf_trans(vp, Xs).clamp_min(_LOG_REALMIN)
    acq = -vtot * torch.exp(fbar - ymax + logp)
    tiny = torch.finfo(vtot.dtype).tiny
    ratio = tol_var / vtot.clamp_min(tiny)
    low = (vtot < tol_var) & bool(regularize)
    acq = torch.where(low, acq * torch.exp(-(ratio - 1.0)), acq)
    return acq.clamp_min(-torch.finfo(acq.dtype).max)


_U_IQR = 0.6744897501960817  # norminv(0.75)


def _log_sinh(x):
    """Numerically stable log(sinh(x)) for x >= 0."""
    return x + torch.log1p(-torch.exp(-2.0 * x)) - math.log(2.0)


def viqr_acq_reference(cfg: GPConfig, Xs, gp, ais, sn2c, tol_var,
                       regularize=True) -> torch.Tensor:
    """Plain PyTorch version: `vbmc_tpu/active_is.py:evaluate_is_acquisition`
    ("viqr" and "imiqr" share it) before the hard-bound rejection, for the
    importance-sampling state ``ais`` (an `active_is.ISState`; padded slots
    carry ln_weights = -inf) and the nearest-noise estimate sn2c (M,).
    Returns raw log-domain acquisition values (M,); lower is better. The
    candidates go in chunks that bound the (S, M, Na) temporaries."""
    dt = Xs.dtype
    S, Na = ais.ln_weights.shape
    m = gp.mask.to(dt)
    chunk = max(1, _VIQR_CHUNK_ELEMS // max(S * Na, 1))
    vtots, ln_ints = [], []
    for i in range(0, Xs.shape[0], chunk):
        C = Xs[i:i + chunk]
        _, vtot, _, fs2 = gp_predict(cfg, gp, C)
        # Posterior covariance between candidates and integration points:
        # k(C, Xa) - k(C, X) B^{-1} k(X, Xa), per sample.
        kma = kernel_cross(cfg, gp.hyp, C, ais.Xa)
        kmx = kernel_cross(cfg, gp.hyp, C, gp.X) * m[None, None, :]
        cov = kma - kmx @ ais.invKzk
        red = cov ** 2 / (fs2 + sn2c[None, i:i + chunk])[:, :, None]
        s2_post = (ais.f_s2[:, None, :] - red).clamp_min(1e-12)
        ln_sinh = math.log(2.0) + _log_sinh(_U_IQR * torch.sqrt(s2_post))
        ln_ints.append(torch.logsumexp(ais.ln_weights[:, None, :] + ln_sinh,
                                       dim=2))
        vtots.append(vtot)
    ln_integral, vtot = torch.cat(ln_ints, 1), torch.cat(vtots)
    # Masked log-mean-exp over samples (`acqviqr_vbmc.m:111-114`).
    hm = gp.hyp_mask.to(dt)
    ln_masked = torch.where(gp.hyp_mask[:, None], ln_integral,
                            torch.finfo(dt).min)
    acq = torch.logsumexp(ln_masked, 0) - torch.log(hm.sum().clamp_min(1.0))
    ratio = tol_var / vtot.clamp_min(torch.finfo(dt).tiny)
    low = (vtot < tol_var) & bool(regularize)
    return torch.where(low, acq + ratio - 1.0, acq)


SOURCES = {"prospective_acq": CSRC / "prospective_acq.cu",
           "viqr_acq": CSRC / "viqr_acq.cu",
           "sym_eig": CSRC / "sym_eig.cu"}
# The phases of pass 1 that a -DVBMC_PROFILE build times (gp_tile.cuh).
PHASES = ("setup", "ks_tile", "binv_steps", "binv_fold", "reduce",
          "invkzk_steps", "viqr_epilogue", "merge")


def build(source: Path, verbose: bool = False, profile: bool = False) -> Path:
    """Compile one kernel source into its own library in ``build/`` unless
    one built from the same source, headers and flags is already there.
    ``profile`` adds ``-DVBMC_PROFILE``, the cycle marks of pass 1 (a
    measurement build). Returns the library path."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = (*NVCC_FLAGS, *(("-DVBMC_PROFILE",) if profile else ()))
    tag = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *flags, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(f"{source.name}:\n{proc.stderr.strip()}", flush=True)
    os.replace(tmp, lib)
    return lib


def build_all(verbose: bool = False, profile: bool = False) -> dict:
    """Build every kernel source at once, one nvcc process each. Returns
    {name: library path}."""
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        futs = {name: ex.submit(build, src, verbose, profile)
                for name, src in SOURCES.items()}
        return {name: f.result() for name, f in futs.items()}


class _Kernel:
    """A kernel library loaded with ctypes, and its launch counter."""

    name = ""
    n_ptr = 0    # pointer arguments before the ints
    n_int = 0    # int arguments before the trailing scalars
    tail = ()    # ctypes of the trailing arguments, the stream last

    def __init__(self):
        self.launches = 0
        self.launches_f32 = 0
        self._lib = None
        self._profile = False

    def load(self, profile=None):
        """The kernel's library, built if need be. ``profile`` True or
        False switches every later launch to the build with or without the
        cycle marks; None keeps the build in use."""
        if profile is not None and bool(profile) != self._profile:
            self._lib, self._profile = None, bool(profile)
        if self._lib is None:
            lib = ctypes.CDLL(str(build(SOURCES[self.name],
                                        profile=self._profile)))
            for suffix in ("f64", "f32"):
                fn = getattr(lib, f"{self.name}_{suffix}")
                fn.argtypes = ([ctypes.c_void_p] * self.n_ptr
                               + [ctypes.c_int] * self.n_int + list(self.tail))
                fn.restype = ctypes.c_int
            if hasattr(lib, f"{self.name}_tile"):
                tile = getattr(lib, f"{self.name}_tile")
                tile.argtypes = [ctypes.c_int] * 3
                tile.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def tile_width(self, N: int, D: int, dtype) -> int:
        """Candidates per block of pass 1 at N training slots (the launcher
        picks the plan from N; `csrc/gp_tile.cuh`). Pass 1 evaluates whole
        tiles, masked training rows included."""
        fn = getattr(self.load(), f"{self.name}_tile")
        return int(fn(N, D, int(dtype == torch.float64)))

    def read_phases(self, reset: bool = True):
        """The eight cycle sums of pass 1's phases since the last reset
        (`csrc/gp_tile.cuh`, VBMC_PROFILE), summed over blocks; the library
        in use must have been built with ``-DVBMC_PROFILE``. Synchronises
        the device."""
        fn = getattr(self.load(), f"{self.name}_profile", None)
        if fn is None:
            raise RuntimeError(f"{self.name}: the library in use was built "
                               f"without -DVBMC_PROFILE")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * len(PHASES))()
        err = fn(buf, int(reset))
        if err != 0:
            raise RuntimeError(f"{self.name}_profile: CUDA error {err}")
        return dict(zip(PHASES, buf))

    def _check_config(self, cfg: GPConfig):
        if not kernel_supports(cfg):
            raise NotImplementedError(
                f"{self.name} takes SE-ard with a zero/const/negquad mean, "
                f"no integrated mean and no output warping, not {cfg}")

    def _check_device(self, Xs) -> bool:
        """True to launch the kernel, False to run the plain version."""
        if Xs.device.type == "cpu":
            return False
        if Xs.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {Xs.device}")
        if Xs.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.name} kernel takes float32/float64, got "
                            f"{Xs.dtype}")
        return True

    def _check_tensors(self, Xs, expect: dict):
        for name, (t, shape) in expect.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"{self.name}: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if t.device != Xs.device or t.dtype != Xs.dtype:
                raise ValueError(f"{self.name}: {name} is {t.dtype} on "
                                 f"{t.device}, expected {Xs.dtype} on "
                                 f"{Xs.device}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {name} is not contiguous")

    def _gp_shapes(self, cfg: GPConfig, Xs, gp):
        M, D = Xs.shape
        N = gp.X.shape[0]
        S, nhyp = gp.hyp.shape
        if D != cfg.D or D > _MAX_D or nhyp != cfg.nhyp:
            raise ValueError(f"{self.name} kernel: D={D}, nhyp={nhyp} for "
                             f"{cfg} (D <= {_MAX_D})")
        if N % _N_STEP or not 0 < N <= _MAX_N:
            raise ValueError(f"{self.name} kernel: N={N} training slots; it "
                             f"takes a multiple of {_N_STEP} up to {_MAX_N} "
                             f"(every rung of utils.math.N_BUCKETS is one)")
        return M, D, N, S, nhyp, {
            "Xs": (Xs, (M, D)), "X": (gp.X, (N, D)),
            "hyp": (gp.hyp, (S, nhyp)), "alpha": (gp.alpha, (S, N)),
            "Binv": (gp.Binv, (S, N, N))}

    def _run(self, Xs, args):
        lib = self.load()
        fn = getattr(lib, f"{self.name}_"
                     f"{'f64' if Xs.dtype == torch.float64 else 'f32'}")
        stream = torch.cuda.current_stream(Xs.device).cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        self.launches_f32 += Xs.dtype == torch.float32


class ProspectiveAcq(_Kernel):
    """The prospective sweep's dispatching wrapper."""

    name = "prospective_acq"
    n_ptr, n_int = 14, 8
    tail = (ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p)

    def __call__(self, cfg: GPConfig, Xs, gp, vp, ymax, tol_var,
                 regularize=True) -> torch.Tensor:
        self._check_config(cfg)
        if not self._check_device(Xs):
            return prospective_acq_reference(cfg, Xs, gp, vp, ymax, tol_var,
                                             regularize)
        M, D, N, S, nhyp, expect = self._gp_shapes(cfg, Xs, gp)
        K = vp.mu.shape[0]
        expect.update({"mu": (vp.mu, (K, D)), "sigma": (vp.sigma, (K,)),
                       "lam": (vp.lam, (D,))})
        self._check_tensors(Xs, expect)
        dt = Xs.dtype
        nmask = gp.mask.to(dt).contiguous()
        smask = gp.hyp_mask.to(dt).contiguous()
        logw = torch.where(vp.kmask, torch.log(vp.w.clamp_min(
            torch.finfo(dt).tiny)), -math.inf).contiguous()
        fmu_ws = torch.empty((S, M), dtype=dt, device=Xs.device)
        fs2_ws = torch.empty((S, M), dtype=dt, device=Xs.device)
        out = torch.empty(M, dtype=dt, device=Xs.device)
        self._run(Xs, (
            Xs.data_ptr(), gp.X.data_ptr(), nmask.data_ptr(),
            gp.hyp.data_ptr(), smask.data_ptr(), gp.alpha.data_ptr(),
            gp.Binv.data_ptr(), vp.mu.data_ptr(), vp.sigma.data_ptr(),
            vp.lam.data_ptr(), logw.data_ptr(), fmu_ws.data_ptr(),
            fs2_ws.data_ptr(), out.data_ptr(), M, N, D, S, K, nhyp,
            int(cfg.meanfun), cfg.ncov + cfg.nnoise, float(ymax),
            float(tol_var), int(bool(regularize))))
        return out


class ViqrAcq(_Kernel):
    """The VIQR / IMIQR sweep's dispatching wrapper."""

    name = "viqr_acq"
    n_ptr, n_int = 16, 8
    tail = (ctypes.c_double, ctypes.c_int, ctypes.c_void_p)

    def __call__(self, cfg: GPConfig, Xs, gp, ais, sn2c, tol_var,
                 regularize=True) -> torch.Tensor:
        self._check_config(cfg)
        if not self._check_device(Xs):
            return viqr_acq_reference(cfg, Xs, gp, ais, sn2c, tol_var,
                                      regularize)
        M, D, N, S, nhyp, expect = self._gp_shapes(cfg, Xs, gp)
        Na = ais.Xa.shape[0]
        expect.update({"Xa": (ais.Xa, (Na, D)),
                       "ln_weights": (ais.ln_weights, (S, Na)),
                       "f_s2": (ais.f_s2, (S, Na)),
                       "invKzk": (ais.invKzk, (S, N, Na)),
                       "sn2c": (sn2c, (M,))})
        self._check_tensors(Xs, expect)
        dt = Xs.dtype
        nmask = gp.mask.to(dt).contiguous()
        smask = gp.hyp_mask.to(dt).contiguous()
        ws = torch.empty((3, S, M), dtype=dt, device=Xs.device)
        out = torch.empty(M, dtype=dt, device=Xs.device)
        self._run(Xs, (
            Xs.data_ptr(), gp.X.data_ptr(), nmask.data_ptr(),
            gp.hyp.data_ptr(), smask.data_ptr(), gp.alpha.data_ptr(),
            gp.Binv.data_ptr(), ais.Xa.data_ptr(), ais.ln_weights.data_ptr(),
            ais.f_s2.data_ptr(), ais.invKzk.data_ptr(), sn2c.data_ptr(),
            ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(),
            out.data_ptr(), M, N, D, S, Na, nhyp, int(cfg.meanfun),
            cfg.ncov + cfg.nnoise, float(tol_var), int(bool(regularize))))
        return out


class SymEig(_Kernel):
    """The eigendecomposition of one symmetric matrix (its lower triangle is
    read, as `torch.linalg.eigh` reads it): ``A`` (D, D) -> (eigenvalues
    (D,), eigenvectors (D, D) as columns), in no particular order and with
    no particular signs. `torch.linalg.eigh` for a CPU tensor; for a CUDA
    tensor the kernel, which reads nothing back to the host and so can be
    captured in a CUDA graph."""

    name = "sym_eig"
    n_ptr, n_int = 3, 1
    tail = (ctypes.c_void_p,)

    def __call__(self, A):
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"{self.name} takes one square matrix, got "
                             f"shape {tuple(A.shape)}")
        D = A.shape[0]
        if not 1 <= D <= _EIG_MAX_D:
            raise ValueError(f"{self.name} takes 1 <= D <= {_EIG_MAX_D}, "
                             f"got D={D}")
        if A.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.name} takes float32/float64, got "
                            f"{A.dtype}")
        if not self._check_device(A):
            return torch.linalg.eigh(A)
        A = A.contiguous()
        evals = torch.empty(D, dtype=A.dtype, device=A.device)
        evecs = torch.empty((D, D), dtype=A.dtype, device=A.device)
        self._run(A, (A.data_ptr(), evals.data_ptr(), evecs.data_ptr(), D))
        return evals, evecs


prospective_acq = ProspectiveAcq()
viqr_acq = ViqrAcq()
sym_eig = SymEig()
KERNELS = (prospective_acq, viqr_acq, sym_eig)


def launch_counts(since=None) -> list:
    """Every wrapper's (launches, launches_f32), or what each gained since
    an earlier reading ``since``."""
    now = [(k.launches, k.launches_f32) for k in KERNELS]
    if since is None:
        return now
    return [(a - a0, b - b0) for (a, b), (a0, b0) in zip(now, since)]


def add_launches(counts, times: int = 1):
    """Add ``times`` times the launches ``counts`` (from `launch_counts`)
    to the wrappers' counters: the launches a CUDA graph recorded, once a
    replay, taken back from its capture with ``times`` -1."""
    for k, (n, n32) in zip(KERNELS, counts):
        k.launches += times * n
        k.launches_f32 += times * n32
