"""Dispatch of independent VBMC runs to worker processes (cf.
`vbmc_tpu/parallel/launch.py`).

The multi-run validation workflow (`vbmc_diagnostics.m`) is parallel at the
level of runs: each run is an independent inference with its own seed, and
only the final (vp, elbo, elbo_sd) triples meet for the diagnostics. Each
run goes to a process of its own (`python -m
vbmc_tpu_torch.parallel.worker`), placed through ``env_per_run`` (for
example ``CUDA_VISIBLE_DEVICES`` per run) or wrapped in ``launcher`` (an
ssh or mpirun prefix). The payload crosses by pickle, so the target and any
callable option must be picklable (defined at module level); each result
comes back as a serialized VP with its scalars (`serialize.save_vp`).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

import torch


def dispatch_runs(fun, x0=None, lb=None, ub=None, plb=None, pub=None,
                  options=None, n_runs: int = 3,
                  python: Optional[str] = None,
                  launcher: Optional[Sequence[str]] = None,
                  env_per_run: Optional[Sequence[dict]] = None,
                  timeout: float = 3600.0, workdir: Optional[str] = None,
                  device="cuda", dtype=torch.float64):
    """Run ``n_runs`` independent inferences in separate processes, all
    started at once, with seeds ``options.seed + 1000 i`` (the schedule of
    the in-process `vbmc_sweep`).

    Each worker runs on ``device``'s type in ``dtype``
    (``VBMC_WORKER_PLATFORM`` and ``VBMC_WORKER_X64`` in its environment),
    unless ``env_per_run`` sets those itself. Returns (DiagnosticsResult,
    [(vp, elbo, elbo_sd, meta), ...]), the VPs on ``device``. A worker that
    fails raises `RuntimeError`."""
    from vbmc_tpu_torch.diagnostics import vbmc_diagnostics
    from vbmc_tpu_torch.options import VBMCOptions
    from vbmc_tpu_torch.serialize import load_vp

    if options is None:
        options = VBMCOptions()
    python = python or sys.executable
    tmp = tempfile.mkdtemp(prefix="vbmc_sweep_", dir=workdir)
    # the repository root, so that the worker imports this package
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    device = torch.device(device)
    base = {"VBMC_WORKER_PLATFORM": device.type,
            "VBMC_WORKER_X64": "1" if dtype == torch.float64 else "0",
            "VBMC_REPO": repo}

    procs, out_paths = [], []
    for i in range(n_runs):
        opts_i = dataclasses.replace(options, seed=options.seed + 1000 * i)
        in_path = os.path.join(tmp, f"run{i}.pkl")
        out_path = os.path.join(tmp, f"run{i}_out.npz")
        with open(in_path, "wb") as f:
            pickle.dump(dict(fun=fun, x0=x0, lb=lb, ub=ub, plb=plb, pub=pub,
                             options=opts_i), f)
        cmd = list(launcher or []) + [python, "-m",
                                      "vbmc_tpu_torch.parallel.worker",
                                      in_path, out_path]
        env = {**os.environ, **base}
        if env_per_run is not None and i < len(env_per_run):
            env.update(env_per_run[i])
        procs.append(subprocess.Popen(cmd, env=env))
        out_paths.append(out_path)

    failures = []
    for i, p in enumerate(procs):
        rc = p.wait(timeout=timeout)
        if rc != 0:
            failures.append((i, rc))
    if failures:
        raise RuntimeError(f"sweep workers failed: {failures}")

    triples, metas = [], []
    for path in out_paths:
        vp, meta = load_vp(path, device=device, dtype=dtype)
        triples.append((vp, float(meta["elbo"]), float(meta["elbo_sd"])))
        metas.append(meta)
    return vbmc_diagnostics(triples), [t + (m,) for t, m in
                                       zip(triples, metas)]
