"""Serialization of variational posteriors and run results (cf.
`vbmc_tpu/serialize.py`): one ``.npz`` with the VP's arrays, the transform
description and a JSON metadata blob (no pickling).

The keys and the blob are the reference's, so a file written by either
package loads in the other: this is how a run's state crosses between them.
The arrays are stored as float64 on the host; `load_vp` and
`load_checkpoint` put them on the device asked for (the card by default).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from vbmc_tpu_torch.transforms import trinfo_from_np
from vbmc_tpu_torch.utils.math import to_np
from vbmc_tpu_torch.vp import VariationalPosterior, vp_from_np


def _vp_arrays(vp: VariationalPosterior) -> dict:
    ti = vp.trinfo
    f64 = {k: to_np(getattr(vp, k)).astype(np.float64)
           for k in ("w", "eta", "mu", "sigma", "lam")}
    return dict(**f64, kmask=to_np(vp.kmask).astype(bool),
                tr_type=to_np(ti.type),
                tr_lb=to_np(ti.lb_orig).astype(np.float64),
                tr_ub=to_np(ti.ub_orig).astype(np.float64),
                tr_mu=to_np(ti.mu).astype(np.float64),
                tr_delta=to_np(ti.delta).astype(np.float64),
                tr_R=to_np(ti.R_mat).astype(np.float64),
                tr_scale=to_np(ti.scale).astype(np.float64))


def _meta_bytes(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_vp(path: str, vp: VariationalPosterior,
            metadata: Optional[dict] = None):
    """Save a variational posterior to ``path`` (.npz)."""
    np.savez(path, _meta=_meta_bytes(metadata or {}), **_vp_arrays(vp))


def load_vp(path: str, device="cuda", dtype=torch.float64):
    """Load a variational posterior onto ``device``; returns (vp, metadata
    dict). A file without ``tr_R`` / ``tr_scale`` gets the identity
    rotoscale."""
    data = np.load(path)
    D = int(np.asarray(data["tr_type"]).shape[0])
    ti = trinfo_from_np(dict(
        type=data["tr_type"], lb_orig=data["tr_lb"], ub_orig=data["tr_ub"],
        mu=data["tr_mu"], delta=data["tr_delta"],
        R_mat=data["tr_R"] if "tr_R" in data else np.eye(D),
        scale=data["tr_scale"] if "tr_scale" in data else np.ones(D)),
        torch.device(device), dtype)
    vp = vp_from_np(ti, data["w"], data["eta"], data["mu"], data["sigma"],
                    data["lam"], np.asarray(data["kmask"], bool))
    meta = {}
    if "_meta" in data:
        meta = json.loads(bytes(data["_meta"]).decode())
    return vp, meta


def save_result(path: str, result):
    """Save a `VBMCResult` checkpoint: the VP, the evaluations and the run's
    summary. The evaluations allow an exact resumption through
    ``options.fvals`` and an x0 matrix (`vbmc.m:417-424, 447-450`)."""
    lg = result.logger
    n = lg.Xn
    meta = dict(elbo=result.elbo, elbo_sd=result.elbo_sd,
                exitflag=result.exitflag, message=result.message,
                func_count=result.func_count, iterations=result.iterations,
                convergence_status=result.convergence_status)
    arrays = dict(
        _vp_arrays(result.vp),
        X_orig=lg.X_orig[:n], y_orig=lg.y_orig[:n],
        X_flag=lg.X_flag[:n], nevals=lg.nevals[:n],
        elbo_series=result.stats.series("elbo"),
        elbo_sd_series=result.stats.series("elbo_sd"),
        rindex_series=result.stats.series("rindex"))
    if lg.S is not None:
        arrays["S"] = lg.S[:n]
    np.savez(path, _meta=_meta_bytes(meta), **arrays)


def load_checkpoint(path: str, device="cuda", dtype=torch.float64):
    """Load a checkpoint; returns (vp on ``device``, evals dict, metadata).

    ``evals`` has X_orig / y_orig (and S) to seed a new run:
    ``vbmc(fun, x0=evals["X_orig"], options=VBMCOptions(fvals=evals["y_orig"]))``.
    """
    vp, _ = load_vp(path, device=device, dtype=dtype)
    data = np.load(path)
    evals = dict(X_orig=data["X_orig"], y_orig=data["y_orig"],
                 X_flag=data["X_flag"], nevals=data["nevals"])
    if "S" in data:
        evals["S"] = data["S"]
    meta = json.loads(bytes(data["_meta"]).decode())
    return vp, evals, meta
