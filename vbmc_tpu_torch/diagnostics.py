"""Multi-run convergence diagnostics (cf. `vbmc_tpu/diagnostics.py`,
`vbmc_diagnostics.m`).

Given the results of several independent VBMC runs, checks each run's exit
status and the runs' agreement in ELBO, symmetrised KL and marginal total
variation, and returns an overall verdict.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vbmc_tpu_torch.utils.math import to_np
from vbmc_tpu_torch.vp import VariationalPosterior, vp_kldiv, vp_mtv


@dataclasses.dataclass
class DiagnosticsResult:
    exitflag: int            # 1 passed, 0 unclear, -1..-3 failed
    best: Optional[int]      # index of the recommended run (by ELCBO)
    elbos: np.ndarray
    elbo_sds: np.ndarray
    skl_matrix: np.ndarray   # pairwise symmetrised KL
    mtv_matrix: np.ndarray   # pairwise largest marginal total variation
    message: str


def vbmc_diagnostics(results: Sequence, beta_lcb: float = 3.0,
                     elbo_thresh: float = 1.0, skl_thresh: float = 1.0,
                     mtv_thresh: float = 0.2,
                     gen: Optional[torch.Generator] = None
                     ) -> DiagnosticsResult:
    """Analyse `VBMCResult`s (or (vp, elbo, elbo_sd) tuples).

    Thresholds follow `vbmc_diagnostics.m:53-62`; the verdict requires at
    least a third of the runs to agree with the best one. The Monte-Carlo
    comparisons draw from ``gen`` (default: a generator on the first VP's
    device seeded with 0)."""
    vps: List[VariationalPosterior] = []
    elbos, elbo_sds, exitflags = [], [], []
    for r in results:
        if isinstance(r, tuple):
            vp, e, esd = r
            vps.append(vp)
            elbos.append(e)
            elbo_sds.append(esd)
            exitflags.append(1)
        else:
            vps.append(r.vp)
            elbos.append(r.elbo)
            elbo_sds.append(r.elbo_sd)
            exitflags.append(r.exitflag)
    n = len(vps)
    elbos = np.asarray(elbos, float)
    elbo_sds = np.asarray(elbo_sds, float)

    if n < 2:
        return DiagnosticsResult(
            exitflag=0 if (n and exitflags[0] >= 1) else -1,
            best=0 if n else None, elbos=elbos, elbo_sds=elbo_sds,
            skl_matrix=np.zeros((n, n)), mtv_matrix=np.zeros((n, n)),
            message="At least two runs are required for cross-validation "
                    "diagnostics.")

    if gen is None:
        gen = torch.Generator(device=vps[0].mu.device).manual_seed(0)
    elcbo = elbos - beta_lcb * elbo_sds
    best = int(np.argmax(elcbo))

    skl = np.zeros((n, n))
    mtv = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            with torch.no_grad():
                kl = to_np(vp_kldiv(vps[i], vps[j], gauss_flag=True, gen=gen))
                m = to_np(vp_mtv(vps[i], vps[j], n_samples=10 ** 5, gen=gen))
            skl[i, j] = skl[j, i] = 0.5 * float(np.sum(kl))
            mtv[i, j] = mtv[j, i] = float(np.max(m))

    agree = [i for i in range(n) if i != best
             and abs(elbos[i] - elbos[best]) < elbo_thresh
             and skl[i, best] < skl_thresh
             and mtv[i, best] < mtv_thresh]
    frac = (1 + len(agree)) / n

    if not any(e >= 1 for e in exitflags):
        exitflag, message = -2, "No run converged."
    elif frac >= 1.0 - 1e-9:
        exitflag, message = 1, "All runs agree with the best solution."
    elif frac >= 1 / 3:
        exitflag, message = 0, (
            f"{1 + len(agree)}/{n} runs agree with the best solution; "
            "diagnostics are inconclusive but plausible.")
    else:
        exitflag, message = -3, (
            "Runs disagree substantially; the posterior is likely unreliable.")

    return DiagnosticsResult(exitflag=exitflag, best=best, elbos=elbos,
                             elbo_sds=elbo_sds, skl_matrix=skl,
                             mtv_matrix=mtv, message=message)
