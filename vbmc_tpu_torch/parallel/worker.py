"""Sweep worker: one independent VBMC run per process (cf.
`vbmc_tpu/parallel/worker.py`).

Started by `parallel/launch.py` as
``python -m vbmc_tpu_torch.parallel.worker payload.pkl out.npz``. The
payload pickle carries (fun, bounds, options); the output is the run's
serialized variational posterior with its ELBO and exit flag in the
metadata, what `vbmc_diagnostics` needs.

``VBMC_WORKER_PLATFORM`` picks the device (``cuda``, the default, or
``cpu``); ``VBMC_WORKER_X64=0`` asks for float32, anything else runs
float64, the port's default (ROADMAP Queue 3 v).
"""

from __future__ import annotations

import os
import pickle
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    in_path, out_path = argv[0], argv[1]
    repo = os.environ.get("VBMC_REPO")
    if repo and repo not in sys.path:
        sys.path.insert(0, repo)

    import torch

    from vbmc_tpu_torch.main import vbmc
    from vbmc_tpu_torch.serialize import save_vp

    device = os.environ.get("VBMC_WORKER_PLATFORM") or "cuda"
    dtype = (torch.float32 if os.environ.get("VBMC_WORKER_X64") == "0"
             else torch.float64)
    with open(in_path, "rb") as f:
        payload = pickle.load(f)
    res = vbmc(payload["fun"], payload.get("x0"), payload.get("lb"),
               payload.get("ub"), payload.get("plb"), payload.get("pub"),
               options=payload["options"], device=device, dtype=dtype)
    save_vp(out_path, res.vp,
            metadata=dict(elbo=float(res.elbo), elbo_sd=float(res.elbo_sd),
                          exitflag=int(res.exitflag),
                          func_count=int(res.func_count),
                          iterations=int(res.iterations)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
