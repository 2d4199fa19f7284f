"""Work of one acquisition sweep, counted from the shapes of the call and
the valid entries of its GP (frozen from `chip_smoke.py`'s
`compare_prospective` and `compare_viqr`), whatever implements the sweep.

Operations: the products with the inverse Gram matrix that the sweep
cannot avoid, 2 S M N N for "prospective" and 2 S M N (N + Na) for VIQR,
with S the valid hyperparameter samples, N the valid training points, M the
candidates and Na the integration points. Bytes: each input read once and
the output written once.
"""

from __future__ import annotations


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def sweep_work(kind, args):
    """{"flops", "bytes"} of one call of ``sweep_acquisition`` (cfg, name,
    Xs, vp, gp, state[, smooth]) or ``sweep_is_acquisition`` (cfg, name,
    Xs, vp, gp, state, ais)."""
    Xs, vp, gp = args[2], args[3], args[4]
    M = Xs.shape[0]
    S = int(gp.hyp_mask.sum())
    N = int(gp.mask.sum())
    out_bytes = M * Xs.element_size()
    if kind == "viqr_acq":
        ais = args[6]
        Na = ais.Xa.shape[0]
        return dict(flops=2.0 * S * M * N * (N + Na),
                    bytes=_nbytes(Xs, gp.X, gp.hyp, gp.alpha, gp.Binv,
                                  gp.sn2, ais.Xa, ais.ln_weights, ais.f_s2,
                                  ais.invKzk) + out_bytes)
    return dict(flops=2.0 * S * M * N * N,
                bytes=_nbytes(Xs, gp.X, gp.hyp, gp.alpha, gp.Binv, vp.mu,
                              vp.sigma, vp.lam, vp.w) + out_bytes)


def ideal_seconds(work, peak):
    """The least time the card could take: the larger of operations over
    the FP64 tensor-core peak and bytes over the memory bandwidth."""
    return max(work["flops"] / (peak["fp64_tflops"] * 1e12),
               work["bytes"] / (peak["hbm_tb_s"] * 1e12))


def roofline_pct(run, kind):
    """Least possible time of the window's ``kind`` sweeps over the device
    time inside their spans, in percent; None without such a span."""
    sw = [s for s in run["sweeps"] if s["kind"] == kind and "device_s" in s]
    dev = sum(s["device_s"] for s in sw)
    if not sw or dev <= 0 or run.get("peak") is None:
        return None
    return 100.0 * sum(ideal_seconds(s["work"], run["peak"])
                       for s in sw) / dev
