"""The comparison that decides ``correct``: what the timed path produced,
recomputed by the plain reference (`benchmark/reference.py`) from the
run's inputs.

Numbers compared (each against its limit in ``limits/<cell>.json``):

- ``train``: the last GP's training set against the benchmark's own record
  of every target call, put into the GP's space by the reference's own
  transform (the rotation and scaling of an input warp, and which points
  the program keeps active, are taken from the program's state). Relative
  gap of inputs, outputs and noise variances; inf if the rows do not
  correspond one to one.
- ``gp_alpha``, ``gp_binv``: that GP's posterior, the program's alpha and
  inverse Gram matrix of every valid sample, judged by their normwise
  backward errors against the reference's Gram matrix and residual from
  the same rows and hyperparameter samples (a measure that does not grow
  with the matrix's condition, as a gap between two solutions would).
- ``elbo_G``: the expected log joint that `vpoptimize` returned with its
  posterior, for the window's last call and the final boost, against the
  reference's Bayesian quadrature of that posterior under that GP (nats).
- ``acq``: two sweep calls of the window (the last, one drawn from the
  seed): the program's values against the reference's acquisition on the
  same candidates (relative to the largest |value| for "prospective",
  absolute in log units for VIQR; inf where the two disagree on which
  candidates the hard bounds reject). The importance-sampling set (points
  and log weights) is the program's state.
- ``acq_determined``, where a cell's limits name it in place of ``acq``:
  the largest relative gap of a "prospective" sweep at the candidates
  whose value float64 rounding determines to better than ``DETERMINED``
  (`reference.prospective_condition`). A GP whose Gram matrix is nearly
  singular (a noiseless target with few, close rows) has a predictive
  variance that is rounding near its rows, where ``acq`` reads order 1 for
  any two float64 programs.

``elbo_G`` and ``acq`` read each GP through its own alpha and inverse Gram
matrix, once these pass the backward-error test above; so each number
judges one stage, and none inherits the condition of the Gram matrix.
- late cells: ``elbo_err`` |ELBO - lnZ| and ``rmse`` of the posterior
  mean (the reference's draws from the returned posterior) against the
  configuration's truth, with the limits the configuration states.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference as ref

N_MEAN_DRAWS = 100000  # reference draws for the posterior mean
DETERMINED = 1e-4      # the rounding bound of an ``acq_determined`` candidate


def _np(t):
    """A tensor on the host in float64 (bool tensors as they are)."""
    if t.dtype.is_floating_point:
        t = t.double()
    return t.detach().cpu().numpy()


def gp_state(gp):
    """Valid rows and samples of a program GP, on the host in float64."""
    m = _np(gp.mask).astype(bool)
    hm = _np(gp.hyp_mask).astype(bool)
    return dict(X=_np(gp.X)[m], y=_np(gp.y)[m], s2=_np(gp.s2)[m],
                hyp=_np(gp.hyp)[hm], alpha=_np(gp.alpha)[hm][:, m],
                Binv=_np(gp.Binv)[hm][:, m][:, :, m])


def vp_state(vp):
    k = _np(vp.kmask).astype(bool)
    w = _np(vp.w)[k]
    return dict(mu=_np(vp.mu)[k], sigma=_np(vp.sigma)[k], lam=_np(vp.lam),
                w=w / w.sum(), R=_np(vp.trinfo.R_mat),
                scale=_np(vp.trinfo.scale))


def check_config(cfg):
    """The GP model the reference implements: SE-ard, negquad mean, one
    constant noise term (plus the target's own noise), no output warp,
    no integrated mean."""
    ok = (cfg.covfun == 1 and cfg.meanfun == 4 and cfg.const_noise == 1
          and cfg.user_noise in (0, 1) and cfg.output_noise == 0
          and cfg.intmean == 0 and cfg.outwarp == 0)
    if not ok:
        raise ValueError(f"the reference does not implement GP {cfg}")


def capture(rec, res):
    """Host copies of everything the comparison reads, so that the
    program's device state can be freed before the reference runs."""
    lg = res.logger
    n = lg.Xn
    out = dict(
        train=dict(gp=gp_state(rec.train["gp"]),
                   n_calls=rec.train["n_calls"]),
        logger=dict(X=lg.X[:n].copy(), y_orig=lg.y_orig[:n].copy(),
                    flag=lg.X_flag[:n].copy(),
                    R=np.asarray(lg.trinfo.host()["R_mat"]),
                    scale=np.asarray(lg.trinfo.host()["scale"])),
        vpopt=[], sweeps=[], elbo=float(res.elbo), vp=vp_state(res.vp))
    check_config(rec.train["cfg"])
    for v in (rec.vpopt_window, rec.vpopt_last):
        if v is not None:
            check_config(v["cfg"])
            out["vpopt"].append(dict(gp=gp_state(v["gp"]),
                                     vp=vp_state(v["res"].vp),
                                     G=float(v["res"].G)))
    for key in ("last", "drawn"):
        c = rec.kept.get(key)
        if c is None:
            continue
        args = c["args"]
        check_config(args[0])
        sw = dict(kind=c["kind"], Xs=_np(args[2]), vp=vp_state(args[3]),
                  gp=gp_state(args[4]), ymax=float(args[5].ymax),
                  tol_var=float(args[5].tol_var), out=_np(c["out"]))
        if c["kind"] == "viqr_acq":
            ais = args[6]
            hm = _np(args[4].hyp_mask).astype(bool)
            sw["Xa"] = _np(ais.Xa)
            sw["lnw"] = _np(ais.ln_weights)[hm]
        out["sweeps"].append(sw)
    return out


def _posterior(g):
    """The reference's GP on a program GP's rows and hyperparameters, read
    through the program's factorisation."""
    return ref.Posterior(g["X"], g["y"], g["s2"], g["hyp"],
                         factors=(g["alpha"], g["Binv"]))


def _train_gap(cap, calls, fields):
    """Gap between the last GP's rows and the benchmark's records."""
    tr, lg = cap["train"], cap["logger"]
    n = tr["n_calls"]
    if lg["X"].shape[0] != n or len(calls) < n:
        return float("inf")
    x = np.array([c[2] for c in calls[:n]])
    y = np.array([c[3] for c in calls[:n]])
    sd = np.array([np.nan if c[4] is None else c[4] for c in calls[:n]])
    U, logj = ref.to_train_space(fields, x, lg["R"], lg["scale"])
    act = lg["flag"].astype(bool)
    g = tr["gp"]
    if g["X"].shape[0] != act.sum():
        return float("inf")
    gaps = [np.abs(g["X"] - U[act]).max() / max(1.0, np.abs(U).max()),
            (np.abs(g["y"] - (y + logj)[act])
             / np.maximum(1.0, np.abs(y[act]))).max(),
            np.abs(lg["y_orig"] - y).max() / max(1.0, np.abs(y).max())]
    if np.all(np.isfinite(sd)):
        gaps.append((np.abs(g["s2"] - sd[act] ** 2)
                     / np.maximum(1.0, sd[act] ** 2)).max())
    elif np.any(g["s2"] != 0):
        return float("inf")
    return float(max(gaps))


def _gp_residuals(cap):
    """Backward errors of the last GP and of every GP the comparison reads
    through its factorisation (the sweeps' and `vpoptimize`'s)."""
    gps = ([cap["train"]["gp"]] + [v["gp"] for v in cap["vpopt"]]
           + [sw["gp"] for sw in cap["sweeps"]])
    res = [_posterior(g).residuals() for g in gps]
    return max(r[0] for r in res), max(r[1] for r in res)


def _elbo_gap(cap):
    gaps = [0.0]
    for v in cap["vpopt"]:
        G = ref.expected_log_joint(_posterior(v["gp"]), v["vp"]["mu"],
                                   v["vp"]["sigma"], v["vp"]["lam"],
                                   v["vp"]["w"])
        gaps.append(abs(v["G"] - G))
    return float(max(gaps))


def _acq_gap(cap, fields, tol_bound_x, determined=False):
    """The sweeps' gap (see the module's docstring); with ``determined``
    the largest relative gap of a "prospective" sweep over the candidates
    whose value float64 rounding cannot move by more than
    ``DETERMINED`` (`reference.prospective_condition`); inf where no
    candidate is."""
    gaps = [0.0]
    for sw in cap["sweeps"]:
        post = _posterior(sw["gp"])
        vp = sw["vp"]
        if sw["kind"] == "viqr_acq":
            a = ref.viqr(post, sw["Xs"], sw["Xa"], sw["lnw"], sw["tol_var"])
        else:
            a = ref.prospective(post, (vp["mu"], vp["sigma"], vp["lam"],
                                       vp["w"]), sw["Xs"], sw["ymax"],
                                sw["tol_var"])
        out = ref.outside_eps_box(fields, sw["Xs"], vp["R"], vp["scale"],
                                  tol_bound_x)
        a = np.where(out, np.inf, a)
        p = sw["out"]
        fin = np.isfinite(a)
        if np.any(fin != np.isfinite(p)) or not fin.any():
            return float("inf")
        d = np.abs(p[fin] - a[fin])
        if determined and sw["kind"] != "viqr_acq":
            ok = ref.prospective_condition(post, sw["Xs"][fin],
                                           sw["tol_var"]) < DETERMINED
            if not ok.any():
                return float("inf")
            gaps.append(float((d[ok] / np.maximum(np.abs(a[fin][ok]),
                                                  np.finfo(float).tiny)).max()))
        elif sw["kind"] == "viqr_acq":
            gaps.append(float(d.max()))
        else:
            gaps.append(float(d.max() / np.abs(a[fin]).max()))
    return float(max(gaps))


def _posterior_mean(cap, fields, rng):
    """Mean of the returned posterior in original space by the reference's
    own draws."""
    vp = cap["vp"]
    k = rng.choice(len(vp["w"]), N_MEAN_DRAWS, p=vp["w"])
    U = vp["mu"][k] + (vp["sigma"][k, None] * vp["lam"][None]
                       * rng.standard_normal((N_MEAN_DRAWS,
                                              vp["mu"].shape[1])))
    return ref.to_orig_space(fields, U, vp["R"], vp["scale"]).mean(0)


def judge(cap, calls, box, cfg, truth, answer, limits, seed,
          tol_bound_x=1e-5):
    """{name: {"value", "limit"}} of every number compared for this cell;
    ``box`` is (lb, ub, plb, pub) as the run used them."""
    rng = np.random.default_rng([seed, 3])
    fields = ref.transform_fields(*box)
    vals = dict(train=_train_gap(cap, calls, fields))
    vals["gp_alpha"], vals["gp_binv"] = _gp_residuals(cap)
    vals["elbo_G"] = _elbo_gap(cap)
    vals["acq"] = _acq_gap(cap, fields, tol_bound_x)
    if "acq_determined" in limits:
        vals["acq_determined"] = _acq_gap(cap, fields, tol_bound_x,
                                          determined=True)
    if answer:
        for name in cfg["answer_limits"]:
            if name == "elbo_err":
                vals[name] = abs(cap["elbo"] - truth["lnz"])
            elif name == "rmse":
                m = _posterior_mean(cap, fields, rng)
                vals[name] = float(np.sqrt(np.mean((m - truth["mean"]) ** 2)))
    lim = dict(limits)
    if answer:
        lim.update(cfg["answer_limits"])
    return {k: dict(value=v, limit=lim.get(k)) for k, v in vals.items()}


def compared(checks):
    """The numbers the cell compares: those its limits file (or its
    configuration, for the answer) gives a limit."""
    return {k: c for k, c in checks.items() if c["limit"] is not None}


def verdict(checks):
    """True when every number compared is finite and within its limit."""
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in compared(checks).values())
