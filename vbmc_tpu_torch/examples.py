"""Worked examples (cf. `vbmc_tpu/examples.py`, `vbmc_examples.m`: basic,
bounds, diagnostics, multi-run validation, priors, noisy via IBS) and the
bundled test densities (`rosenbrock_test.m`, `utils/psycho_gen.m`). Each
example returns its VBMC result and runs on the card unless ``device``
names another:

    python -m vbmc_tpu_torch.examples [1-6] [--device cpu]

After the example's own display the command prints one JSON line: the
example's number, ELBO, its SD, exit flag, evaluations, acquired points,
wall seconds, timers, the launches of each sweep kernel and the posterior
mean (for example 4 each run's, as lists), and for examples 3 and 4 the
diagnostics' verdict.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vbmc_tpu_torch.options import VBMCOptions


def rosenbrock_test(x) -> float:
    """Broad Rosenbrock-like posterior (cf. `rosenbrock_test.m`):
    log p = -|x1^2 - x2|^2 / 2 - x1^2/2 ... extended to D dims pairwise."""
    x = np.atleast_1d(np.asarray(x, float))
    ll = 0.0
    for i in range(len(x) - 1):
        ll += -((x[i] ** 2 - x[i + 1]) ** 2) / 2.0
    ll += -np.sum(x ** 2) / 2.0
    return float(ll)


def psycho_gen(params, stimuli, rng):
    """Simulator of a simple psychometric model (cf. `utils/psycho_gen.m`):
    binary response with probit link, guess/lapse rates."""
    mu, log_sigma, lapse = params[0], params[1], params[2]
    sigma = np.exp(log_sigma)
    from math import erf
    p_right = np.array([0.5 * (1 + erf((s - mu) / (np.sqrt(2) * sigma)))
                        for s in np.atleast_1d(stimuli)])
    p_right = lapse / 2 + (1 - lapse) * p_right
    return (rng.random(p_right.shape) < p_right).astype(int)


def example_1_basic(seed=1, max_fun_evals=None, device="cuda"):
    """Basic usage: unconstrained 2-D Rosenbrock-like posterior."""
    from vbmc_tpu_torch import vbmc
    opts = VBMCOptions(display="iter", seed=seed,
                       max_fun_evals=max_fun_evals)
    return vbmc(rosenbrock_test, x0=np.zeros(2), plb=np.full(2, -3.0),
                pub=np.full(2, 3.0), options=opts, device=device)


def example_2_bounds(seed=2, max_fun_evals=None, device="cuda"):
    """Hard bounds: half-normal target on [0, 10]^2."""
    from vbmc_tpu_torch import vbmc
    sd = np.array([1.0, 0.6])

    def logp(x):
        return float(-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
                     - np.sum(np.log(sd)))
    opts = VBMCOptions(display="iter", seed=seed,
                       max_fun_evals=max_fun_evals)
    return vbmc(logp, x0=np.array([0.5, 0.5]), lb=np.zeros(2),
                ub=np.full(2, 10.0), plb=np.full(2, 0.05),
                pub=np.full(2, 3.0), options=opts, device=device)


def example_3_diagnostics(seed=3, max_fun_evals=60, device="cuda"):
    """Run diagnostics on an under-budgeted run."""
    from vbmc_tpu_torch import vbmc, vbmc_diagnostics
    opts = VBMCOptions(display="iter", seed=seed,
                       max_fun_evals=max_fun_evals)
    res = vbmc(rosenbrock_test, x0=np.zeros(2), plb=np.full(2, -3.0),
               pub=np.full(2, 3.0), options=opts, device=device)
    diag = vbmc_diagnostics([res])
    print(diag.message)
    return res, diag


def example_4_multirun(seed=4, n_runs=3, max_fun_evals=None, device="cuda"):
    """Multi-run validation: several independent runs + cross diagnostics."""
    from vbmc_tpu_torch import vbmc, vbmc_diagnostics
    results = []
    for i in range(n_runs):
        opts = VBMCOptions(display="final", seed=seed + i,
                           max_fun_evals=max_fun_evals)
        results.append(vbmc(rosenbrock_test, x0=np.zeros(2),
                            plb=np.full(2, -3.0), pub=np.full(2, 3.0),
                            options=opts, device=device))
    diag = vbmc_diagnostics(results)
    print(diag.message)
    return results, diag


def example_5_priors(seed=5, max_fun_evals=None, device="cuda"):
    """Composing a likelihood with a proper smooth-box prior."""
    from vbmc_tpu_torch import vbmc
    from vbmc_tpu_torch import priors

    def loglike(x):
        return float(-0.5 * np.sum((x / 0.8) ** 2))

    def logp(x):
        lp = float(priors.smoothbox_logpdf(np.asarray(x)[None, :], -2.0, 2.0,
                                           0.4)[0])
        return loglike(x) + lp

    opts = VBMCOptions(display="iter", seed=seed,
                       max_fun_evals=max_fun_evals)
    return vbmc(logp, x0=np.zeros(2), plb=np.full(2, -2.0),
                pub=np.full(2, 2.0), options=opts, device=device)


def example_6_noisy_ibs(seed=6, max_fun_evals=None, n_trials=200,
                        device="cuda"):
    """Noisy log-likelihood via inverse binomial sampling on the
    psychometric simulator (cf. Example 6 in `vbmc_examples.m`)."""
    from vbmc_tpu_torch import vbmc
    from vbmc_tpu_torch.utils.ibs import ibs_loglike_and_sd

    rng_data = np.random.default_rng(0)
    stimuli = rng_data.uniform(-3, 3, n_trials)
    true_params = np.array([0.5, np.log(1.0), 0.05])
    responses = psycho_gen(true_params, stimuli, rng_data)

    def noisy_ll(params):
        rng = np.random.default_rng(abs(hash(tuple(np.round(params, 8)))) %
                                    2 ** 31)
        return ibs_loglike_and_sd(psycho_gen, params, responses, stimuli,
                                  n_reps=2, rng=rng)

    opts = VBMCOptions(display="iter", seed=seed, specify_target_noise=True,
                       max_fun_evals=max_fun_evals)
    return vbmc(noisy_ll, x0=np.array([0.0, 0.0, 0.1]),
                lb=np.array([-5.0, -3.0, 0.005]),
                ub=np.array([5.0, 3.0, 0.5]),
                plb=np.array([-2.0, -1.0, 0.01]),
                pub=np.array([2.0, 1.0, 0.2]), options=opts, device=device)


EXAMPLES = {1: example_1_basic, 2: example_2_bounds, 3: example_3_diagnostics,
            4: example_4_multirun, 5: example_5_priors,
            6: example_6_noisy_ibs}


def summary(which, out, seconds, launches, device):
    """The JSON-ready record of one example's return value ``out``."""
    import torch

    from vbmc_tpu_torch.vp import vp_moments

    runs, diag = out if isinstance(out, tuple) else (out, None)
    many = isinstance(runs, list)
    per_run = {k: [] for k in ("elbo", "elbo_sd", "exit_flag", "func_count",
                               "acquired", "timers", "mean")}
    for res in runs if many else [runs]:
        gen = torch.Generator(device=device).manual_seed(0)
        mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5,
                             gen=gen)
        # the examples keep the default initial design
        start = VBMCOptions().resolve(res.vp.D).fun_eval_start
        for k, v in (("elbo", float(res.elbo)),
                     ("elbo_sd", float(res.elbo_sd)),
                     ("exit_flag", int(res.exitflag)),
                     ("func_count", int(res.func_count)),
                     ("acquired", int(res.func_count) - start),
                     ("timers", {t: float(x) for t, x in res.timers.items()}),
                     ("mean", mean.cpu().tolist())):
            per_run[k].append(v)
    rec = {"example": which,
           **{k: v if many else v[0] for k, v in per_run.items()},
           "seconds": seconds, "launches": launches, "device": device}
    if diag is not None:
        rec["diagnostics"] = {"exitflag": int(diag.exitflag),
                              "best": diag.best, "message": diag.message}
    return rec


def main(argv=None):
    from vbmc_tpu_torch import kernels

    parser = argparse.ArgumentParser(
        prog="python -m vbmc_tpu_torch.examples",
        description="Run one of the worked examples.")
    parser.add_argument("which", nargs="?", type=int, default=1,
                        choices=sorted(EXAMPLES))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    sweeps = (kernels.prospective_acq, kernels.viqr_acq)
    for k in sweeps:
        k.launches = 0
    t = time.monotonic()
    out = EXAMPLES[args.which](device=args.device)
    seconds = time.monotonic() - t
    print(json.dumps(summary(args.which, out, seconds,
                             {k.name: k.launches for k in sweeps},
                             args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
