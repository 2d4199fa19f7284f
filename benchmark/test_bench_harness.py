"""CPU tests of the benchmark (run from the repository root):

    python -m pytest benchmark/test_bench_harness.py -q

Every configuration, traffic mix and metric reader loads; a tiny run of
each cell on the CPU prints a well-formed last line and passes its
comparison; the reference's formulas agree with closed forms and with
Monte Carlo; the control (the program's float32 lane) and the faults of
the timed path come out as not correct; no module the benchmark runs is
JAX or the JAX package. The test marked ``cuda`` runs one cell at its own
size on the card and skips without one.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import reference as ref
from benchmark import run as brun

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# The noisy deployment and its past-warm-up traffic are ready in the
# folder but are no cell of BENCHMARK.json (PERF.md, Open questions); the
# tests drive them as one, with the limits that cell held on the card with
# warm-up off.
NOISY_SPEC = dict(
    SPEC,
    configs=SPEC["configs"] + [{"name": "ibs3",
                                "file": "benchmark/configs/ibs3.json"}],
    workloads=SPEC["workloads"] + [{"name": "ibs3.late", "config": "ibs3",
                                    "traffic": "past_warmup", "chips": 1}],
    per_layer=SPEC["per_layer"] + [
        {"name": n, "unit": u, "workloads": ["ibs3.late"]}
        for n, u in (("quick_update.per_point", "updates/point"),
                     ("viqr_acq_roofline", "%"))])
NOISY_LIMITS = {"ibs3.late": {"train": 1e-10, "gp_alpha": 1e-10,
                              "gp_binv": 1e-9, "elbo_G": 1e-8,
                              "acq": 3e-7}}
ALL_CELLS = CELLS + list(NOISY_LIMITS)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def tiny(n_start):
    """A tweak that shrinks a cell to a few seconds on the CPU: a late
    start from ``n_start`` points, a small candidate set and final boost."""
    def tweak(cfg, traffic):
        if traffic["n_start"]:
            traffic["n_start"] = n_start
            traffic["n_uniform"] = max(1, n_start // 5)
            traffic["options"].update(fun_eval_start=n_start,
                                      min_fun_evals=n_start + 20,
                                      max_fun_evals=n_start + 20)
        cfg["options"].update(min_final_components=8, ns_search=256)
    return tweak


TINY_N = {"ibs3": 12, "d10k50": 40, "rosen2": 0}


def run_tiny(cell, seed=20260417, **kw):
    conf = {w["name"]: w for w in NOISY_SPEC["workloads"]}[cell]["config"]
    return brun.run_cell(cell, seed, 0.5, False, device="cpu",
                         tweak=tiny(TINY_N[conf]), spec=NOISY_SPEC,
                         limits=NOISY_LIMITS.get(cell), **kw)


# ------------------------------------------------------------ the files

def test_benchmark_json_names_and_files():
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists()
        assert (ROOT / c["file"].replace(".json", ".py")).exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in SPEC["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("conf", sorted(p.stem for p in
                                         (HERE / "configs").glob("*.json")))
def test_config_loads_and_truth(conf):
    cfg = brun.load_json(HERE / "configs" / f"{conf}.json")
    assert cfg["name"] == conf and len(cfg["source"]) <= 200
    mod = brun.load_module(HERE / "configs" / f"{conf}.py")
    t = mod.truth(cfg)
    assert np.isfinite(t["lnz"]) and t["mean"].shape == (cfg["D"],)
    assert np.all(np.linalg.eigvalsh(t["cov"]) > 0)
    fun = mod.make_target(cfg)
    out = fun(np.array(cfg["x0"], float))
    assert np.all(np.isfinite(np.atleast_1d(out)))
    assert out == fun(np.array(cfg["x0"], float))   # the same each time


def test_ibs3_truth_matches_its_published_value():
    """The oracle's lnZ of example 6 (-65.7091, as
    `chip_smoke.example_truth(6)` reads it)."""
    cfg = brun.load_json(HERE / "configs/ibs3.json")
    t = brun.load_module(ROOT / "benchmark/configs/ibs3.py").truth(cfg)
    assert abs(t["lnz"] - (-65.7091)) < 1e-3


@pytest.mark.parametrize("traffic", ["late", "past_warmup", "early"])
def test_traffic_loads_and_repeats(traffic):
    from benchmark import generator
    tr = brun.load_json(HERE / "traffic" / f"{traffic}.json")
    cfg = brun.load_json(HERE / "configs/d10k50.json")
    truth = brun.load_module(HERE / "configs/d10k50.py").truth(cfg)
    a = generator.starting_points(cfg, truth, tr, 2 ** 31 + 5)
    b = generator.starting_points(cfg, truth, tr, 2 ** 31 + 5)
    assert np.array_equal(a, b)
    assert a.shape == (max(tr["n_start"], 1), cfg["D"])


# --------------------------------------------------------- the reference

def _hyp(D, rng, log_sn=-3.0):
    return np.concatenate([np.log(rng.uniform(0.5, 1.5, D)), [0.3],
                           [log_sn], [1.0], rng.normal(0, 0.3, D),
                           np.log(rng.uniform(1.0, 3.0, D))])[None]


def test_gp_posterior_closed_form_one_point():
    rng = np.random.default_rng(1)
    D = 2
    hyp = _hyp(D, rng)
    X, y = rng.normal(size=(1, D)), np.array([0.7])
    post = ref.Posterior(X, y, None, hyp)
    ell, sf2, sn2, m0, xm, om2 = ref.unpack(hyp, D)
    m = m0[0] - 0.5 * (((X[0] - xm[0]) ** 2) / om2[0]).sum()
    assert np.isclose(post.alpha[0, 0], (y[0] - m) / (sf2[0] + sn2[0]))
    fmu, fs2 = post.predict(X)
    assert np.isclose(fmu[0, 0], m + sf2[0] * (y[0] - m) / (sf2[0] + sn2[0]))
    assert np.isclose(fs2[0, 0], sf2[0] - sf2[0] ** 2 / (sf2[0] + sn2[0]))


def test_residuals_separate_float64_from_float32():
    """The backward errors read about 1e-16 for the reference's own float64
    solve and about 1e-7 for the same factors rounded to float32."""
    rng = np.random.default_rng(5)
    D, N = 3, 40
    hyp = _hyp(D, rng, log_sn=-6.0)
    post = ref.Posterior(rng.normal(size=(N, D)), rng.normal(size=N), None,
                         hyp)
    assert max(post.residuals()) < 1e-13
    f32 = (post.alpha.astype(np.float32), post.Binv.astype(np.float32))
    low = ref.Posterior(post.X, post.y, None, hyp, factors=f32)
    assert min(low.residuals()) > 1e-9


def test_residuals_accept_the_jitter_of_a_failed_cholesky():
    """A factorisation of B plus the shift of gplite's ladder that B calls
    for (its first Cholesky fails: repeated rows and no noise) reads as a
    float64 solve."""
    rng = np.random.default_rng(6)
    D, N = 2, 30
    hyp = _hyp(D, rng, log_sn=-30.0)
    X = np.repeat(rng.normal(size=(6, D)), 5, axis=0)
    post = ref.Posterior(X, rng.normal(size=N), None, hyp)
    B = post.B[0]
    assert not ref._factors(B)
    shifts = [j for j in ref.jitter_steps(B) if ref._factors(B + j * np.eye(N))]
    assert shifts and 0.0 not in shifts
    for jit in shifts:
        Binv = np.linalg.inv(B + jit * np.eye(N))
        fac = ((Binv @ post.r[0])[None], Binv[None])
        assert max(ref.Posterior(X, post.y, None, hyp,
                                 factors=fac).residuals()) < 1e-12


@pytest.mark.parametrize("rel", [1e-6, 1e-3, 1e-1])
def test_residuals_refuse_a_jitter_that_b_does_not_need(rel):
    """A well-conditioned B factors unshifted; a solve of B plus a jitter of
    ``rel`` times its mean diagonal reads about ``rel``."""
    rng = np.random.default_rng(6)
    D, N = 2, 30
    hyp = _hyp(D, rng)
    X, y = rng.normal(size=(N, D)), rng.normal(size=N)
    post = ref.Posterior(X, y, None, hyp)
    assert ref.jitter_steps(post.B[0]) == [0.0]
    B = post.B[0] + np.abs(np.diag(post.B[0])).mean() * rel * np.eye(N)
    Binv = np.linalg.inv(B)
    jit = ref.Posterior(X, y, None, hyp,
                        factors=((Binv @ post.r[0])[None], Binv[None]))
    assert min(jit.residuals()) > 0.05 * rel


def test_prospective_condition_keeps_what_float64_determines():
    """On a nearly singular GP (a noiseless target sampled densely) two
    float64 solves disagree in "prospective" by order 1 near the rows, and
    agree within the rounding bound at the candidates it keeps; factors
    rounded to float32 disagree there."""
    rng = np.random.default_rng(7)
    D, N, M = 2, 40, 2000
    hyp = _hyp(D, rng, log_sn=-12.0)
    hyp[0, :D] = np.log(2.0)
    X = rng.normal(scale=0.5, size=(N, D))
    y = -0.5 * (X ** 2).sum(1)
    post = ref.Posterior(X, y, None, hyp)
    inv = np.linalg.inv(post.B[0])[None]
    other = ref.Posterior(X, y, None, hyp,
                          factors=((inv[0] @ post.r[0])[None], inv))
    low = ref.Posterior(X, y, None, hyp, factors=(
        post.alpha.astype(np.float32), post.Binv.astype(np.float32)))
    vp = (np.zeros((1, D)), np.ones(1), np.ones(D), np.ones(1))
    Xs = np.concatenate([X + 1e-3 * rng.normal(size=(N, D)),
                         rng.normal(scale=2.0, size=(M - N, D))])
    args = (vp, Xs, 0.0, 1e-4)
    a, b, c = (ref.prospective(p, *args) for p in (post, other, low))
    ok = ref.prospective_condition(post, Xs, 1e-4) < 1e-4
    assert 0 < ok.sum() < M
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-300)
    assert rel.max() > 1e-2
    assert rel[ok].max() < 1e-4
    assert (np.abs(a - c) / np.abs(a))[ok].max() > 1e-2


def test_expected_log_joint_against_monte_carlo():
    rng = np.random.default_rng(2)
    D, N, K = 3, 20, 3
    hyp = np.concatenate([_hyp(D, rng), _hyp(D, rng)])
    X = rng.normal(size=(N, D))
    post = ref.Posterior(X, rng.normal(size=N), np.full(N, 0.1), hyp)
    mu, sigma = rng.normal(size=(K, D)), rng.uniform(0.3, 0.8, K)
    lam, w = rng.uniform(0.7, 1.3, D), np.array([0.2, 0.5, 0.3])
    G = ref.expected_log_joint(post, mu, sigma, lam, w)
    n = 400000
    k = rng.choice(K, n, p=w)
    Z = mu[k] + sigma[k, None] * lam[None] * rng.standard_normal((n, D))
    fmu = np.concatenate([post.predict(Z[i:i + 50000])[0]
                          for i in range(0, n, 50000)], axis=1)
    f = fmu.mean(0)
    assert abs(G - f.mean()) < 4 * f.std() / math.sqrt(n)


def test_transform_round_trip_and_jacobian():
    rng = np.random.default_rng(3)
    f = ref.transform_fields([-5.0, -np.inf], [5.0, np.inf], [-2.0, -1.0],
                             [2.0, 1.0])
    R = np.linalg.qr(rng.normal(size=(2, 2)))[0]
    scale = np.array([0.7, 1.3])
    x = np.array([[0.3, 4.0], [-4.9, -7.0]])
    U, logj = ref.to_train_space(f, x, R, scale)
    assert np.allclose(ref.to_orig_space(f, U, R, scale), x)
    h = 1e-6
    for i in range(2):
        J = np.stack([(ref.to_orig_space(f, U[i:i + 1] + h * e, R, scale)
                       - ref.to_orig_space(f, U[i:i + 1] - h * e, R,
                                           scale))[0]
                      / (2 * h) for e in np.eye(2)], 1)
        assert np.isclose(np.log(abs(np.linalg.det(J))), logj[i], atol=1e-6)


def test_viqr_single_sample_by_hand():
    """VIQR at one candidate against the formula written out once."""
    rng = np.random.default_rng(4)
    D, N, Na = 2, 6, 5
    post = ref.Posterior(rng.normal(size=(N, D)), rng.normal(size=N),
                         np.full(N, 0.2), _hyp(D, rng))
    C, Xa = rng.normal(size=(1, D)), rng.normal(size=(Na, D))
    lnw = np.log(np.full((1, Na), 1.0 / Na))
    a = ref.viqr(post, C, Xa, lnw, 1e-12)[0]
    ell, sf2 = post.ell[0], post.sf2[0]
    kC = ref.kernel(ell, sf2, post.X, C)[:, 0]
    kA = ref.kernel(ell, sf2, post.X, Xa)
    cov = ref.kernel(ell, sf2, C, Xa)[0] - kC @ post.Binv[0] @ kA
    fs2C = sf2 - kC @ post.Binv[0] @ kC
    s2a = sf2 - np.einsum("na,nm,ma->a", kA, post.Binv[0], kA)
    sn2 = post.sn2[0][np.argmin((((post.X - C) / ell) ** 2).sum(1))]
    s2p = s2a - cov ** 2 / (fs2C + sn2)
    expect = np.log(np.mean(2 * np.sinh(ref.U_IQR * np.sqrt(s2p))))
    assert np.isclose(a, expect, rtol=1e-10)


# -------------------------------------------------------- runs on the CPU

@pytest.mark.parametrize("cell", ALL_CELLS)
def test_dry_run_prints_a_well_formed_last_line(cell, capsys):
    out, checks = run_tiny(cell)
    line = json.loads(brun.result_line(out, checks))
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in brun.metric_names(NOISY_SPEC, cell, False)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    err = capsys.readouterr().err.strip().splitlines()
    n = len(line["checks"])
    assert n >= 3 and all(s.startswith("check ") for s in err[-n:])


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_float32_is_not_correct(cell):
    out, checks = run_tiny(cell, dtype="float32")
    assert out["correct"] is False, checks


def _stale_gp(monkeypatch):
    """A training step that returns its state unchanged: from the second
    call on, train_gp hands back the GP it returned first."""
    import vbmc_tpu_torch.main as vmain
    orig, first = vmain.train_gp, []

    def train_gp(*a, **k):
        out = orig(*a, **k)
        if first:
            return first[0], out[1]
        first.append(out[0])
        return out
    monkeypatch.setattr(vmain, "train_gp", train_gp)


def _half_sweep(monkeypatch):
    """Half of the candidates left out of the sweep, the mean of the other
    half put in their place."""
    import vbmc_tpu_torch.active_sample as vas
    for name in ("sweep_acquisition", "sweep_is_acquisition"):
        orig = getattr(vas, name)

        def sweep(*a, _orig=orig, **k):
            out = _orig(*a, **k).clone()
            h = out.shape[0] // 2
            fin = out[:h][out[:h].isfinite()]
            out[h:] = fin.mean()
            return out
        monkeypatch.setattr(vas, name, sweep)


def _altered_answer(monkeypatch):
    """The expected log joint altered where the variational fit produces
    it."""
    import vbmc_tpu_torch.main as vmain
    orig = vmain.vpoptimize

    def vpoptimize(*a, **k):
        res = orig(*a, **k)
        return res._replace(G=res.G * (1.0 + 1e-6) + 1e-6)
    monkeypatch.setattr(vmain, "vpoptimize", vpoptimize)


def _needless_jitter(rel):
    """The GP's Gram matrix factored with a jitter of ``rel`` times its mean
    diagonal where it needs none: an over-regularised posterior."""
    def fault(monkeypatch):
        import torch

        import vbmc_tpu_torch.gp.core as core
        orig = core.robust_cholesky

        def robust_cholesky(B):
            scale = torch.diagonal(B, dim1=-2, dim2=-1).abs().mean(-1)
            eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
            return orig(B + (rel * scale)[:, None, None] * eye)
        monkeypatch.setattr(core, "robust_cholesky", robust_cholesky)
    return fault


@pytest.mark.parametrize("fault", [_stale_gp, _half_sweep, _altered_answer,
                                   _needless_jitter(1e-6),
                                   _needless_jitter(1e-3),
                                   _needless_jitter(1e-1)],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered", "jitter_1e-6",
                              "jitter_1e-3", "jitter_1e-1"])
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_faults_of_the_timed_path_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out, checks = run_tiny(cell)
    assert out["correct"] is False, checks


# ------------------------------------------------------------- imports

def test_no_jax_in_the_benchmark_sources():
    for p in HERE.rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in brun.FORBIDDEN, (p, n)


def test_no_jax_module_after_a_run():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.test_bench_harness import run_tiny\n"
            "from benchmark.run import forbidden_modules\n"
            "run_tiny('ibs3.late')\n"
            "print('FORBIDDEN', forbidden_modules())\n" % str(ROOT))
    env = dict(os.environ)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout


def test_without_the_program_the_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_one_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[-1], "--seed", "977", "--seconds", "10"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
