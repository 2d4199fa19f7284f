"""The port imports no jax and nothing of `vbmc_tpu`, `vbmc` defaults to the
card, and the port's copy of GPConfig equals the reference's in fields, ids
and hyperparameter counts."""

import ast
import dataclasses
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import vbmc_tpu.gp.config as jcfg
import vbmc_tpu_torch
import vbmc_tpu_torch.gp.config as tcfg

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    names = ["vbmc_tpu_torch"]
    for mod in pkgutil.walk_packages(vbmc_tpu_torch.__path__,
                                     "vbmc_tpu_torch."):
        names.append(mod.name)
    return names


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "vbmc_tpu_torch.main" in mods and "vbmc_tpu_torch.kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'jaxlib' or k.startswith('jaxlib.')\n"
            "             or k == 'vbmc_tpu' or k.startswith('vbmc_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# The library names off the default path, each from the module that holds
# it (`tests/test_torch_library_names.py` holds each against the reference).
LIBRARY_NAMES = {
    "vbmc_tpu_torch.gp": [
        "GPConfig", "GP", "HypPrior", "gram_matrix", "build_posterior",
        "neg_log_marginal_likelihood", "hyperprior_logpdf", "gp_predict",
        "gp_predict_full", "train_gp", "TrainOptions",
        "fix_center_from_data"],
    "vbmc_tpu_torch.gp.core": ["Posterior", "solve_K", "predict_one",
                               "gram_matrix"],
    "vbmc_tpu_torch.gp.kernels": ["kernel_diag"],
    "vbmc_tpu_torch.gp.outwarp": ["OUTWARP_NONE", "OUTWARP_NEGPOW",
                                  "OUTWARP_NEGPOWC1", "OUTWARP_NEGSCALEDPOW"],
    "vbmc_tpu_torch.elbo": ["theta_size", "entropy_upper_bound"],
    "vbmc_tpu_torch.transforms": ["pdf_correction"],
    "vbmc_tpu_torch.active_is": ["build_is_state"],
    "vbmc_tpu_torch.samplers.slice": ["slice_sample_chain",
                                      "slice_sample_ensemble"],
    "vbmc_tpu_torch.vpoptim": ["vp_sample_theta"],
}


@pytest.mark.parametrize("module", sorted(LIBRARY_NAMES))
def test_library_names_import_without_jax(module):
    """Each name from its module, in a fresh interpreter that then holds
    no jax and nothing of `vbmc_tpu`."""
    code = (f"from {module} import {', '.join(LIBRARY_NAMES[module])}\n"
            "import sys\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', "
            "'vbmc_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_port_source_imports_the_jax_package():
    bad = []
    for path in sorted((ROOT / "vbmc_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "vbmc_tpu")]
    assert not bad, bad


def test_vbmc_defaults_to_the_card_and_raises_without_one():
    import inspect

    import numpy as np
    import torch

    from vbmc_tpu_torch import VBMCOptions, vbmc

    params = inspect.signature(vbmc).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default == torch.float64
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    calls = []

    def logp(x):
        calls.append(x)
        return -0.5 * float(np.sum(x ** 2))

    with pytest.raises((RuntimeError, AssertionError)):
        vbmc(logp, x0=np.zeros(2), plb=-np.ones(2), pub=np.ones(2),
             options=VBMCOptions(display="off", max_fun_evals=10))
    assert not calls   # the target was never evaluated on the CPU instead


@pytest.mark.parametrize("name", ["create_trinfo", "train_gp"])
def test_exported_builders_default_to_the_card_and_raise_without_one(name):
    """`create_trinfo` and `gp.train_gp` build on the card unless told
    otherwise, as `vbmc` does: without a card the default raises instead of
    building CPU tensors."""
    import inspect

    import numpy as np
    import torch

    import vbmc_tpu_torch.gp as tgp

    fn = {"create_trinfo": vbmc_tpu_torch.create_trinfo,
          "train_gp": tgp.train_gp}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    D = 2
    if name == "create_trinfo":
        args = ([-np.inf] * D, [np.inf] * D, [-2.0] * D, [2.0] * D)
    else:
        rng = np.random.default_rng(0)
        X = rng.uniform(-2, 2, (12, D))
        args = (torch.Generator().manual_seed(0),
                tcfg.GPConfig(D=D), X, -0.5 * np.sum(X ** 2, 1), None,
                np.full(D, -2.0), np.full(D, 2.0), tgp.TrainOptions())
    with pytest.raises((RuntimeError, AssertionError)):
        fn(*args)


# The scripts that run on the card: at the root, and as a module of the port.
CARD_SCRIPTS = ["chip_smoke.py", "chip_profile.py",
                "vbmc_tpu_torch/bench_kernels.py",
                "vbmc_tpu_torch/examples.py"]


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_only_the_port(script):
    tree = ast.parse((ROOT / script).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert "vbmc_tpu_torch" in {n.split(".")[0] for n in names}
    bad = sorted(n for n in names if n.split(".")[0] in
                 ("jax", "jaxlib", "vbmc_tpu"))
    assert not bad, bad


@pytest.mark.parametrize("alone", [False, True])
@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_fail_without_a_gpu(script, alone, tmp_path):
    name = Path(script).name
    if alone:
        shutil.copy(ROOT / script, tmp_path / name)
        cmd = [sys.executable, name]
    elif "/" in script:
        cmd = [sys.executable, "-m", script[:-3].replace("/", ".")]
    else:
        cmd = [sys.executable, script]
    cwd = tmp_path if alone else ROOT
    out = subprocess.run(cmd, cwd=cwd,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# What the worked examples' phase of `chip_smoke.py` runs, in the script's
# process and in its child process (`example_child`).
EXAMPLE_PHASE = ("example_truth", "psycho_data", "psycho_loglike",
                 "_psycho_q", "_psycho_box", "_gl_axis", "example_child",
                 "ExampleAlongside", "phase_examples", "compare_example",
                 "compare_noisy", "phase_acquisitions")


def _example_phase_imports():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    found, names = set(), set()
    for node in tree.body:
        if getattr(node, "name", None) in EXAMPLE_PHASE:
            found.add(node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    names.update(a.name for a in sub.names)
                elif isinstance(sub, ast.ImportFrom):
                    names.add(sub.module)
    assert found == set(EXAMPLE_PHASE)
    return names


def test_example_phase_imports_only_the_port():
    names = _example_phase_imports()
    assert "vbmc_tpu_torch.examples" in names and "scipy" in names
    bad = sorted(n for n in names if n.split(".")[0] in
                 ("jax", "jaxlib", "vbmc_tpu"))
    assert not bad, bad


def test_example_phase_loads_no_jax_and_the_oracle_no_torch():
    """In a fresh interpreter: `example_truth` (numpy and scipy) loads no
    torch; then every module the phase and its child import loads no jax
    and nothing of `vbmc_tpu`."""
    mods = sorted(_example_phase_imports())
    code = ("import importlib, sys, chip_smoke\n"
            "chip_smoke.example_truth(2)\n"
            "chip_smoke.example_truth(6)\n"
            "assert 'torch' not in sys.modules\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', "
            "'vbmc_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_gpconfig_copy_matches_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.GPConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.GPConfig)]
    assert jf == tf
    ids = [n for n in dir(jcfg) if n.isupper()]
    assert ids == [n for n in dir(tcfg) if n.isupper()]
    for n in ids:
        assert getattr(jcfg, n) == getattr(tcfg, n), n


@pytest.mark.parametrize("D", [1, 2, 3, 6, 10])
@pytest.mark.parametrize("meanfun", [0, 1, 4, 6, 8, 10, 12, 14, 16, 18, 20,
                                     22])
def test_gpconfig_counts_match_reference(D, meanfun):
    a = jcfg.GPConfig(D=D, meanfun=meanfun)
    b = tcfg.GPConfig(D=D, meanfun=meanfun)
    for prop in ("n_ell", "ncov", "nnoise", "nmean", "nint", "noutwarp",
                 "nhyp", "sl_log_ell", "idx_log_sf", "sl_noise", "sl_mean",
                 "sl_outwarp"):
        assert getattr(a, prop) == getattr(b, prop), prop
