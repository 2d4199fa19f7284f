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


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py"])
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
@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py"])
def test_card_scripts_fail_without_a_gpu(script, alone, tmp_path):
    if alone:
        shutil.copy(ROOT / script, tmp_path / script)
    cwd = tmp_path if alone else ROOT
    out = subprocess.run([sys.executable, script], cwd=cwd,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


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
