"""A whole run of the port's `vbmc` on CPU tensors with repeated observations
of a noisy target, held to the gate of `test_torch_e2e_families.py`. A file
of its own: the per-point full updates make it the longest of the
whole-run cases."""

import numpy as np
import torch

from test_torch_e2e_families import _gate, _run
from test_torch_e2e_search import _noisy_halfnormal

torch.set_num_threads(1)


def test_noisy_halfnormal_with_repeated_observations():
    """The noisy half-normal of `tests/test_torch_e2e.py` with
    ``max_repeated_observations`` (cf. `tests/test_active_features.py:57`):
    the proposals take the host path, and with a discount of 0.5 on the
    winner's value some points are measured again; the logger merges the
    duplicates by their precisions, so their SD falls below the single
    observation's 1, and the gate holds. With the option off nothing
    repeats (`test_torch_e2e_search.py::test_noisy_prospective_sn2`)."""
    fun, box, lnz, mean_true = _noisy_halfnormal(2, 1.0)
    res = _run(fun, evals=20, seed=2, K=20, specify_target_noise=True,
               max_repeated_observations=3, repeated_acq_discount=0.5, **box)
    assert res.func_count == 20
    lg = res.logger
    nevals = lg.nevals[:lg.Xn]
    assert int(nevals.sum()) == 20
    assert np.any(nevals > 1)
    assert lg.neff > lg.n_train
    assert np.all(lg.S[:lg.Xn][nevals > 1] < 1.0)
    _gate(res, lnz, mean_true)
