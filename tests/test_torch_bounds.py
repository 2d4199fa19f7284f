"""The cases of `tests/test_bounds.py` through the port: bounds validation
and repair (cf. `misc/boundscheck_vbmc.m:76-127`) and clear errors for
unsupported configuration values, with `vbmc` on CPU tensors; and the
port's `bounds_check` against the reference's on the same inputs."""

import warnings

import numpy as np
import pytest
import torch

from vbmc_tpu.main import bounds_check as j_bounds_check
from vbmc_tpu_torch.main import bounds_check, vbmc
from vbmc_tpu_torch.options import VBMCOptions

torch.set_num_threads(1)


def test_x0_outside_hard_bounds_errors():
    # `boundscheck_vbmc.m:76-79`: x0 outside LB/UB is a hard error, not a
    # silent clip (a clipped point would NaN through the logit transform).
    with pytest.raises(ValueError, match="not inside the provided hard"):
        bounds_check(np.array([-6.0, 0.5]), lb=np.array([-5.0, 0.0]),
                     ub=np.array([5.0, 10.0]), plb=np.array([-4.0, 0.1]),
                     pub=np.array([4.0, 3.0]), D=2)


def test_x0_on_bound_nudged_inside():
    # `boundscheck_vbmc.m:98-103`: on-bound points move inside the
    # effective bounds with a warning.
    with pytest.warns(UserWarning, match="too close to the hard bounds"):
        x0, lb, ub, plb, pub = bounds_check(
            np.array([[0.0, 10.0]]), lb=np.zeros(2), ub=np.full(2, 10.0),
            plb=np.full(2, 0.5), pub=np.full(2, 3.0), D=2)
    assert np.all(x0 > lb) and np.all(x0 < ub)
    # Effective bound scale: 1e-3 of the range (absolute when the bound is 0).
    assert x0[0, 0] == pytest.approx(1e-3 * 10.0)
    assert x0[0, 1] == pytest.approx(10.0 - 1e-3 * 10.0)


def test_x0_outside_plausible_expands_plausible():
    # `boundscheck_vbmc.m:121-127`: PLB/PUB expand to cover outlying x0.
    with pytest.warns(UserWarning, match="plausible bounds"):
        x0, lb, ub, plb, pub = bounds_check(
            np.array([[4.5, 1.0]]), lb=np.full(2, -5.0), ub=np.full(2, 5.0),
            plb=np.full(2, -4.0), pub=np.full(2, 4.0), D=2)
    assert plb[0] <= -4.0 and pub[0] >= 4.5
    assert np.all(lb <= plb) and np.all(plb < pub) and np.all(pub <= ub)


def test_plausible_bounds_moved_off_hard_bounds():
    # `boundscheck_vbmc.m:115-119`: PLB/PUB too close to LB/UB move inside.
    with pytest.warns(UserWarning, match="should not be too close"):
        _, lb, ub, plb, pub = bounds_check(
            np.array([[5.0, 5.0]]), lb=np.zeros(2), ub=np.full(2, 10.0),
            plb=np.zeros(2), pub=np.full(2, 10.0), D=2)
    assert np.all(plb > lb) and np.all(pub < ub)


def test_valid_bounds_pass_through_unchanged():
    x0, lb, ub, plb, pub = bounds_check(
        np.array([[0.5, 0.5]]), lb=np.zeros(2), ub=np.full(2, 10.0),
        plb=np.full(2, 0.05), pub=np.full(2, 3.0), D=2)
    assert np.allclose(x0, 0.5)
    assert np.allclose(plb, 0.05) and np.allclose(pub, 3.0)


def test_half_bounded_rejected():
    with pytest.raises(ValueError, match="one side"):
        bounds_check(np.array([[1.0]]), lb=np.array([0.0]), ub=None,
                     plb=np.array([0.5]), pub=np.array([2.0]), D=1)


def _quad(x):
    return float(-0.5 * np.sum(np.asarray(x) ** 2))


def test_unsupported_gp_mean_fun_clear_error():
    opts = VBMCOptions(display="off", gp_mean_fun="negquadfixmumble")
    with pytest.raises(ValueError, match="gp_mean_fun.*not supported"):
        vbmc(_quad, x0=np.zeros(2), plb=np.full(2, -2.0),
             pub=np.full(2, 2.0), options=opts, device="cpu")


def test_negquadfix_mean_fun_runs():
    # The fixed-center families (ids 10/12/14, `gplite_meanfun.m:8-17`) are
    # supported as of round 4 — a tiny-budget run must complete end to end
    # (the mean-family math itself is covered by tests/test_gp_meanfix.py).
    opts = VBMCOptions(display="off", gp_mean_fun="negquadfix",
                       max_fun_evals=20, seed=0)
    res = vbmc(_quad, x0=np.zeros(2), plb=np.full(2, -2.0),
               pub=np.full(2, 2.0), options=opts, device="cpu")
    assert np.isfinite(res.elbo)


def test_unsupported_temperature_clear_error():
    # `vbmc_power.m:64-65` limit, surfaced at option validation time so a
    # temperature=3 run cannot burn its initial design before crashing.
    with pytest.raises(ValueError, match="temperature must be 1 or 2"):
        VBMCOptions(display="off", temperature=3).resolve(2)


def test_unsupported_bounded_transform_clear_error():
    opts = VBMCOptions(display="off", bounded_transform="kumaraswamy")
    with pytest.raises(ValueError, match="bounded_transform.*not supported"):
        vbmc(_quad, x0=np.zeros(2), plb=np.full(2, -2.0),
             pub=np.full(2, 2.0), options=opts, device="cpu")


def test_unknown_acquisition_clear_error():
    opts = VBMCOptions(display="off", search_acq_fcn=("acqwombat",))
    with pytest.raises(ValueError, match="not a known acquisition"):
        vbmc(_quad, x0=np.zeros(2), plb=np.full(2, -2.0),
             pub=np.full(2, 2.0), options=opts, device="cpu")


def test_complex_target_return_clear_error():
    # `funlogger_vbmc.m:119-123`: non-real returns rejected with a clear
    # message (not a bare TypeError from float()).
    def bad(x):
        return complex(-0.5 * np.sum(np.asarray(x) ** 2), 1.0)

    opts = VBMCOptions(display="off")
    with pytest.raises(ValueError, match="non-real"):
        vbmc(bad, x0=np.zeros(2), plb=np.full(2, -2.0),
             pub=np.full(2, 2.0), options=opts, device="cpu")


CASES = [
    dict(x0=np.array([[0.0, 10.0]]), lb=np.zeros(2), ub=np.full(2, 10.0),
         plb=np.full(2, 0.5), pub=np.full(2, 3.0)),
    dict(x0=np.array([[4.5, 1.0]]), lb=np.full(2, -5.0), ub=np.full(2, 5.0),
         plb=np.full(2, -4.0), pub=np.full(2, 4.0)),
    dict(x0=np.array([[5.0, 5.0]]), lb=np.zeros(2), ub=np.full(2, 10.0),
         plb=np.zeros(2), pub=np.full(2, 10.0)),
    dict(x0=np.array([[0.5, 0.5], [2.0, 0.1]]), lb=np.zeros(2),
         ub=np.full(2, 10.0), plb=np.full(2, 0.05), pub=np.full(2, 3.0)),
    dict(x0=np.array([[0.2, -1.0]]), lb=np.full(2, -np.inf),
         ub=np.full(2, np.inf), plb=np.full(2, -2.0), pub=np.full(2, 2.0)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bounds_check_matches_the_reference(case):
    """The repaired x0 and bounds, element for element, and the same
    warnings."""
    kw = CASES[case]
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = j_bounds_check(D=2, **{k: v.copy() for k, v in kw.items()})
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = bounds_check(D=2, **{k: v.copy() for k, v in kw.items()})
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ([str(m.message) for m in w_got]
            == [str(m.message) for m in w_ref])
