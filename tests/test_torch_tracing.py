"""The port's span tracer (`vbmc_tpu_torch/tracing.py`) and what `vbmc`
makes of it: each iteration's ``timer``, ``VBMCResult.timers`` and
``VBMCResult.spans``, and the benchmark's readers of the spans."""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vbmc_tpu_torch import tracing
from vbmc_tpu_torch.main import PHASES
from benchmark import run as brun

ROOT = Path(__file__).resolve().parent.parent
SPAN_READERS = ("active_sampling.search", "active_sampling.refine",
                "active_sampling.gp_update", "gp_train.map",
                "gp_train.sample", "gp_train.build",
                "active_sampling.refine.capture")


# ------------------------------------------------------------- the tracer

def test_span_without_a_tracer_is_a_no_op():
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        with tracing.span("z"):
            pass


def test_paths_nesting_and_rollup():
    tr = tracing.Tracer()
    with tr.current():
        tr.iteration = 1
        with tracing.span("a"):
            with tracing.span("b"):
                time.sleep(0.002)
            with tracing.span("c"):
                with tracing.span("b"):
                    pass
        first = tr.rollup()
        tr.iteration = 2
        with tracing.span("a"):
            pass
        second = tr.rollup()
    assert tracing.span("a") is tracing.span("b")     # no tracer current
    assert set(first) == {"a", "a.b", "a.c", "a.c.b"}
    assert set(second) == {"a"} and tr.rollup() == {}
    assert first["a"] >= first["a.b"] + first["a.c"] >= 0.002
    assert [(it, p) for it, p, _, _ in tr.log] == [
        (1, "a.b"), (1, "a.c.b"), (1, "a.c"), (1, "a"), (2, "a")]
    assert all(t0 <= t1 for _, _, t0, t1 in tr.log)
    totals = tr.totals()
    assert totals["a"] == pytest.approx(first["a"] + second["a"])


def test_a_span_closes_and_reraises_when_its_body_raises():
    tr = tracing.Tracer()
    with tr.current():
        with pytest.raises(KeyError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    raise KeyError("x")
        with tracing.span("after"):
            pass
    assert [p for _, p, _, _ in tr.log] == ["outer.inner", "outer", "after"]


def test_a_nested_tracer_keeps_its_own_log():
    """As the retry's inner `vbmc` does: the inner tracer records the
    spans of its block, and the outer one is current again afterwards."""
    outer, inner = tracing.Tracer(), tracing.Tracer()
    with outer.current():
        with tracing.span("phase"):
            with inner.current():
                with tracing.span("inner_phase"):
                    pass
            with tracing.span("child"):
                pass
    assert [p for _, p, _, _ in inner.log] == ["inner_phase"]
    assert [p for _, p, _, _ in outer.log] == ["phase.child", "phase"]


# ------------------------------------------------------- one short run

@pytest.fixture(scope="module")
def short_run():
    """A noiseless D=2 run of 25 evaluations on the CPU, with every
    iteration's ``output_fcn`` info kept: a correlated Gaussian without
    warm-up, which makes a rotoscale warp at its last iteration."""
    from vbmc_tpu_torch import VBMCOptions, vbmc

    torch.set_num_threads(1)
    mu = np.array([0.5, -0.3])
    prec = np.linalg.inv(np.array([[1.0, 0.9], [0.9, 1.0]]))

    def logp(x):
        return float(-0.5 * (x - mu) @ prec @ (x - mu))

    infos = []

    def ofn(info):
        infos.append(dict(iteration=info["iteration"],
                          timer=dict(info["timer"])))
        return False

    t0 = time.monotonic_ns()
    res = vbmc(logp, x0=np.zeros(2), plb=np.full(2, -3.0),
               pub=np.full(2, 3.0),
               options=VBMCOptions(max_fun_evals=25, seed=3, ns_search=512,
                                   min_final_components=5, warmup=False,
                                   warp_every_iters=1, warp_min_k=2,
                                   output_fcn=ofn),
               device="cpu")
    return res, infos, t0, time.monotonic_ns()


def test_every_timer_names_the_five_phases(short_run):
    res, infos, _, _ = short_run
    assert len(infos) == res.iterations >= 3
    for rec, it in zip(infos, res.stats.iterations):
        assert set(rec["timer"]) >= set(PHASES)
        assert rec["timer"] == it.timer
        assert all(v >= 0 and round(v, 4) == v
                   for v in rec["timer"].values())
    assert set(res.timers) >= set(PHASES) | {"final_boost", "total"}


def test_the_span_log_nests_and_covers_the_call(short_run):
    res, infos, t0, t1 = short_run
    assert res.spans
    assert all(t0 <= a <= b <= t1 for _, _, a, b in res.spans)
    assert {it for it, _, _, _ in res.spans} == set(
        range(1, res.iterations + 1))
    ns = {}
    for _, path, a, b in res.spans:
        ns[path] = ns.get(path, 0) + (b - a)
    children = {}
    for path, v in ns.items():
        if "." in path:
            parent = path.rsplit(".", 1)[0]
            assert parent in ns, path
            children[parent] = children.get(parent, 0) + v
    for parent, v in children.items():
        assert ns[parent] >= v, parent
    for path in SPAN_READERS:
        assert path in ns, path
    assert "active_sampling.refine.replay" in ns
    # a warp's own parts, and GP training under it keeps its names
    assert res.warps_made >= 1
    for part in ("rotoscale", "bounds", "transform", "map", "sample",
                 "build", "optimize"):
        assert "warping." + part in ns, part
    # the result's totals are the log's, by path
    for path, v in ns.items():
        assert res.timers[path] == pytest.approx(v * 1e-9, rel=1e-9)
    assert res.timers["total"] * 1e9 <= t1 - t0


def test_the_benchmark_readers_read_the_spans(short_run):
    """The seven readers, loaded as `benchmark/run.py` loads them, on a run
    dict whose timers are summed as `run.py` sums the window's."""
    res, infos, _, _ = short_run
    window = infos[1:]
    timers = {}
    for it in window:
        for k, v in it["timer"].items():
            timers[k] = timers.get(k, 0.0) + v
    run = dict(timers=timers, points=5 * len(window))
    for path in SPAN_READERS:
        mod = brun.load_module(ROOT / "benchmark" / "metrics"
                               / f"{path}.s_per_point.py")
        v = mod.read(run)
        assert v is not None and math.isfinite(v) and v > 0, path
        assert mod.read(dict(run, timers={})) is None


@pytest.mark.parametrize("sampler", ["gp_train.sample",
                                     "active_sampling.full_update.sample"])
def test_the_slice_samplers_capture_and_tail_readers(short_run, sampler):
    """The slice sampler opens "capture" inside its caller's "sample" span
    on every call (on the CPU: the randoms drawn up front) and "tail" only
    around replays on the card. Its readers: the capture's seconds a
    point; the tail's, 0.0 where the capture ran and the tail never did,
    and nothing where the capture never ran (a program without them)."""
    res, infos, _, _ = short_run
    assert "gp_train.sample.capture" in res.timers
    assert not any(p.endswith(".tail") for p in res.timers)
    capture = brun.load_module(ROOT / "benchmark" / "metrics"
                               / f"{sampler}.capture.s_per_point.py")
    tail = brun.load_module(ROOT / "benchmark" / "metrics"
                            / f"{sampler}.tail.s_per_point.py")
    timers = {f"{sampler}.capture": 0.25, f"{sampler}": 2.0}
    run = dict(timers=timers, points=5)
    assert capture.read(run) == pytest.approx(0.05)
    assert tail.read(run) == 0.0
    run["timers"][f"{sampler}.tail"] = 1.5
    assert tail.read(run) == pytest.approx(0.3)
    for mod in (capture, tail):
        assert mod.read(dict(run, timers={f"{sampler}": 2.0})) is None
