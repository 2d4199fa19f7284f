"""The benchmark's own instruments around the program: a wrapper of the
target (seconds inside it, the moment each point was acquired, and what it
returned), the ``output_fcn`` that opens and closes the measured window,
and spans around the calls that `vbmc_tpu_torch.main` makes into its layers
(`active_sample`, `train_gp`, `vpoptimize`) and that active sampling makes
into the two sweeps (`sweep_acquisition`, `sweep_is_acquisition`), hooked
where their callers look them up. No span lives inside the program.

The window opens at the end of the first iteration, or with
``opens="warmup_over"`` at the end of the first iteration that reports
warm-up over; what runs before it is set-up.

The hooks also keep, for the comparison after the window, the last GP that
`train_gp` returned, the window's last `vpoptimize` call and the last one
of the run (the final boost), and two sweep calls of the window: the last
one and one drawn from the seed.

With ``trace`` the window runs under `torch.profiler` (CUDA activity), and
every sweep call and both ends of the window are bracketed by
`torch.cuda.synchronize()`: the device is drained there, so the device
events between two marks are exactly those launched inside the span, and
the marks tie the host's clock to the trace's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np

PHASES = ("active_sample", "train_gp", "vpoptimize")


def snapshot(obj):
    """A copy of a dataclass of tensors (a GP, a posterior, its transform,
    an acquisition state, an importance-sampling set) taken on its device
    when the hook sees it: the comparison judges what the call produced,
    even if a buffer is written again later."""
    if obj is None or not dataclasses.is_dataclass(obj):
        return obj
    kw = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if hasattr(v, "clone"):
            kw[f.name] = v.clone()
        elif dataclasses.is_dataclass(v):
            kw[f.name] = snapshot(v)
    return dataclasses.replace(obj, **kw)
SWEEPS = {"sweep_acquisition": "prospective_acq",
          "sweep_is_acquisition": "viqr_acq"}


class Recorder:
    def __init__(self, seconds: float, trace: bool, seed: int, t0=0.0,
                 opens="first_iteration"):
        if opens not in ("first_iteration", "warmup_over"):
            raise ValueError(f"unknown window_opens {opens!r}")
        self.t0 = t0
        self.opens = opens
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self._rng = np.random.default_rng([seed, 2])
        self.calls = []        # (t0, t1, x, value, sd) per target call
        self.spans = []        # (phase, t0, t1)
        self.iters = []        # one record per output_fcn call
        self.quick = []        # (t1, per-point full updates) per active_sample
        self.sweeps = []       # one record per sweep call in the window
        self.marks = []        # host ns after each synchronize of a mark
        self.window = [None, None]
        self.train = None      # the last train_gp call
        self.vpopt_window = None
        self.vpopt_last = None
        self.kept = {}         # sweep calls kept for the comparison
        self._n_kept_pool = 0
        self.prof = None
        self._torch = None

    # ------------------------------------------------------------ window
    def in_window(self) -> bool:
        return self.window[0] is not None and self.window[1] is None

    def _mark(self):
        self._torch.cuda.synchronize()
        self.marks.append(time.monotonic_ns())
        return len(self.marks) - 1

    def output_fcn(self, info) -> bool:
        now = time.monotonic()
        self.iters.append(dict(t=now, iteration=int(info["iteration"]),
                               func_count=int(info["func_count"]),
                               n_calls=len(self.calls),
                               timer=dict(info.get("timer") or {}),
                               warmup=bool(info["warmup"])))
        print(f"# iteration {info['iteration']} at {now - self.t0:.3f} s: "
              f"{info['func_count']} evaluations, warm-up "
              f"{bool(info['warmup'])}, rindex {info.get('rindex')}, full "
              f"updates {sum(n for _, n in self.quick)}, timer "
              f"{info.get('timer')}", file=sys.stderr, flush=True)
        if self.window[0] is None:
            if self.opens == "warmup_over" and info["warmup"]:
                return False
            if self.trace:
                self._start_profiler()
            self.window[0] = time.monotonic()
            return False
        if now - self.window[0] >= self.seconds:
            self.window[1] = now
            if self.trace:
                self._stop_profiler()
            return True
        return False

    def close(self):
        """After `vbmc` returned: a run that ended by itself closes the
        window at its last iteration."""
        if self.window[0] is not None and self.window[1] is None:
            if self.trace:
                self._stop_profiler()
            self.window[1] = self.iters[-1]["t"]

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def _stop_profiler(self):
        if self.prof is not None and not getattr(self, "_stopped", False):
            self._mark()
            self.prof.stop()
            self._stopped = True

    # ------------------------------------------------------------- target
    def wrap_target(self, fun):
        def target(x):
            t0 = time.monotonic()
            out = fun(x)
            t1 = time.monotonic()
            if isinstance(out, tuple):
                self.calls.append((t0, t1, np.array(x, float), float(out[0]),
                                   float(out[1])))
            else:
                self.calls.append((t0, t1, np.array(x, float), float(out),
                                   None))
            return out
        return target

    # -------------------------------------------------------------- hooks
    @contextlib.contextmanager
    def installed(self):
        import torch
        import vbmc_tpu_torch.active_sample as vas
        import vbmc_tpu_torch.main as vmain

        self._torch = torch
        saved = [(vmain, n, getattr(vmain, n)) for n in PHASES]
        saved += [(vas, n, getattr(vas, n)) for n in SWEEPS]
        try:
            for mod, name, fn in saved:
                wrap = (self._sweep(SWEEPS[name], fn) if name in SWEEPS
                        else getattr(self, "_" + name)(fn))
                setattr(mod, name, wrap)
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
            if self.prof is not None:
                self._stop_profiler()

    def _span(self, phase, fn, args, kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        self.spans.append((phase, t0, time.monotonic()))
        return out

    def _active_sample(self, fn):
        def active_sample(*args, **kw):
            out = self._span("active_sample", fn, args, kw)
            qu = kw.get("quick_updater")
            self.quick.append((time.monotonic(),
                               0 if qu is None else int(qu.updates)))
            return out
        return active_sample

    def _train_gp(self, fn):
        def train_gp(*args, **kw):
            n_calls = len(self.calls)
            out = self._span("train_gp", fn, args, kw)
            self.train = dict(gp=snapshot(out[0]), n_calls=n_calls,
                              cfg=args[1])
            return out
        return train_gp

    def _vpoptimize(self, fn):
        def vpoptimize(*args, **kw):
            gp = kw["gp"] if "gp" in kw else args[3]
            cfg = kw["cfg"] if "cfg" in kw else args[1]
            out = self._span("vpoptimize", fn, args, kw)
            rec = dict(gp=snapshot(gp), cfg=cfg,
                       res=out._replace(vp=snapshot(out.vp)))
            if self.in_window():
                self.vpopt_window = rec
            self.vpopt_last = rec
            return out
        return vpoptimize

    def _sweep(self, kind, fn):
        def sweep(*args, **kw):
            if not self.in_window():
                return fn(*args, **kw)
            m0 = self._mark() if self.trace else None
            t0 = time.monotonic()
            out = fn(*args, **kw)
            m1 = self._mark() if self.trace else None
            t1 = time.monotonic()
            rec = dict(kind=kind, t0=t0, t1=t1, marks=(m0, m1))
            if self.trace:
                from benchmark.work import sweep_work
                rec["work"] = sweep_work(kind, args)
            self.sweeps.append(rec)
            self._keep(kind, args, out)
            return out
        return sweep

    def _keep(self, kind, args, out):
        """The last sweep call, and one of the window's calls drawn
        uniformly from the seed (reservoir sampling)."""
        call = dict(kind=kind, out=out.clone(),
                    args=tuple(a.clone() if hasattr(a, "clone")
                               else snapshot(a) for a in args))
        self.kept["last"] = call
        self._n_kept_pool += 1
        if self._rng.random() * self._n_kept_pool < 1.0:
            self.kept["drawn"] = call
