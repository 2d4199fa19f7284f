"""Spans on the host's clock inside `vbmc`: where an iteration's time goes,
phase by phase and inside each phase.

`vbmc` makes a `Tracer` current for the length of the call; a nested call,
as the retry makes, gets its own, and the outer one is current again when
it returns. ``with span(name):`` around a part of the work records its path
(the names of the open spans joined by ``.``: ``gp_train.map``,
``warping.map``), the current iteration, and its start and end on
`time.monotonic_ns()`. With no tracer current (a layer called on its own)
a span does nothing beyond one `ContextVar.get`.

A span reads only the host's clock: it never synchronises the device,
copies to the host or makes a tensor. Its seconds are host seconds, so a
host synchronisation inside a span charges that span with the device work
queued before it. Spans are as fine as a phase's parts (tens an
iteration), never one per optimiser step, sampler step or kernel launch.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

_CURRENT = contextvars.ContextVar("vbmc_tpu_torch_tracer", default=None)
_NOOP = contextlib.nullcontext()


def _seconds(entries) -> dict:
    out = {}
    for _, path, t0, t1 in entries:
        out[path] = out.get(path, 0.0) + (t1 - t0) * 1e-9
    return out


class Tracer:
    """The spans of one `vbmc` call. ``log`` holds one
    ``(iteration, path, t0_ns, t1_ns)`` per closed span, in the order the
    spans closed, on `time.monotonic_ns()`; ``iteration`` is stamped on
    each span as it closes."""

    def __init__(self):
        self.log = []
        self.iteration = 0
        self._open = []        # paths of the open spans, innermost last
        self._rolled = 0       # entries of the log already rolled up

    @contextlib.contextmanager
    def current(self):
        """Make this tracer the one `span` records into, until the block
        ends; the tracer current before is restored then."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def rollup(self) -> dict:
        """Seconds by path of the spans closed since the last call."""
        new = self.log[self._rolled:]
        self._rolled = len(self.log)
        return _seconds(new)

    def totals(self) -> dict:
        """Seconds by path of every span closed so far."""
        return _seconds(self.log)


class _Span:
    __slots__ = ("tracer", "name", "path", "t0")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        self.path = f"{tr._open[-1]}.{self.name}" if tr._open else self.name
        tr._open.append(self.path)
        self.t0 = time.monotonic_ns()

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        tr = self.tracer
        tr._open.pop()
        tr.log.append((tr.iteration, self.path, self.t0, t1))
        return False


def span(name: str):
    """A context manager that records ``name`` as a span of the current
    tracer (closed, and the exception re-raised, when the body raises), or
    does nothing when no tracer is current."""
    tracer = _CURRENT.get()
    if tracer is None:
        return _NOOP
    return _Span(tracer, name)
