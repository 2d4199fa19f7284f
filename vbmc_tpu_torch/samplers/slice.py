"""Bounded coordinate-wise slice sampling over a batch of chains (cf.
`vbmc_tpu/samplers/slice.py`, `gplite/private/slicesamplebnd.m`).

The reference vmaps one chain's `lax.while_loop`s over chains. Here the
chains are rows of one batch that advance by trips. A trip evaluates the
log density once, at a fixed rows x C rows, and moves every chain on in its
own loop: a chain stepping out evaluates rows/2 positions a side (the
bracket's ends after 0, 1, ... more steps), a chain shrinking ``rows``
proposals (each the one its loop makes if those before it miss), and a
chain that is done is evaluated and ignored. Each chain then takes the
steps its loop takes, in order, up to the first that ends its phase, and
keeps its own caps of 16 stepping-out and 64 shrinking steps; the samples
do not depend on ``rows``. The next coordinate update starts once every
chain is done with the last. The trip and the start of an update read and
write a fixed set of tensors in place and never wait for the device: the
coordinate is an index on the device, and every random number of the call
(each chain's slice level and bracket offset per update, and its shrinking
uniforms by its own step) is drawn up front.

CPU tensors run the trips in a plain loop with the stopping check on the
host. On CUDA tensors the start of an update and one trip are captured
once a call as a CUDA graph (`graphs.Graph`), in the span "capture" with
the drawing of the randoms. Each update replays it, reads one flag (a chain
is not done) and replays it again, in the span "tail", while the flag is
set: a trip past a chain's end changes nothing. A host sync inside the log
density makes the capture raise. Both devices evaluate every row of every
trip, so the trip the CPU tests check is the one the card records.
"""

from __future__ import annotations

import torch

from vbmc_tpu_torch.graphs import Graph
from vbmc_tpu_torch.tracing import span

_MAX_STEPOUT = 16
_MAX_SHRINK = 64
# Rows a chain a trip. On an H100 at 8 chains and N=256 a trip takes 1.13,
# 1.27 and 1.61 ms of device time at 2, 4 and 8 rows a chain (the batched
# Cholesky, whose time hardly grows with the batch), a replay and its flag
# read about 0.1 ms more, and an update 8.5, 5.9 and 5.2 ms; 8 rows would
# hold twice the graph's memory for a tenth less time (`bench_kernels
# --slice`). A replay runs one trip: every update takes two at least, and a
# trip past a chain's end costs as much as any, so at 4 rows an update took
# 6.1, 7.3 and 8.8 ms at 1, 2 and 4 trips a replay.
ROWS = 4
# A chain's phase within a coordinate update.
_OUT, _SHRINK, _DONE = 0, 1, 2


class SliceChains:
    """C chains from the rows of x0s (C, D) for ``n_updates`` coordinate
    updates (update k moves coordinate k % D) of ``logpdf`` ((B, D) -> (B,))
    inside [lb, ub], with bracket widths ``widths`` (D,), evaluating
    `ROWS` (even) rows a chain a trip. ``x`` and ``lp`` are the chains'
    states and log densities; `coordinate` runs the next update. ``counts``
    holds, per update run, the trips of the plain loop or the replays of
    the graph (`capture`)."""

    def __init__(self, gen: torch.Generator, logpdf, x0s: torch.Tensor,
                 widths, lb, ub, n_updates: int):
        C, D = x0s.shape
        dt, dev = x0s.dtype, x0s.device

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev, dtype=dt)

        def vec(v):
            return torch.as_tensor(v, dtype=dt, device=dev)

        self.logpdf = logpdf
        self.C, self.D, self.rows = C, D, ROWS
        self.widths, self.lb, self.ub = vec(widths), vec(lb), vec(ub)
        # the slice level below lp, the bracket's offset, and the shrinking
        # uniforms of update k, by the chain's own shrinking step
        self.log_v = torch.log(rand(n_updates, C))
        self.r = rand(n_updates, C)
        self.u = rand(n_updates, _MAX_SHRINK, C)
        self.x = x0s.clone()
        self.lp = logpdf(self.x).clone()
        self.xd0, self.log_u, self.left, self.right = (
            torch.zeros(C, dtype=dt, device=dev) for _ in range(4))
        self.go_l, self.go_r = (torch.zeros(C, dtype=torch.bool, device=dev)
                                for _ in range(2))
        self.n_out, self.n_shr = (torch.zeros(C, dtype=torch.long, device=dev)
                                  for _ in range(2))
        self.phase = torch.full((C,), _DONE, dtype=torch.long, device=dev)
        self.k = torch.full((1,), -1, dtype=torch.long, device=dev)
        self.busy = torch.zeros((), dtype=torch.bool, device=dev)
        self.cols = torch.arange(D, device=dev)
        self.counts = []
        self._graph = None
        self._replayed = False

    def begin(self):
        """Start update k + 1 where every chain is done with update k; a
        no-op otherwise."""
        fresh = (self.phase == _DONE).all()
        self.k.add_(fresh.long())
        d = self.k.remainder(self.D)
        xd = self.x.index_select(1, d)[:, 0]
        w = self.widths.index_select(0, d)
        r = self.r.index_select(0, self.k)[0]
        new = ((self.xd0, xd),
               (self.log_u, self.lp + self.log_v.index_select(0, self.k)[0]),
               (self.left, torch.maximum(xd - r * w,
                                         self.lb.index_select(0, d))),
               (self.right, torch.minimum(xd + (1.0 - r) * w,
                                          self.ub.index_select(0, d))))
        for state, value in new:
            state.copy_(torch.where(fresh, value, state))
        self.go_l.logical_or_(fresh)
        self.go_r.logical_or_(fresh)
        self.n_out.masked_fill_(fresh, 0)
        self.n_shr.masked_fill_(fresh, 0)
        self.phase.masked_fill_(fresh, _OUT)

    def trip(self):
        """Every chain up to rows/2 steps of its own stepping out (rows/2
        positions a side) or up to ``rows`` steps of its shrinking: one
        evaluation of the log density at rows x C rows. The positions and
        proposals past a chain's first are those its loop reaches if every
        step before them goes on (stepping out) or misses (shrinking), so
        the chain takes the same steps, one after the other, as its loop
        would; a trip only evaluates them together."""
        C, W = self.C, self.rows
        R = W // 2
        d = self.k.remainder(self.D)
        onehot = self.cols == d
        w = self.widths.index_select(0, d)
        lo, hi = self.lb.index_select(0, d), self.ub.index_select(0, d)
        stepping = self.phase == _OUT
        shrinking = self.phase == _SHRINK
        # stepping out: the ends after j = 0..R steps
        P, Q = [self.left], [self.right]
        for _ in range(R):
            P.append(torch.maximum(P[-1] - w, lo))
            Q.append(torch.minimum(Q[-1] + w, hi))
        # shrinking: proposal j, and the bracket once it misses
        uk = self.u.index_select(0, self.k)[0]
        props, lefts, rights = [], [], []
        a, b = self.left, self.right
        for j in range(W):
            u = uk.gather(0, (self.n_shr + j).clamp_max(_MAX_SHRINK - 1)[None])
            prop = a + (b - a) * u[0]
            below = prop < self.xd0
            a, b = torch.where(below, prop, a), torch.where(below, b, prop)
            props.append(prop)
            lefts.append(a)
            rights.append(b)
        vals = torch.stack([torch.where(stepping, e, p)
                            for e, p in zip(P[:R] + Q[:R], props)])
        xs = torch.where(onehot, vals.reshape(-1, 1), self.x.repeat(W, 1))
        steps = torch.arange(W, device=xs.device)[:, None]
        lp = self.logpdf(xs).reshape(W, C)
        inside = lp > self.log_u

        def first(miss, n):
            """Index of the first True of each column of ``miss`` (n of
            them), n where none is."""
            return torch.where(miss, steps[:n], n).amin(0)

        # stepping out: a side goes on while inside the slice and the box,
        # and the loop while a side goes on, for 16 steps at most
        P, Q = torch.stack(P), torch.stack(Q)
        stop_l = torch.where(self.go_l, first(
            ~(inside[:R] & (P[:R] > lo)), R), -1)
        stop_r = torch.where(self.go_r, first(
            ~(inside[R:] & (Q[:R] < hi)), R), -1)
        m = torch.minimum((_MAX_STEPOUT - self.n_out).clamp_max(R),
                          torch.maximum(stop_l, stop_r) + 1)
        go_l, go_r = stepping & (stop_l >= m), stepping & (stop_r >= m)
        left_out = P.gather(0, torch.where(stop_l < m, stop_l.clamp_min(0),
                                           m)[None])[0]
        right_out = Q.gather(0, torch.where(stop_r < m, stop_r.clamp_min(0),
                                            m)[None])[0]
        n_out = self.n_out + torch.where(stepping, m, 0)
        # shrinking: the first proposal inside the slice is taken, else the
        # bracket closes in past each; a chain whose 64 proposals all miss
        # stays put
        hit = first(inside & (steps < _MAX_SHRINK - self.n_shr), W)
        ok = shrinking & (hit < W)
        used = torch.where(hit < W, hit + 1,
                           (_MAX_SHRINK - self.n_shr).clamp_max(W))
        last = (used - 1).clamp_min(0)[None]
        at_hit = hit.clamp_max(W - 1)[None]
        prop = torch.stack(props).gather(0, at_hit)[0]
        n_shr = self.n_shr + torch.where(shrinking, used, 0)
        left = torch.where(stepping, left_out, torch.where(
            shrinking & ~ok, torch.stack(lefts).gather(0, last)[0],
            self.left))
        right = torch.where(stepping, right_out, torch.where(
            shrinking & ~ok, torch.stack(rights).gather(0, last)[0],
            self.right))
        out_end = stepping & ~((go_l | go_r) & (n_out < _MAX_STEPOUT))
        shrink_end = ok | (shrinking & (n_shr >= _MAX_SHRINK))
        self.phase.copy_(torch.where(out_end, _SHRINK, torch.where(
            shrink_end, _DONE, self.phase)))
        self.x.copy_(torch.where(onehot & ok[:, None], prop[:, None],
                                 self.x))
        self.lp.copy_(torch.where(ok, lp.gather(0, at_hit)[0], self.lp))
        self.left.copy_(left)
        self.right.copy_(right)
        self.go_l.copy_(go_l)
        self.go_r.copy_(go_r)
        self.n_out.copy_(n_out)
        self.n_shr.copy_(n_shr)

    def _replay_body(self):
        self.begin()
        self.trip()
        self.busy.copy_((self.phase != _DONE).any())

    def capture(self):
        """On the card: the start of an update and a trip, run once (the
        first update's first replay) and captured as a graph."""
        self._graph = Graph(self._replay_body, self.x.device)
        self._replayed = True

    def coordinate(self):
        """The next coordinate update of every chain."""
        if self._graph is None:
            self.begin()
            n = 0
            while bool((self.phase != _DONE).any()):
                self.trip()
                n += 1
            self.counts.append(n)
            return
        if not self._replayed:
            self._graph.replay()
        self._replayed = False
        n = 1
        if bool(self.busy):
            with span("tail"):
                busy = True
                while busy:
                    self._graph.replay()
                    n += 1
                    busy = bool(self.busy)
        self.counts.append(n)


def slice_sample_chains(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                        widths, lb, ub, n_keep: int, burn: int, thin: int,
                        n_keep_max: int):
    """Run C chains (rows of x0s (C, D)) for burn + n_keep * thin sweeps and
    keep every thin-th state after the burn-in. ``logpdf`` maps (B, D) to
    (B,). Returns (samples (C, n_keep_max, D), logps (C, n_keep_max)); slots
    beyond n_keep hold zeros and -inf."""
    C, D = x0s.shape
    buf = x0s.new_zeros((C, n_keep_max, D))
    logbuf = torch.full((C, n_keep_max), -torch.inf, dtype=x0s.dtype,
                        device=x0s.device)
    n_sweeps = burn + n_keep * thin
    if n_sweeps == 0:
        return buf, logbuf
    with span("capture"):
        ch = SliceChains(gen, logpdf, x0s, widths, lb, ub, n_sweeps * D)
        if x0s.device.type == "cuda":
            ch.capture()
    for i in range(n_sweeps):
        for _ in range(D):
            ch.coordinate()
        if i >= burn and (i - burn + 1) % thin == 0:
            # past n_keep_max kept states the last slot takes each new one
            idx = min((i - burn + 1) // thin - 1, n_keep_max - 1)
            buf[:, idx] = ch.x
            logbuf[:, idx] = ch.lp
    return buf, logbuf


def slice_sample_chain(gen: torch.Generator, logpdf, x0: torch.Tensor,
                       widths, lb, ub, n_keep, burn, thin, n_keep_max: int):
    """One chain from x0 (D,) for a log density of one point ``logpdf``
    (D,) -> (), written in torch operations and applied to the batch's
    rows by `torch.func.vmap` (the reference's `vmap`). Returns (samples
    (n_keep_max, D), logps (n_keep_max,)); slots from n_keep on hold zeros
    and -inf."""
    buf, logbuf = slice_sample_chains(gen, torch.func.vmap(logpdf),
                                      x0[None], widths, lb, ub, int(n_keep),
                                      int(burn), int(thin), n_keep_max)
    return buf[0], logbuf[0]


def slice_sample_ensemble(gen: torch.Generator, logpdf, x0s: torch.Tensor,
                          widths, lb, ub, n_keep_per_chain, burn, thin,
                          n_keep_max_per_chain: int):
    """C chains from the rows of x0s (C, D), advanced together, for a log
    density of one point as in `slice_sample_chain`. Returns (samples
    (C, n_keep_max_per_chain, D), logps (C, n_keep_max_per_chain))."""
    return slice_sample_chains(gen, torch.func.vmap(logpdf), x0s, widths,
                               lb, ub, int(n_keep_per_chain), int(burn),
                               int(thin), n_keep_max_per_chain)
