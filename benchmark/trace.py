"""The traced window read from the profiler's raw kineto events (the method
of `chip_profile.py`: a window makes too many events for
`key_averages()`): the device's busy time, its idle gaps labelled with
what the host was doing, the device time of each sweep span, and the
device operations that took the most time.

The host's clock is tied to the trace's by the benchmark's marks: each is
one `cudaDeviceSynchronize`, whose runtime event the trace holds (the
program never synchronises the whole device itself; the profiler may add
one at its start or stop).
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _covered(merged, lo, hi):
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def _align(syncs, marks):
    """The run of consecutive synchronisations that are the marks (the
    profiler adds its own at its start or stop), and the offset of the
    trace's clock from the host's: the alignment whose offsets agree best."""
    extra = len(syncs) - len(marks)
    if extra < 0:
        raise RuntimeError(f"trace: {len(syncs)} cudaDeviceSynchronize "
                           f"events for {len(marks)} marks")
    best = None
    for k in range(extra + 1):
        d = sorted(s - m for s, m in zip(syncs[k:k + len(marks)], marks))
        spread = d[-1] - d[0]
        if best is None or spread < best[0]:
            best = (spread, k, d[len(d) // 2])
    _, k, offset = best
    return syncs[k:k + len(marks)], offset


def read(rec):
    """Summary of the traced window of a `hooks.Recorder`."""
    from torch.autograd import DeviceType

    dev, syncs = [], []
    for ev in rec.prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s = ev.start_ns()
            dev.append((s, s + ev.duration_ns(), ev.name()))
        elif ev.name() == "cudaDeviceSynchronize":
            s = ev.start_ns()
            syncs.append(s + ev.duration_ns())
    syncs.sort()
    syncs, offset = _align(syncs, rec.marks)
    w0, w1 = syncs[0], syncs[-1]
    merged = _union((max(s, w0), min(e, w1)) for s, e, _ in dev
                    if e > w0 and s < w1)
    busy_ns = _covered(merged, w0, w1)

    by_name = defaultdict(int)
    for s, e, name in dev:
        if e > w0 and s < w1:
            by_name[name] += min(e, w1) - max(s, w0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    starts = sorted((s, e) for s, e, _ in dev)
    keys = [s for s, _ in starts]
    for sw in rec.sweeps:
        a, b = syncs[sw["marks"][0]], syncs[sw["marks"][1]]
        lo, hi = bisect.bisect_left(keys, a), bisect.bisect_right(keys, b)
        sw["device_s"] = _covered(_union(starts[lo:hi]), a, b) / 1e9

    # idle gaps, labelled by the innermost host span around their middle
    spans = [("target", int(t0 * 1e9), int(t1 * 1e9))
             for t0, t1, *_ in rec.calls]
    spans += [(sw["kind"] + " sweep", int(sw["t0"] * 1e9),
               int(sw["t1"] * 1e9)) for sw in rec.sweeps]
    spans += [(p, int(t0 * 1e9), int(t1 * 1e9)) for p, t0, t1 in rec.spans]
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps.append((g1 - g0, g0, g1))
    gaps.sort(reverse=True)
    idle = []
    for length, g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2 - offset
        inside = [(t1 - t0, name) for name, t0, t1 in spans
                  if t0 <= mid <= t1]
        idle.append([min(inside)[1] if inside else "orchestrator",
                     length / 1e9])
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                device_events=len(dev),
                device_ops=[[n[:96], ns / 1e9] for n, ns in top],
                idle_gaps=idle)
