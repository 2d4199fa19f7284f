"""Seconds inside the program's span `active_sampling.full_update.sample.capture` (the slice sampler's randoms drawn up front and, on the card, its first replay, the capture and the instantiation of the graph that every coordinate update replays) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.full_update.sample.capture")
    return None if t is None else t / run["points"]
