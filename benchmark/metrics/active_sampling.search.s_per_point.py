"""Seconds inside the program's span `active_sampling.search` (the candidate set of each acquired point) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.search")
    return None if t is None else t / run["points"]
