"""Seconds inside the program's span `active_sampling.is_set` (the importance-sampling set of VIQR, rebuilt for every point: draws from the posterior and the box, and Metropolis steps) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.is_set")
    return None if t is None else t / run["points"]
