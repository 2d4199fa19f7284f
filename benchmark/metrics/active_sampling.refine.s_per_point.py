"""Seconds inside the program's span `active_sampling.refine` (the argmin of the sweep and its CMA-ES refinement) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.refine")
    return None if t is None else t / run["points"]
