"""Seconds inside the program's span `active_sampling.gp_update` (the GP's refresh on each acquired point, its hyperparameters kept) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.gp_update")
    return None if t is None else t / run["points"]
