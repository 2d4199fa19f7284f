"""Seconds inside the program's span `active_sampling.full_update.sample` (the full update's hyperparameter sampler, run from the previous samples) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.full_update.sample")
    return None if t is None else t / run["points"]
