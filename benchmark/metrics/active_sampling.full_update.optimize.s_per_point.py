"""Seconds inside the program's span `active_sampling.full_update.optimize` (the full update's optimisation of the variational posterior: Adam on the stochastic ELCBO, or L-BFGS) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.full_update.optimize")
    return None if t is None else t / run["points"]
