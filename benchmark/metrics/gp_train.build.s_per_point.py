"""Seconds inside the program's span `gp_train.build` (the posterior factorisations of the trained GP) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("gp_train.build")
    return None if t is None else t / run["points"]
