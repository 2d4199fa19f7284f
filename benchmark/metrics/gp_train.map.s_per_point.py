"""Seconds inside the program's span `gp_train.map` (the L-BFGS MAP polish of the hyperparameters) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("gp_train.map")
    return None if t is None else t / run["points"]
