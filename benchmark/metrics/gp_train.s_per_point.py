"""The program's GP-training timer over the window, per acquired point."""


def read(run):
    return run["timers"]["gp_train"] / run["points"]
