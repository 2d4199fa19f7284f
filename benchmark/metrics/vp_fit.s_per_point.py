"""The program's variational-fit timer over the window, per acquired point."""


def read(run):
    return run["timers"]["variational_fit"] / run["points"]
