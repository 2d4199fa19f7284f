"""Per-point full updates of the GP and the variational posterior (the counter of the quick updater that active sampling is given) over the window, per acquired point."""


def read(run):
    return run["quick_updates"] / run["points"]
