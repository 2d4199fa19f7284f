"""The program's active-sampling timer over the window, less the seconds inside the target (called there alone), per acquired point."""


def read(run):
    return (run["timers"]["active_sampling"] - run["target_s"]) / run["points"]
