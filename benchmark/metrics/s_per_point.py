"""Seconds of algorithm time per acquired point: the window's wall seconds, less the seconds inside the target, over the points acquired in the window."""


def read(run):
    return (run["window_s"] - run["target_s"]) / run["points"]
