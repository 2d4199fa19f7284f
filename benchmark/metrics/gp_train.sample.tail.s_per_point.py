"""Seconds inside the program's span `gp_train.sample.tail` (the slice sampler's replays past the first of a coordinate update, where a chain was not done after it) over the window, per acquired point: 0.0 where the sampler's span `gp_train.sample.capture` ran and this one never did, nothing where that one never ran."""


def read(run):
    if "gp_train.sample.capture" not in run["timers"]:
        return None
    return run["timers"].get("gp_train.sample.tail", 0.0) / run["points"]
