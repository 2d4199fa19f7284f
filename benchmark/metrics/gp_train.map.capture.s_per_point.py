"""Seconds inside the program's span `gp_train.map.capture` (the L-BFGS starts' first evaluation and, on the card, the first trip run for real, the capture and the instantiation of the graph that every later trip replays) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("gp_train.map.capture")
    return None if t is None else t / run["points"]
