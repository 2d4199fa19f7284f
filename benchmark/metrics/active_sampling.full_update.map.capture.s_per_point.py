"""Seconds inside the program's span `active_sampling.full_update.map.capture` (the full update's L-BFGS polish: its start's first evaluation and, on the card, the first trip run for real, the capture and the instantiation of the graph that every later trip replays) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.full_update.map.capture")
    return None if t is None else t / run["points"]
