"""Seconds inside the program's span `active_sampling.refine.capture` (CMA-ES's generation 0 and, on the card, the capture and instantiation of the graph that the other generations replay) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.refine.capture")
    return None if t is None else t / run["points"]
