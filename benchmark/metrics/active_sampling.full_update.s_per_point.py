"""Seconds inside the program's span `active_sampling.full_update` (the per-point full update of a noisy target: the GP retrained from warm chains and the variational posterior refitted after each point but an iteration's last) over the window, per acquired point; nothing where the span never ran."""


def read(run):
    t = run["timers"].get("active_sampling.full_update")
    return None if t is None else t / run["points"]
