"""Seconds from the start of the process to the start of the window: imports, loading (or building) the kernels, the target and its starting points, and the first iteration."""


def read(run):
    return run["setup_s"]
