"""What the window spent outside the target and the three timed phases (warping, finalize, the stopping rules), per acquired point."""


def read(run):
    t = run["timers"]
    return (run["window_s"] - t["active_sampling"] - t["gp_train"]
            - t["variational_fit"]) / run["points"]
