"""solve_s: seconds a converged solve takes, the window's wall (the first
solve's start to the last solve's end, host clock) over its solves."""


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
