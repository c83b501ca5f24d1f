"""fd_iters: the FD driver's outer iterations a solve
(``FDResult.iterations``), the mean over the window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iterations"] for s in run.solves) / len(run.solves)
