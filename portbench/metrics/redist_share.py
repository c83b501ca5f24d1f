"""redist_share: the vertical layer's share of the solves' wall, in %:
``FDResult.redist_time`` (the stack <-> panel redistributions, timed by
the program with the device idle at both ends) over the solves' walls."""


def read(run):
    if not run.solves:
        return None
    redist = sum(s["redist_s"] for s in run.solves)
    if redist <= 0:
        return None
    return 100.0 * redist / sum(s["wall_s"] for s in run.solves)
