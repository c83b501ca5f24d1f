"""spmvs_per_solve: the vector SpMVs a solve needs
(``FDResult.total_spmvs``: Lanczos, the Ritz steps and every filter step
over every column), the mean over the window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s["total_spmvs"] for s in run.solves) / len(run.solves)
