"""analyze_share: the share of the traced solves' time, in %, spent in
the harness's ``step_analyze`` spans: orthogonalisation, the Ritz step
(the SpMV, Gram, ``eigh``, residuals) and the FD driver's host choice of the
next filter."""


def read(run):
    spans = [s.get("spans") for s in run.solves]
    if not spans or None in spans:
        return None
    total = sum(sum(sp.values()) for sp in spans)
    return 100.0 * sum(sp["analyze"] for sp in spans) / total
