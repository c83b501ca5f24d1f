"""filter_roofline: the filter's share of the HBM roofline, in %.

The need of a fused step over the whole block with its Y update
(``harness.roofline.step_bytes``: A's entries once, w1, w2, Y read, w, Y
written) times the fused steps of every filter the solves ran (degree − 1
a filter: T1 and the start of Y are not counted), over 3.35 TB/s, over
the seconds in the harness's ``step_filter`` spans (which hold the
redistributions and every bundle). It counts A once a step whatever the
bundles, so it rises when the bundles share a launch or the Y update is
fused, and it does not vanish when a kernel is renamed."""
from portbench.harness import roofline as rf


def read(run):
    spans = [s.get("spans") for s in run.solves]
    if not spans or None in spans:
        return None
    t = sum(sp["filter"] for sp in spans)
    steps = sum(d - 1 for s in run.solves for d in s["degrees"])
    if t <= 0 or steps <= 0:
        return None
    need = steps * rf.step_bytes(run.A.nnz, run.A.shape[0],
                                 run.config["fd"]["n_search"],
                                 rf.elem_bytes(run))
    return 100.0 * need / rf.HBM_BYTES_PER_S / t
