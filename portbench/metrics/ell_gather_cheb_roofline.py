"""ell_gather_cheb_roofline: the grouped ``ell_gather_cheb`` launch's
share of its HBM roofline, in %, over all row shards of the filter
level. Each launch's need (``roofline.ell_cheb_launch_bytes``): with the
split-phase engine it contracts the halo block, so the halo's entries
once, the halo rows it gathers, the local block's partial sums y0, w1
and w2 read, w written; otherwise the whole operator once, the halo rows,
w1 (also x's own rows) and w2 read, w written. The halo is that of the
equal-rows partition (``roofline.halo_need``). Over 3.35 TB/s, over the
kernel's device time in the profiler."""
from portbench.harness import roofline as rf


def read(run):
    if run.trace is None:
        return None
    n, t = rf.kernel_time(run, "ell_gather_cheb")
    if n == 0 or t <= 0:
        return None
    A, tr = run.A, run.traffic
    entries, rows = rf.halo_need(A, tr["n_row"])
    split = bool(tr["fd"].get("spmv_overlap"))
    n_b = run.config["fd"]["n_search"] // tr["n_col"]
    need = rf.ell_cheb_launch_bytes(entries if split else A.nnz, rows,
                                    A.shape[0], n_b, rf.elem_bytes(run),
                                    y0=split)
    return 100.0 * n * need / rf.HBM_BYTES_PER_S / t
