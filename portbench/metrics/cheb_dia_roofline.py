"""cheb_dia_roofline: the ``cheb_dia`` kernel's share of its HBM
roofline, in %: each launch's need (``roofline.dia_launch_bytes``: the
operator once, w1 and w2 read, w written, over the filter's rows at the
bundle width N_s / n_col) over 3.35 TB/s, over the kernel's device time
in the profiler. Every launch in these cells is a fused filter step of
one bundle over all rows (one shard at the filter level)."""
from portbench.harness import roofline as rf


def read(run):
    if run.trace is None:
        return None
    n, t = rf.kernel_time(run, "cheb_dia")
    if n == 0 or t <= 0:
        return None
    n_b = run.config["fd"]["n_search"] // run.traffic["n_col"]
    need = rf.dia_launch_bytes(run.A.nnz, run.A.shape[0], n_b,
                               rf.elem_bytes(run))
    return 100.0 * n * need / rf.HBM_BYTES_PER_S / t
