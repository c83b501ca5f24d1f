"""halo_bytes_per_step: the halo bytes the row shards exchange per
block-wide operator application: ``FDResult.exchange``'s ``all_to_all``
and ``ppermute`` bytes over a solve (the program's counter) over the
solve's SpMVs in units of the block (``total_spmvs / N_s``: Lanczos, the
Ritz steps, T1 and every fused step), summed over the window."""


def read(run):
    if not run.solves:
        return None
    n_s = run.config["fd"]["n_search"]
    steps = sum(s["total_spmvs"] for s in run.solves) / n_s
    halo = sum(s["halo_bytes"] for s in run.solves)
    return halo / steps if halo > 0 else None
