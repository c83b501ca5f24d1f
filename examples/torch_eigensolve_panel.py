"""Two orthogonal layers of parallelism on one device, end to end (the
PyTorch port).

    PYTHONPATH=src python examples/torch_eigensolve_panel.py [--device cpu] \
        [--shards 8]

Runs the SAME eigenproblem three ways over 8 shards of one device —
stack (8x1), panel (4x2), pillar (1x8) — and reports, per layout:
iterations, SpMVs, redistribution count and time, and the collective
bytes the shard groups counted (which follow the χ metric exactly). The
eigenvalues agree across layouts and with dense eigh. Runs on the card
unless ``--device cpu`` is given; the shards' exchanges are device copies.
"""
import argparse

import numpy as np

from repro_torch.core import FDConfig, FilterDiag
from repro_torch.core.metrics import chi_metrics
from repro_torch.matrices import Hubbard


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--shards", type=int, default=8,
                    help="P, a power of two: stack P x 1, panel P/2 x 2, "
                         "pillar 1 x P")
    args = ap.parse_args(argv)
    P = args.shards

    mat = Hubbard(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)
    csr = mat.build_csr()
    w = np.linalg.eigvalsh(csr.to_dense())
    tau = float(w[len(w) // 3])
    print(f"matrix: {mat.describe()}, target tau={tau:+.4f}")
    for Np in (2, 4, P):
        m = chi_metrics(mat, Np)
        print(f"  chi[{Np}] = {m.chi1:.2f}  (comm-bound for chi >> b_c/b_m)")

    results = {}
    for n_row, n_col, layout, name in (
            (P, 1, "stack", "stack"),
            (P // 2, 2, "panel", f"panel {P // 2}x2"),
            (1, P, "pillar", "pillar")):
        cfg = FDConfig(n_target=3, n_search=16, target=tau, tol=1e-8,
                       max_iters=18, layout=layout, spmv_kernel=True)
        fd = FilterDiag(csr, cfg, device=args.device, n_row=n_row,
                        n_col=n_col)
        res = fd.solve()
        results[name] = res
        pct = 100 * res.redist_time / max(res.wall_time, 1e-9)
        comm = fd.ell_panel.comm_bytes_per_spmv
        print(f"[{name:9s}] conv={res.n_converged} iters={res.iterations} "
              f"spmvs={res.total_spmvs} redists={res.redistributions} "
              f"(redist {pct:.1f}% of wall) "
              f"filter-SpMV comm plan: {comm / 1024:.0f} KiB/column-group; "
              f"counted bytes {res.exchange['bytes']}")

    evs = [np.sort(r.eigenvalues[:3]) for r in results.values()]
    for e in evs[1:]:
        np.testing.assert_allclose(e[:3], evs[0][:3], atol=1e-7)
    for ev in evs[0]:
        assert np.abs(w - ev).min() < 1e-7
    print("OK — all layouts agree with each other and with dense eigh")


if __name__ == "__main__":
    main()
