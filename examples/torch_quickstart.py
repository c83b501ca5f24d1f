"""Quickstart on the PyTorch port: filter diagonalization of a spin chain,
validated against eigh.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \
        [--n-sites 14]

Computes 4 interior eigenpairs of the XXZ chain (D = 3432 at the default
14 sites, half filled) in the stack
layout on one device, the kernels on (on the card the CUDA kernels, on the
CPU their plain versions), and checks them against dense eigh. Runs on the
card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core import FDConfig, FilterDiag
from repro_torch.matrices import SpinChainXXZ


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-sites", type=int, default=14)
    args = ap.parse_args(argv)

    mat = SpinChainXXZ(n_sites=args.n_sites, n_up=args.n_sites // 2)
    csr = mat.build_csr()
    print(f"matrix: {mat.describe()}  nnz/row={csr.n_nzr:.1f}")

    w = np.linalg.eigvalsh(csr.to_dense())
    tau = float(w[len(w) // 2])  # an *interior* target — the hard case
    print(f"target tau = {tau:+.6f} (median of {len(w)} eigenvalues)")

    cfg = FDConfig(n_target=4, n_search=16, target=tau, tol=1e-9, max_iters=30,
                   layout="stack", spmv_kernel=True)
    res = FilterDiag(csr, cfg, device=args.device).solve(verbose=True)

    print(f"\nconverged {res.n_converged} eigenpairs in {res.iterations} "
          f"iterations ({res.total_spmvs} SpMVs) on {args.device}")
    for ev, r in zip(res.eigenvalues[:4], res.residuals[:4]):
        true = w[np.argmin(np.abs(w - ev))]
        print(f"  lambda = {ev:+.12f}  (eigh {true:+.12f}, "
              f"delta {abs(ev - true):.2e}, residual {r:.2e})")
    assert all(np.abs(w - ev).min() < 1e-8 for ev in res.eigenvalues[:4])
    print("OK — matches dense eigh")


if __name__ == "__main__":
    main()
