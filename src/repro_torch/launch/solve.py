"""Eigensolver launcher: FD on a ScaMaC-style matrix, one device, stack
layout (the port's counterpart of ``repro.launch.solve``).

  PYTHONPATH=src python -m repro_torch.launch.solve --family Hubbard \\
      --params n_sites=12,n_fermions=6,U=25,ranpot=1 --n-target 16 \\
      --n-search 512 --target -20 --layout stack --spmv-kernel

Every family of ``repro_torch.matrices`` is taken: Hubbard, SpinChainXXZ,
Exciton and TopIns (complex; the fused step runs the DIA kernel), RoadNet
and HubNet (no DIA form; the ELL kernel and the epilogue).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. Prints the converged count, iterations, SpMVs, eigenvalues and
the launches of each CUDA kernel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import FDConfig, FilterDiag
from ..kernels import build
from ..matrices import available_families, get_family


def parse_params(s: str) -> dict:
    out = {}
    for kv in (s or "").split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = float(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--family", required=True, choices=available_families())
    ap.add_argument("--params", default="")
    ap.add_argument("--n-target", type=int, default=8)
    ap.add_argument("--n-search", type=int, default=32)
    ap.add_argument("--target", type=float, default=0.0)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--max-iters", type=int, default=40)
    ap.add_argument("--layout", default="stack", choices=["stack"],
                    help="filter-phase vector layout; one device runs the "
                         "stack layout (the others come with the "
                         "horizontal and vertical layers)")
    ap.add_argument("--spmv-kernel", action="store_true",
                    help="run every SpMV in the CUDA ELL kernel and every "
                         "fused Chebyshev step in the CUDA DIA kernel where "
                         "the operator has a DIA form (<= 64 diagonals), "
                         "else in the ELL kernel and a torch epilogue; on "
                         "the CPU the kernels' plain versions run")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"],
                    help="working precision; a complex family (Exciton, "
                         "TopIns) solves in complex128 / complex64")
    ap.add_argument("--ortho", default="tsqr", choices=["tsqr", "svqb"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs; 'cuda' with no card raises")
    return ap


def config_from_args(args) -> FDConfig:
    return FDConfig(n_target=args.n_target, n_search=args.n_search,
                    target=args.target, tol=args.tol, max_iters=args.max_iters,
                    layout=args.layout, spmv_kernel=args.spmv_kernel,
                    dtype=args.dtype, ortho=args.ortho)


def main(argv=None, verbose: bool = True):
    """Parse ``argv``, solve, print the summary; returns the FDResult."""
    args = build_parser().parse_args(argv)
    fd = config_from_args(args)
    mat = get_family(args.family, **parse_params(args.params))
    t0 = time.perf_counter()
    res = FilterDiag(mat, fd, device=args.device).solve(verbose=verbose)
    wall = time.perf_counter() - t0
    print(f"converged {res.n_converged} eigenpairs in {res.iterations} "
          f"iterations / {res.total_spmvs} SpMVs ({wall:.3f} s on "
          f"{args.device})")
    print("eigenvalues:", np.array2string(res.eigenvalues, precision=10))
    print("kernel launches:", ", ".join(f"{k}={v}"
                                        for k, v in build.launches.items()))
    return res


if __name__ == "__main__":
    main()
