"""Eigensolver launcher: FD on a ScaMaC-style matrix on one device, in
the stack layout over ``--n-row`` row shards (the port's counterpart of
``repro.launch.solve``).

  PYTHONPATH=src python -m repro_torch.launch.solve --family Hubbard \\
      --params n_sites=12,n_fermions=6,U=25,ranpot=1 --n-target 16 \\
      --n-search 512 --target -20 --layout stack --spmv-kernel
  PYTHONPATH=src python -m repro_torch.launch.solve --family RoadNet \\
      --params n=4000,w=2,m=256,k=4 --n-target 4 --n-search 16 \\
      --target 12.94 --tol 1e-8 --n-row 4 --spmv-overlap --device cpu

``--n-row P`` runs the horizontal layer: P row shards of the search block
on the one device, their halo exchange and TSQR's butterfly as device
copies between the shards (``core/shards.py``), through the engine that
``--spmv-overlap``, ``--spmv-comm`` and ``--spmv-schedule`` name.

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
    ap.add_argument("--n-row", type=int, default=1,
                    help="horizontal-layer width N_row: D sliced over N_row "
                         "row shards on the one device; the SpMV's halo "
                         "exchange runs between them (a power of two with "
                         "--ortho tsqr)")
    ap.add_argument("--n-col", type=int, default=1, choices=[1],
                    help="vertical-layer width N_col (only 1: the vertical "
                         "layer is not ported yet)")
    ap.add_argument("--layout", default="stack", choices=["stack"],
                    help="filter-phase vector layout; the stack layout "
                         "(panel and pillar come with the vertical layer)")
    ap.add_argument("--spmv-overlap", action="store_true",
                    help="split-phase SpMV engine: the halo exchange runs "
                         "on a side stream while the local block "
                         "contracts, then the halo block")
    ap.add_argument("--spmv-comm", default="a2a",
                    choices=["a2a", "compressed"],
                    help="halo exchange: 'a2a' (one all_to_all padded to "
                         "the largest pair volume L) or 'compressed' "
                         "(permutation rounds padded per round, empty "
                         "pairs skipped; with --spmv-overlap the halo "
                         "block contracts once every round has landed)")
    ap.add_argument("--spmv-schedule", default="cyclic",
                    choices=["cyclic", "matching"],
                    help="rounds of the compressed exchange: one per "
                         "nonzero cyclic shift, or greedy max-weight "
                         "matchings")
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
                    spmv_overlap=args.spmv_overlap, spmv_comm=args.spmv_comm,
                    spmv_schedule=args.spmv_schedule, dtype=args.dtype,
                    ortho=args.ortho)


def main(argv=None, verbose: bool = True):
    """Parse ``argv``, solve, print the summary; returns the FDResult."""
    args = build_parser().parse_args(argv)
    fd = config_from_args(args)
    mat = get_family(args.family, **parse_params(args.params))
    t0 = time.perf_counter()
    solver = FilterDiag(mat, fd, device=args.device, n_row=args.n_row)
    res = solver.solve(verbose=verbose)
    wall = time.perf_counter() - t0
    print(f"converged {res.n_converged} eigenpairs in {res.iterations} "
          f"iterations / {res.total_spmvs} SpMVs ({wall:.3f} s on "
          f"{args.device}, {solver.layout.describe()})")
    if solver.P > 1:
        ex = res.exchange
        print(f"shard collectives ({ex['engine']} SpMV, L={ex['L']}; device "
              "copies between the shards' rows): bytes "
              + ", ".join(f"{k}={v}" for k, v in ex["bytes"].items()))
    print("eigenvalues:", np.array2string(res.eigenvalues, precision=10))
    print("kernel launches:", ", ".join(f"{k}={v}"
                                        for k, v in build.launches.items()))
    return res


if __name__ == "__main__":
    main()
