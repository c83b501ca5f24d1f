"""Eigensolver launcher: FD on a ScaMaC-style matrix on one device, over
an ``--n-row × --n-col`` grid of shards, the filter in the layout
``--layout`` names (the port's counterpart of ``repro.launch.solve``).

  PYTHONPATH=src python -m repro_torch.launch.solve --family Hubbard \\
      --params n_sites=12,n_fermions=6,U=25,ranpot=1 --n-target 16 \\
      --n-search 512 --target -20 --layout stack --spmv-kernel
  PYTHONPATH=src python -m repro_torch.launch.solve --family RoadNet \\
      --params n=4000,w=2,m=256,k=4 --n-target 4 --n-search 16 \\
      --target 12.94 --tol 1e-8 --n-row 4 --n-col 2 --layout panel \\
      --spmv-balance commvol --device cpu

``--n-row P`` runs the horizontal layer: P row shards of the search block
on the one device, their halo exchange and TSQR's butterfly as device
copies between the shards (``core/shards.py``), through the engine that
``--spmv-overlap``, ``--spmv-comm`` and ``--spmv-schedule`` name.
``--n-col`` adds the vertical layer: orthogonalization and the Ritz step
run over all ``n_row·n_col`` row shards, and the filter in the
``--layout`` on the grid (``stack``: ``P × 1``; ``panel``: ``n_row ×
n_col``; ``pillar``: ``1 × P``), the block redistributed there and back
every filter pass (``--redist-impl``). ``--spmv-balance commvol`` and
``--spmv-reorder rcm`` plan the row map (``--plan-mode exact``).
``--layout auto`` and ``--plan-mode sampled`` are not ported yet.

Every family of ``repro_torch.matrices`` is taken: Hubbard, SpinChainXXZ,
Exciton and TopIns (complex; the fused step runs the DIA kernel where the
filter's operator needs no halo), RoadNet and HubNet (no DIA form; the
ELL kernel and the epilogue).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. Prints the converged count, iterations, SpMVs, the layout, the
redistributions and the bytes the shards' collectives moved at each
level, the eigenvalues and the launches of each CUDA kernel.
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
    ap.add_argument("--n-col", type=int, default=1,
                    help="vertical-layer width N_col: the grid is "
                         "n_row x n_col shards; --layout places the filter "
                         "on it")
    ap.add_argument("--layout", default="stack",
                    choices=["stack", "panel", "pillar", "auto"],
                    help="filter-phase vector layout on the grid: stack "
                         "(P x 1), panel (n_row x n_col) or pillar (1 x P); "
                         "'auto' (the planner) is not ported yet")
    ap.add_argument("--redist-impl", default="explicit",
                    choices=["explicit", "gspmd"],
                    help="stack<->panel redistribution: tile by tile as "
                         "the collective sends them, or one strided copy")
    ap.add_argument("--spmv-balance", default="rows",
                    choices=["rows", "commvol"],
                    help="row partition: equal rows, or cuts planned to cut "
                         "the halo volume")
    ap.add_argument("--spmv-reorder", default="none", choices=["none", "rcm"],
                    help="row order: as given, or reverse Cuthill-McKee")
    ap.add_argument("--plan-mode", default="exact",
                    choices=["exact", "auto", "sampled"],
                    help="how a row map is planned: 'exact' (the full "
                         "pattern), 'auto' (exact below the planner's "
                         "gate); 'sampled' is not ported yet")
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
                    spmv_schedule=args.spmv_schedule,
                    spmv_balance=args.spmv_balance,
                    spmv_reorder=args.spmv_reorder, plan_mode=args.plan_mode,
                    redist_impl=args.redist_impl, dtype=args.dtype,
                    ortho=args.ortho)


def main(argv=None, verbose: bool = True):
    """Parse ``argv``, solve, print the summary; returns the FDResult."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.layout == "auto":
        ap.error("--layout auto (the layout planner) is not ported yet, "
                 "see ROADMAP")
    if args.plan_mode == "sampled":
        ap.error("--plan-mode sampled (the sampled partition planner) is "
                 "not ported yet, see ROADMAP")
    fd = config_from_args(args)
    mat = get_family(args.family, **parse_params(args.params))
    t0 = time.perf_counter()
    solver = FilterDiag(mat, fd, device=args.device, n_row=args.n_row,
                        n_col=args.n_col)
    res = solver.solve(verbose=verbose)
    wall = time.perf_counter() - t0
    print(f"converged {res.n_converged} eigenpairs in {res.iterations} "
          f"iterations / {res.total_spmvs} SpMVs ({wall:.3f} s on "
          f"{args.device}, {solver.layout.describe()})")
    if not solver.rowmap.identity:
        print(f"row map: {solver.rowmap.describe()}, D_pad={solver.D_pad}")
    ex = res.exchange
    if solver.N_col > 1:
        print(f"redistributions: {res.redistributions} ({fd.redist_impl}), "
              f"{res.redist_time:.3f} s, "
              f"{ex['bytes']['redistribute']} bytes off-device")
    halo = ("all_to_all", "ppermute")
    levels = [("stack", ex)] + ([("panel", ex["panel"])] if ex["panel"]
                                else [])
    for level, e in levels:
        if e["P"] > 1:
            print(f"{level} level ({e['P']} row shards, {ex['engine']} SpMV, "
                  f"L={e['L']}; device copies between the shards' rows): "
                  "bytes " + ", ".join(f"{k}={e['bytes'][k]}"
                                       for k in halo + ("psum",)))
    print("eigenvalues:", np.array2string(res.eigenvalues, precision=10))
    print("kernel launches:", ", ".join(f"{k}={v}"
                                        for k, v in build.launches.items()))
    return res


if __name__ == "__main__":
    main()
