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
``--spmv-reorder rcm`` plan the row map (``--plan-mode exact`` walks the
whole pattern, ``sampled`` plans from a seeded row subsample, ``auto``
samples above the exact planner's gate).

``--spmv-sstep s`` runs every filter as the s-step filter: one depth-s
ghost exchange per s recurrence steps, ⌈degree/s⌉ a filter instead of
``degree`` (``core/spmv.py::make_sstep_cheb``; the same eigenvalues bit
for bit), e.g. the RoadNet line above with ``--n-row 8 --spmv-comm
compressed --spmv-sstep 3``.

``--layout auto`` hands the choice to the χ-driven planner
(``core/planner.py``): over every ``n_row × n_col`` split of ``P =
--n-row · --n-col`` shards it ranks the layouts, the halo engines
(``a2a``, compressed ``cyclic``/``matching``, each with and without
overlap) and the row partitions (equal rows, ``commvol``; an explicit
``--spmv-reorder rcm`` adds RCM) with the analytic model of
``--machine`` (a builtin name or a JSON written by ``python -m
repro_torch.launch.dryrun --fit-machine PATH``; default ``h100-1card``),
prints the ranking and runs the best candidate on its split and row map.
``--spmv-kernel`` stays as given; ``--spmv-sstep s`` adds the depth s to
the ranking (the ``+s{s}`` candidates, on the equal-rows partition
without overlap) beside s = 1.

Every family of ``repro_torch.matrices`` is taken: Hubbard, SpinChainXXZ,
Exciton and TopIns (complex; the fused step runs the DIA kernel where the
filter's operator needs no halo), RoadNet and HubNet (no DIA form; the
ELL kernel and the epilogue).

``--plan-cache PATH`` puts a persistent plan cache
(``service/plan_cache.py``) in front of ``--layout auto`` and of
``--serve``: a repeat pattern skips the planner and runs the cached plan.
``--serve REQUESTS.json`` solves a JSON batch of requests through the
service (``service/batcher.py``; the reference's format, ``{"requests":
[{"req_id", "family", "params", "n_target", "n_search", "target",
"tol", "max_iters", "seed"}, ...], "checkpoint_root": optional,
"service_seed": optional}``): compatible requests share one panel, each
result bit-identical to serving the request alone; the service plans
over ``--n-row · --n-col`` shards with ``--machine`` and
``--spmv-kernel``, in float64, and ``--family`` is not needed.
``--degraded-ok`` retries a failed solve with one column group fewer
(``n_search − n_search // n_col`` on ``n_row × (n_col − 1)``, the same
device and kernel flag) unless the failure is a kernel's or the card's.

``--backend gloo|nccl`` runs the solve with one process per shard, under
``torch.distributed.run`` (``--nproc-per-node`` equal to ``--n-row ·
--n-col``)::

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.solve --family RoadNet \\
      --params n=4000,w=2,m=256,k=4 --n-target 4 --n-search 16 \\
      --target 12.94 --tol 1e-8 --n-row 4 --spmv-comm compressed \\
      --spmv-overlap --spmv-kernel --device cpu --backend gloo

Each rank holds its shard's rows and its bundle (``core/ranks.py``),
launches the kernels on them and talks to the others through
``torch.distributed``; rank 0 alone prints, what the one-process CLI
prints and the world size, the backend and the bytes staged through the
host. On a node with fewer cards than ranks ``--share-card`` puts several
ranks on one card, which only gloo allows (NCCL refuses two ranks on one
device); gloo stages every CUDA buffer through pinned host memory. The
process group starts from the environment that ``torch.distributed.run``
sets. Every option runs on ranks:

* ``--spmv-sstep s``: each rank filters its shard's rows, one depth-s
  exchange of ``torch.distributed`` calls per s steps;
* ``--layout auto`` (and ``--plan-cache``): rank 0 alone plans over the
  world's ranks and reads and writes the cache, and its plan goes to
  every rank in one broadcast; the world must hold ``--n-row · --n-col``
  ranks, and each runs its shard of the planned split;
* ``--serve``: every rank reads the requests, rank 0 plans, each group
  runs on the ranks of its planned split, checkpoints (``checkpoint_root``)
  are written by rank 0 behind a barrier, rank 0 prints;
* ``--degraded-ok``: when every rank raises the same failure from the
  solve, the retry runs on the ``n_row × (n_col − 1)`` sub-grid of ranks
  ``i·n_col + k``, ``k < n_col − 1``; the last column's ranks wait at a
  barrier of the world and return without printing.

A failure that one rank alone raises is not recovered: the other ranks
are blocked in a collective, and the launch ends there (elastic
restarts are not part of the port). A world size other than the grid's
is refused, and so is ``nccl`` with ``--share-card``.

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. Prints the converged count, iterations, SpMVs, the layout, the
redistributions and the bytes the shards' collectives moved at each
level, the filter's halo exchanges, the eigenvalues and the launches of
each CUDA kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..core import FDConfig, FilterDiag
from ..core import perf_model as pm
from ..core.planner import auto_axes, config_for
from ..core.ranks import is_lead
from ..kernels import build
from ..matrices import available_families, get_family
from ..service import EigenService, PlanCache, SolveRequest
from ..service.plan_cache import cached_plan_layout


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
    ap.add_argument("--family", choices=available_families(),
                    help="the matrix family (required unless --serve)")
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
                         "'auto': the chi-driven planner picks the split of "
                         "P = n_row*n_col, the layout, the halo engine and "
                         "the row partition (overrides --n-row/--n-col, "
                         "--spmv-overlap/-comm/-schedule/-balance)")
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
    ap.add_argument("--plan-mode", default="auto",
                    choices=["exact", "sampled", "auto"],
                    help="pattern passes of the planning (row maps, chi "
                         "counts, comm plans): 'exact' (the full pattern), "
                         "'sampled' (a seeded row subsample: "
                         "Horvitz-Thompson chi/L estimates and a coarsened "
                         "commvol descent) or 'auto' (exact below the "
                         "planner's gate, sampled above it)")
    ap.add_argument("--machine", default=pm.H100_1CARD.name,
                    help="machine model for --layout auto: a builtin "
                         f"({', '.join(sorted(pm.BUILTIN_MACHINES))}) or a "
                         "JSON path written by `python -m "
                         "repro_torch.launch.dryrun --fit-machine PATH`")
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
    ap.add_argument("--spmv-sstep", type=int, default=1,
                    help="s-step filter: one depth-s ghost exchange per s "
                         "Chebyshev steps, ceil(degree/s) exchanges a "
                         "filter (1: one exchange per step); with --layout "
                         "auto the planner ranks depths 1 and s")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"],
                    help="working precision; a complex family (Exciton, "
                         "TopIns) solves in complex128 / complex64")
    ap.add_argument("--ortho", default="tsqr", choices=["tsqr", "svqb"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs; 'cuda' with no card raises")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="persistent plan cache in front of --layout auto "
                         "and --serve: a JSON store of planner results "
                         "keyed by (pattern hash, P, machine fingerprint, "
                         "the planner's arguments); a repeat pattern skips "
                         "the planner")
    ap.add_argument("--serve", default=None, metavar="REQUESTS.json",
                    help="service mode: solve a JSON batch of requests "
                         "({requests: [...], checkpoint_root, "
                         "service_seed}); compatible requests share one "
                         "panel as extra columns, each result bit-identical "
                         "to serving it alone; planned over --n-row x "
                         "--n-col shards (--family is not needed)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="one process per shard: start this rank of a "
                         "torch.distributed.run launch of n_row*n_col ranks "
                         "with this process-group backend (no default: "
                         "without it the solve runs in one process)")
    ap.add_argument("--share-card", action="store_true",
                    help="with --backend gloo: let several ranks share one "
                         "card (a node with fewer cards than ranks)")
    ap.add_argument("--degraded-ok", action="store_true",
                    help="on a failed solve, retry with one column group "
                         "fewer (n_search - n_search // n_col on n_row x "
                         "(n_col - 1)); a kernel's or the card's error is "
                         "raised, never retried")
    return ap


def config_from_args(args) -> FDConfig:
    return FDConfig(n_target=args.n_target, n_search=args.n_search,
                    target=args.target, tol=args.tol, max_iters=args.max_iters,
                    layout=args.layout, spmv_kernel=args.spmv_kernel,
                    spmv_overlap=args.spmv_overlap, spmv_comm=args.spmv_comm,
                    spmv_schedule=args.spmv_schedule,
                    spmv_balance=args.spmv_balance,
                    spmv_reorder=args.spmv_reorder,
                    spmv_sstep=args.spmv_sstep, plan_mode=args.plan_mode,
                    redist_impl=args.redist_impl, dtype=args.dtype,
                    ortho=args.ortho)


def plan_auto(mat, fd: FDConfig, P: int, machine, plan_cache=None,
              ranks: bool = False, device=None):
    """``--layout auto``: rank every split of ``P`` shards
    (``plan_layout`` on the axes of ``planner.auto_axes``, as the
    reference CLI plans over its devices, ``repro/launch/solve.py:70-112``;
    behind the plan cache at ``plan_cache`` when given) and return
    ``(fd', n_row, n_col, rowmap)`` for the best candidate. On ranks
    rank 0 alone plans, touches the cache and prints; every rank gets
    its plan."""
    lead = is_lead()
    cache = PlanCache(plan_cache) if plan_cache and lead else None
    t0 = time.perf_counter()
    plan, hit = cached_plan_layout(mat, P, cache=cache, machine=machine,
                                   ranks=ranks, device=device,
                                   **auto_axes(fd, mat.D, P))
    seconds = time.perf_counter() - t0
    best = plan.best
    if not lead:
        return config_for(fd, best), best.n_row, best.n_col, best.rowmap
    if cache is not None:
        print(f"[plan-cache] {'hit' if hit else 'miss'} ({plan_cache}): "
              f"hits={cache.hits} misses={cache.misses} "
              f"plan_calls={cache.plan_calls}")
    print(plan.report())
    print(f"[auto] planned in {seconds:.3f} s on the host; running "
          f"{best.describe()} (spmv_overlap={best.overlap}, "
          f"spmv_comm={best.comm}, spmv_schedule={best.schedule}, "
          f"spmv_balance={best.balance}, spmv_reorder={best.reorder}, "
          f"spmv_kernel={best.kernel}, spmv_sstep={best.sstep})")
    return config_for(fd, best), best.n_row, best.n_col, best.rowmap


def device_fault(e: BaseException) -> bool:
    """Whether ``e`` is a kernel's build or launch error or the card's: it
    passed through the kernels package (``repro_torch/kernels``: the
    build, a wrapper's refusal, a launch's error code, a plain version),
    or CUDA raised it; its cause and context are searched too."""
    kernels_dir = os.path.dirname(os.path.abspath(build.__file__))
    cuda_errors = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError",
                                            None),
                                    getattr(torch, "AcceleratorError", None))
                        if t is not None)
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, cuda_errors) or "CUDA" in str(e):
            return True
        tb = e.__traceback__
        while tb is not None:
            path = os.path.abspath(tb.tb_frame.f_code.co_filename)
            if os.path.dirname(path) == kernels_dir:
                return True
            tb = tb.tb_next
        e = e.__cause__ or e.__context__
    return False


def degraded_members(n_row: int, n_col: int) -> tuple:
    """The ranks of the degraded sub-grid of an ``n_row × n_col`` launch:
    ``b = i·n_col + k`` with ``k < n_col − 1``, in the order of their new
    shards ``i·(n_col − 1) + k``."""
    return tuple(i * n_col + k for i in range(n_row) for k in range(n_col - 1))


def solve(mat, fd: FDConfig, device, n_row: int, n_col: int, rowmap,
          verbose: bool, degraded_ok: bool = False, ranks: bool = False):
    """Solve on an ``n_row × n_col`` grid; returns ``(solver, result)``.
    With ``degraded_ok`` (the reference's ``repro/launch/solve.py:
    120-135``) a failure that is not a kernel's or the card's
    (:func:`device_fault`) is printed and the solve retried with one
    column group fewer, ``n_search − n_search // n_col`` vectors on
    ``n_row × (n_col − 1)`` shards of the same device with the same
    kernel flag, the row map planned anew (the shard count changed).

    On ranks the retry needs every rank to have raised the failure (one
    rank's alone ends the launch: the others are blocked in a
    collective); it runs on the ranks of :func:`degraded_members`, and a
    rank of the last column waits at a barrier of the world with them
    and returns ``(None, None)``."""
    try:
        solver = FilterDiag(mat, fd, device=device, n_row=n_row,
                            n_col=n_col, rowmap=rowmap, ranks=ranks)
        return solver, solver.solve(verbose=verbose)
    except Exception as e:  # noqa: BLE001 — degraded mode retries any fault
        if not degraded_ok or n_col == 1 or device_fault(e):
            raise
        fd2 = dataclasses.replace(fd, n_search=fd.n_search
                                  - fd.n_search // n_col)
        if is_lead():
            print(f"[degraded] the solve on {n_row}x{n_col} failed "
                  f"({type(e).__name__}: {e}); retrying with n_search="
                  f"{fd2.n_search} on {n_row}x{n_col - 1}")
        if ranks:
            return _degraded_on_ranks(mat, fd2, device, n_row, n_col,
                                      verbose)
        solver = FilterDiag(mat, fd2, device=device, n_row=n_row,
                            n_col=n_col - 1)
        return solver, solver.solve(verbose=verbose)


def _degraded_on_ranks(mat, fd: FDConfig, device, n_row: int, n_col: int,
                       verbose: bool):
    """The degraded retry on ranks (:func:`solve`): every rank reaches it
    from the same failure, the sub-grid's groups are made by every rank
    of the world, and the world meets at one barrier after the retry."""
    import torch.distributed as dist

    from ..core.ranks import grid_links

    members = degraded_members(n_row, n_col)
    # every rank of the world takes part in making the sub-grid's groups
    grid_links(n_row, n_col - 1, device, members)
    solver = res = None
    if dist.get_rank() in members:
        solver = FilterDiag(mat, fd, device=device, n_row=n_row,
                            n_col=n_col - 1, ranks=True, members=members)
        res = solver.solve(verbose=verbose)
    dist.barrier()
    return solver, res


def serve(args, machine, verbose: bool = True, ranks: bool = False,
          device=None) -> dict:
    """``--serve``: solve the requests of ``args.serve`` through the
    service over ``--n-row · --n-col`` shards on ``--device``; prints the
    plan cache's counts and each request's result and returns
    ``{req_id: FDResult}``. On ranks (``device`` this rank's) every rank
    reads the requests and gets every result; rank 0 plans, touches the
    cache and prints."""
    with open(args.serve) as f:
        spec = json.load(f)
    lead = is_lead()
    cache = PlanCache(args.plan_cache) if args.plan_cache and lead else None
    svc = EigenService(n_shards=args.n_row * args.n_col,
                       device=device if ranks else args.device,
                       spmv_kernel=args.spmv_kernel,
                       plan_cache=cache, machine=machine,
                       ckpt_root=spec.get("checkpoint_root"),
                       service_seed=int(spec.get("service_seed", 0)),
                       verbose=verbose and lead, ranks=ranks)
    for r in spec["requests"]:
        svc.submit(SolveRequest(
            req_id=str(r["req_id"]), family=r["family"],
            params=dict(r.get("params", {})),
            n_target=int(r.get("n_target", 4)),
            n_search=int(r.get("n_search", 16)),
            target=float(r.get("target", 0.0)),
            tol=float(r.get("tol", 1e-9)),
            max_iters=int(r.get("max_iters", 40)),
            seed=int(r.get("seed", 7))))
    t0 = time.perf_counter()
    results = svc.drain()
    wall = time.perf_counter() - t0
    if not lead:
        return results
    if cache is not None:
        print(f"[plan-cache] hits={cache.hits} misses={cache.misses} "
              f"plan_calls={cache.plan_calls}")
    for g in svc.groups:
        print(f"[serve] group {g['requests']} on {g['cell']}: block width "
              f"{g['width']}, bundle width {g['bundle_width']}, restarts "
              f"{g['restarts']}, {g['wall_s']:.3f} s")
    for rid in sorted(results):
        r = results[rid]
        print(f"[{rid}] converged {r.n_converged} in {r.iterations} "
              f"iterations / {r.total_spmvs} SpMVs; eigenvalues "
              f"{np.array2string(r.eigenvalues, precision=10)}")
    where = (f"{args.n_row * args.n_col} ranks" if ranks
             else args.device)
    print(f"served {len(results)} requests in {wall:.3f} s on {where}")
    print("kernel launches" + (" (rank 0)" if ranks else "") + ":",
          ", ".join(f"{k}={v}" for k, v in build.launches.items()))
    return results


def _refuse_on_ranks(ap, args) -> None:
    """The flag combinations a rank launch refuses before any process
    group starts."""
    if args.backend is None:
        if args.share_card:
            ap.error("--share-card needs --backend gloo (a rank launch)")
        return
    if args.backend == "nccl" and args.share_card:
        ap.error("--share-card needs --backend gloo: NCCL refuses two ranks "
                 "on one device")


def main(argv=None, verbose: bool = True):
    """Parse ``argv``, solve, print the summary; returns the FDResult
    (``--serve``: ``{req_id: FDResult}``). With ``--backend`` this
    process is one rank of a launch; rank 0 alone prints."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_on_ranks(ap, args)
    if args.backend is not None:
        return _main_on_ranks(ap, args, verbose)
    machine = _machine(ap, args)
    if args.serve:
        return serve(args, machine, verbose=verbose)
    if not args.family:
        ap.error("--family is required (unless --serve is given)")
    fd = config_from_args(args)
    mat = get_family(args.family, **parse_params(args.params))
    n_row, n_col, rowmap = args.n_row, args.n_col, None
    if args.layout == "auto":
        fd, n_row, n_col, rowmap = plan_auto(mat, fd, n_row * n_col,
                                             machine, args.plan_cache)
    t0 = time.perf_counter()
    solver, res = solve(mat, fd, args.device, n_row, n_col, rowmap, verbose,
                        degraded_ok=args.degraded_ok)
    wall = time.perf_counter() - t0
    report(args, fd, solver, res, wall)
    return res


def _main_on_ranks(ap, args, verbose: bool):
    """One rank of a ``--backend`` launch: start the process group, solve
    (or serve) on this rank's shards, and on rank 0 print the summary. A
    rank of the last column after a degraded retry prints nothing and
    returns None."""
    import torch.distributed as dist

    from ..core.ranks import init_ranks

    device = init_ranks(args.backend, args.device, share_card=args.share_card)
    try:
        lead = dist.get_rank() == 0
        machine = _machine(ap, args)
        if args.serve:
            return serve(args, machine, verbose=verbose, ranks=True,
                         device=device)
        if not args.family:
            ap.error("--family is required (unless --serve is given)")
        fd = config_from_args(args)
        mat = get_family(args.family, **parse_params(args.params))
        n_row, n_col, rowmap = args.n_row, args.n_col, None
        if args.layout == "auto":
            fd, n_row, n_col, rowmap = plan_auto(
                mat, fd, n_row * n_col, machine, args.plan_cache, ranks=True,
                device=device)
        t0 = time.perf_counter()
        solver, res = solve(mat, fd, device, n_row, n_col, rowmap,
                            verbose and lead, degraded_ok=args.degraded_ok,
                            ranks=True)
        wall = time.perf_counter() - t0
        if lead:
            report(args, solver.cfg, solver, res, wall)
        return res
    finally:
        dist.destroy_process_group()


def _machine(ap, args):
    """The machine model ``--layout auto`` and ``--serve`` plan with
    (None when neither is given)."""
    if not (args.layout == "auto" or args.serve):
        return None
    try:
        return pm.resolve_machine(args.machine)
    except ValueError as e:
        ap.error(str(e))


def report(args, fd: FDConfig, solver, res, wall: float) -> None:
    """Print a solve's summary (the one process's, or rank 0's)."""
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
    how = ("torch.distributed between the ranks, summed over them"
           if solver.ranks else "device copies between the shards' rows")
    for level, e in levels:
        if e["P"] > 1:
            print(f"{level} level ({e['P']} row shards, {ex['engine']} SpMV, "
                  f"L={e['L']}; {how}): "
                  "bytes " + ", ".join(f"{k}={e['bytes'][k]}"
                                       for k in halo + ("psum",)))
    if solver.N_row > 1:
        print(f"filter: {ex['filter_engine']} over {solver.N_row} row shards, "
              f"{ex['filter_exchanges']} halo exchanges in {res.iterations} "
              f"filters x {solver.N_col} bundles (depth {ex['sstep']}: "
              f"ceil(degree/{ex['sstep']}) a filter)")
    if "ranks" in ex:
        r = ex["ranks"]
        print(f"ranks: {r['world']} ({r['backend']}, one process a shard, "
              f"on {solver.device} here), {r['staged']} bytes staged "
              "through the host")
    print("eigenvalues:", np.array2string(res.eigenvalues, precision=10))
    print("kernel launches" + (" (rank 0)" if solver.ranks else "") + ":",
          ", ".join(f"{k}={v}" for k, v in build.launches.items()))


if __name__ == "__main__":
    main()
