"""One process per shard on the CPU: the port's shard groups over 4 gloo
ranks (``repro_torch.core.ranks``) against the one-process grid.

One spawn of 4 CPU ranks (one intra-op thread each, a ``file://`` store
under ``tmp_path``, so concurrent workers never race for a port) runs
every part and returns its results; each rank computes the one-process
counterpart of what it checks bitwise in its own process, with the same
thread count, and compares its rows. The parts:

(a) the collectives (``all_to_all`` fp64 and complex128, a compressed
    round whose permutation leaves a receiver out, the TSQR ``ppermute``,
    ``psum``) bit-equal, their bytes summed over the ranks and their
    calls per rank equal to the one process's;
(b) the eight halo engines' SpMV and fused step on RoadNet(4000) and
    HubNet(4000) (fp64) and Exciton(L=2) (complex128) at P = 4, each
    rank's rows bit-equal, bytes and calls as in (a);
(c) TSQR's Q and R, Gram and SVQB bit-equal;
(d) ``to_panel`` / ``to_stack`` on 2×2 and 1×4, explicit and gspmd,
    bit-equal with the ``"redistribute"`` bytes;
(e) the Lanczos interval within 1e-12 (rel);
(f) whole solves: stack 4×1 (RoadNet(4000), compressed split-phase),
    panel 2×2 (RoadNet(4000)) and pillar 1×4 (Hubbard(6,3), the DIA
    route) against the one process's (solved in the parent meanwhile):
    eigenvalues to 1e-9, iterations within one, and, where iterations
    and degrees agree, the bytes;
(g) stack 4×1 (a2a split-phase) from the reference's draws against the
    reference's RoadNet(4000) P = 4 solve (the recipe and the one
    ``run_distributed`` subprocess of ``tests/test_torch_solve_dist.py``)
    to 1e-9;
(i) the refusals that remain on ranks (a world size other than the
    grid's, a sub-grid of the wrong size, a rank outside its sub-grid);
(j) the split-phase proof over one rank's ``CommTrace`` of a split-phase
    SpMV (a2a and compressed), and a planted dropped ``wait`` caught;
(k) the s-step filter (s = 2 and 3, a2a and compressed cyclic/matching,
    with and without overlap) on RoadNet(4000) and HubNet(4000): each
    rank's rows bit-equal to the one-process ``make_sstep_cheb``, the
    bytes summed over the ranks and the calls per rank the one
    process's, the census of one rank's record the one process's, and
    the split-phase proof over one rank's record of one group;
(l) a stack 4×1 s = 3 solve (RoadNet(4000), compressed split-phase)
    against the one process's (with (f));
(m) ``--layout auto`` on Hubbard(6,3) with a plan cache: rank 0 plans,
    every rank runs its plan, the solve against the one-process auto
    solve, and a second plan a cache hit with no planner call;
(n) checkpoint and resume on ranks (Hubbard(6,3) pillar 1×4): a
    supervised solve faulted at an iteration boundary on every rank and
    resumed, bit-equal to (f)'s uninterrupted solve with the counters
    summed; a one-process checkpoint (rank 0 writes it) resumed on the
    ranks; a rank-written checkpoint (copied at the fault) resumed in one
    process here; a mismatched row map refused;
(o) the batched service on ranks (Hubbard(6,3), two requests, a plan
    cache, checkpoints and a fault): batched bit-equal to each request
    alone on ranks, and against the one-process service.

(h) runs the CLI under ``python -m torch.distributed.run`` (rank 0 alone
prints, the one-process CLI's eigenvalues), (p) its ``--degraded-ok``
with a failure planted on every rank (a launch started beside the
spawn), and the CLI's refusals need no launch.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
ROADNET = dict(n=4000, w=2, m=256, k=4)    # the roadnet48k config's SMOKE
HUBNET = dict(n=4000, w=2, h=4, m=192, k=4)  # hubnet48k's SMOKE
HUBBARD = dict(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)
FD = dict(n_target=4, n_search=16, tol=1e-8, max_iters=40)
ROADNET_TARGET = 12.94  # 0.1 above RoadNet(4000)'s largest eigenvalue
ENGINES = [("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "cyclic", False, True),
           ("compressed", "cyclic", True, False),
           ("compressed", "cyclic", True, True),
           ("compressed", "matching", False, True),
           ("compressed", "matching", True, False),
           ("compressed", "matching", True, True)]
SOLVES = {
    "stack": ("RoadNet", ROADNET, dict(layout="stack", spmv_comm="compressed",
                                       spmv_overlap=True), (4, 1)),
    "panel": ("RoadNet", ROADNET, dict(layout="panel"), (2, 2)),
    "pillar": ("Hubbard", HUBBARD, dict(layout="pillar"), (1, 4)),
    "sstep": ("RoadNet", ROADNET, dict(layout="stack", spmv_comm="compressed",
                                       spmv_overlap=True, spmv_sstep=3),
              (4, 1)),
}
# the s-step engines of (k): (comm, schedule, overlap)
SSTEP_ENGINES = [(comm, sched, ov) for comm, sched in (
    ("a2a", "cyclic"), ("compressed", "cyclic"), ("compressed", "matching"))
    for ov in (False, True)]
SSTEP_DEGREE = 7
# (n): a checkpoint every CKPT_INTERVAL iterations, the fault at FAULT_AT
CKPT_INTERVAL, FAULT_AT = 5, 12
# (o): the requests (id, n_target, seed) of the service
SVC_REQUESTS = (("a", 4, 11), ("b", 2, 22))


# ------------------------------------------------------------ rank side --

def _rows(rank: int, R: int) -> slice:
    return slice(rank * R, (rank + 1) * R)


def _rng(seed: int):
    return np.random.default_rng(seed)


def _world_link():
    from repro_torch.core.ranks import RankLink

    return RankLink(range(WORLD), None, torch.device("cpu"), "gloo")


def _groups():
    from repro_torch.core.shards import ShardGroup

    return ShardGroup(WORLD, "cpu"), ShardGroup(WORLD, "cpu",
                                                link=_world_link())


def _counts(g1, gr) -> dict:
    return dict(bytes=dict(gr.bytes), calls=dict(gr.calls),
                one_bytes=dict(g1.bytes), one_calls=dict(g1.calls))


def part_collectives(rank: int, payload) -> dict:
    g1, gr = _groups()
    rng = _rng(1)
    R, nb, L = 6, 3, 4
    eq = {}
    for dt in (torch.float64, torch.complex128):
        x = torch.as_tensor(rng.standard_normal((WORLD * R, nb))).to(dt)
        if dt.is_complex:
            x = x + 1j * torch.as_tensor(rng.standard_normal((WORLD * R, nb)))
        send_idx = torch.as_tensor(rng.integers(0, R, (WORLD, WORLD, L)),
                                   dtype=torch.int32)
        one = g1.all_to_all(x, send_idx)
        got = gr.all_to_all(x[_rows(rank, R)], send_idx[rank:rank + 1])
        eq[f"all_to_all[{dt}]"] = torch.equal(one[rank], got[0])
    x = torch.as_tensor(rng.standard_normal((WORLD * R, nb)))
    rows = torch.as_tensor(rng.integers(0, R, (WORLD, 5)), dtype=torch.int32)
    perm = ((0, 1), (1, 2), (2, 0))  # shard 3 receives nothing
    one = g1.gather_ppermute(x, rows, perm, key=0)
    got = gr.gather_ppermute(x[_rows(rank, R)], rows[rank:rank + 1], perm,
                             key=0)
    eq["gather_ppermute"] = torch.equal(one[rank], got[0])
    eq["gather_ppermute zeros"] = rank != 3 or not got.any()
    seg = torch.as_tensor(rng.standard_normal((WORLD, 3, 3)))
    bfly = [(i, i ^ 2) for i in range(WORLD)]
    eq["ppermute"] = torch.equal(g1.ppermute(seg, bfly)[rank],
                                 gr.ppermute(seg[rank:rank + 1], bfly)[0])
    parts = [torch.as_tensor(rng.standard_normal((3, 3)))
             for _ in range(WORLD)]
    eq["psum"] = torch.equal(g1.psum(parts), gr.psum([parts[rank]]))
    return dict(eq=eq, **_counts(g1, gr))


def _operator(name: str):
    from repro_torch.core import build_dist_ell
    from repro_torch.matrices import get_family

    fam, params = {"RoadNet": ("RoadNet", ROADNET),
                   "HubNet": ("HubNet", HUBNET),
                   "Exciton": ("Exciton", dict(L=2))}[name]
    return build_dist_ell(get_family(fam, **params), WORLD, device="cpu")


def _block(rng, D_pad: int, nb: int, dtype) -> torch.Tensor:
    x = torch.as_tensor(rng.standard_normal((D_pad, nb)))
    if dtype.is_complex:
        x = x + 1j * torch.as_tensor(rng.standard_normal((D_pad, nb)))
    return x.to(dtype)


def part_engines(rank: int, payload) -> dict:
    from repro_torch.core import make_fused_cheb_step, make_spmv

    out = {}
    for name in ("RoadNet", "HubNet", "Exciton"):
        ell = _operator(name)
        rng = _rng(2)
        R, nb, dt = ell.R, 3, ell.vals.dtype
        x, w2 = (_block(rng, ell.D_pad, nb, dt) for _ in range(2))
        rows = _rows(rank, R)
        for comm, sched, overlap, pipe in ENGINES:
            g1, gr = _groups()
            kw = dict(use_kernel=True, overlap=overlap, comm=comm,
                      schedule=sched, pipeline=pipe)
            ellr = ell.held_by(gr)
            s1, sr = make_spmv(ell, group=g1, **kw), make_spmv(
                ellr, group=gr, **kw)
            f1 = make_fused_cheb_step(ell, group=g1, **kw)
            fr = make_fused_cheb_step(ellr, group=gr, **kw)
            out[(name, sr.kind)] = dict(
                spmv=torch.equal(s1(x)[rows], sr(x[rows])),
                step=torch.equal(f1(x, w2, 0.3, -0.2)[rows],
                                 fr(x[rows], w2[rows], 0.3, -0.2)),
                L=ell.L, **_counts(g1, gr))
    return out


def part_dense(rank: int, payload) -> dict:
    from repro_torch.core import make_gram, make_svqb, make_tsqr

    out = {}
    for dt in (torch.float64, torch.complex128):
        g1, gr = _groups()
        rng = _rng(3)
        R, Ns = 40, 8
        V, W = (_block(rng, WORLD * R, Ns, dt) for _ in range(2))
        rows = _rows(rank, R)
        Q1, R1 = make_tsqr(g1)(V)
        Qr, Rr = make_tsqr(gr)(V[rows])
        out[str(dt)] = dict(
            Q=torch.equal(Q1[rows], Qr), R=torch.equal(R1, Rr),
            gram=torch.equal(make_gram(g1)(V, W),
                             make_gram(gr)(V[rows], W[rows])),
            svqb=torch.equal(make_svqb(g1)(V)[rows], make_svqb(gr)(V[rows])),
            **_counts(g1, gr))
    return out


def part_redistribute(rank: int, payload) -> dict:
    from repro_torch.core import ShardGrid, ShardGroup, make_redistribute

    out = {}
    rng = _rng(4)
    R_s, Ns = 5, 8
    V = torch.as_tensor(rng.standard_normal((WORLD * R_s, Ns)))
    for n_row, n_col in ((2, 2), (1, 4)):
        grid = ShardGrid(n_row, n_col, "cpu", ranks=True)
        i, k = divmod(rank, n_col)
        R_p, n_c = n_col * R_s, Ns // n_col
        for impl in ("explicit", "gspmd"):
            g1 = ShardGroup(WORLD, "cpu")
            tp1, ts1 = make_redistribute(g1, n_col, impl)
            grid.stack.reset_counts()
            tpr, tsr = make_redistribute(grid.stack, n_col, impl,
                                         row_link=grid.row_link)
            Vp1 = tp1(V)
            Vpr = tpr(V[_rows(rank, R_s)])
            back = tsr(list(Vpr))
            out[(f"{n_row}x{n_col}", impl)] = dict(
                to_panel=torch.equal(Vp1[k, i * R_p:(i + 1) * R_p], Vpr[0]),
                to_stack=torch.equal(back, ts1(Vp1)[_rows(rank, R_s)]),
                shape=tuple(Vpr.shape) == (1, R_p, n_c),
                **_counts(g1, grid.stack))
    return out


def _fd(fam: str, params: dict, target: float, n_row: int, n_col: int,
        ranks: bool, device, **cfg):
    from repro_torch.core import FDConfig, FilterDiag
    from repro_torch.matrices import get_family

    c = FDConfig(target=target, spmv_kernel=True, **{**FD, **cfg})
    return FilterDiag(get_family(fam, **params), c, device=device,
                      n_row=n_row, n_col=n_col, ranks=ranks)


def part_lanczos(rank: int, payload) -> dict:
    out = {}
    for ranks in (False, True):
        fd = _fd("RoadNet", ROADNET, ROADNET_TARGET, WORLD, 1, ranks, "cpu",
                 layout="stack")
        out[ranks] = fd.lanczos(fd.lanczos_start(fd.generator(7)))
    return out


def _summary(res) -> dict:
    return dict(eigenvalues=res.eigenvalues, iterations=res.iterations,
                n_converged=res.n_converged, exchange=res.exchange,
                degrees=[h.get("degree") for h in res.history],
                vectors=res.eigenvectors.shape, residuals=res.residuals,
                total_spmvs=res.total_spmvs)


def part_solves(rank: int, payload) -> dict:
    out = {}
    for name, (fam, params, cfg, (n_row, n_col)) in SOLVES.items():
        fd = _fd(fam, params, payload["targets"][name], n_row, n_col, True,
                 "cpu", **cfg)
        out[name] = _summary(fd.solve())
    return out


def part_reference(rank: int, payload) -> dict:
    fd = _fd("RoadNet", ROADNET, ROADNET_TARGET, WORLD, 1, True, "cpu",
             layout="stack", spmv_overlap=True, spmv_comm="a2a")
    res = fd.solve(v0=payload["draws"]["v0"], V0=payload["draws"]["V0"])
    return dict(engine=fd.engine, **_summary(res))


def part_refusals(rank: int, payload) -> dict:
    from repro_torch.core import ShardGrid

    out = {}

    def refused(key, fn, exc):
        try:
            fn()
        except exc as e:
            out[key] = str(e)
        else:
            out[key] = None

    refused("world", lambda: ShardGrid(2, 1, "cpu", ranks=True), ValueError)
    refused("members", lambda: ShardGrid(2, 1, "cpu", ranks=True,
                                         members=(0, 1, 2)), ValueError)
    # every rank makes the sub-grid's group; ranks 2 and 3 are not in it
    refused("outside", lambda: ShardGrid(1, 2, "cpu", ranks=True,
                                         members=(0, 1)), ValueError)
    return out


def _trace_census(trace) -> list:
    from repro_torch.analysis.census import measured

    return sorted((c.kind, c.bytes, c.mult, c.name) for c in measured(trace))


def part_sstep(rank: int, payload) -> dict:
    """(k) The s-step filter on ranks against the one process's."""
    from repro_torch.analysis.overlap_check import check_split_phase
    from repro_torch.core import build_sstep_ell, make_sstep_cheb
    from repro_torch.core.shards import CommTrace
    from repro_torch.matrices import get_family

    out = {}
    mu = np.linspace(1.0, 0.2, SSTEP_DEGREE + 1)
    for name, params in (("RoadNet", ROADNET), ("HubNet", HUBNET)):
        mat = get_family(name, **params)
        for s in (2, 3):
            host = build_sstep_ell(mat, WORLD, s, split_halo=True,
                                   device="cpu")
            R = host.R
            V = _block(_rng(6), host.D_pad, 2, torch.float64)
            rows = _rows(rank, R)
            for comm, sched, ov in SSTEP_ENGINES:
                g1, gr = _groups()
                kw = dict(use_kernel=True, overlap=ov, comm=comm,
                          schedule=sched)
                a1 = make_sstep_cheb(host, group=g1, **kw)
                ar = make_sstep_cheb(host.held_by(gr), group=gr, **kw)
                t1, tr = CommTrace().attach(g1), CommTrace().attach(gr)
                Y1 = a1(V, mu, 0.3, -0.1)
                Yr = ar(V[rows].contiguous(), mu, 0.3, -0.1)
                census = (_trace_census(tr), _trace_census(t1))
                counts = _counts(g1, gr)
                # one group (a degree-s filter) on a fresh record
                tr.clear()
                ar(V[rows].contiguous(), np.ones(s + 1), 0.3, 0.1)
                proof = check_split_phase(tr)
                CommTrace.detach(gr)
                CommTrace.detach(g1)
                out[(name, s, ar.kind)] = dict(
                    rows=torch.equal(Y1[rows], Yr), census=census,
                    proof_ok=proof.ok, proof_errors=proof.errors,
                    overlap=ov, **counts)
    return out


def _hubbard_fd(target, n_row, n_col, ranks, **cfg):
    return _fd("Hubbard", HUBBARD, target, n_row, n_col, ranks, "cpu",
               **cfg)


def part_auto(rank: int, payload) -> dict:
    """(m) ``--layout auto`` with a plan cache on ranks: rank 0 plans
    (the CLI's ``plan_auto``), every rank gets its plan; a second plan
    hits the cache; ``FilterDiag(layout="auto")`` plans on rank 0 too."""
    from repro_torch.core import FDConfig, FilterDiag
    from repro_torch.core import perf_model as pm
    from repro_torch.core.filter_diag import plan_fingerprint
    from repro_torch.launch import solve as cli
    from repro_torch.matrices import get_family
    from repro_torch.service import PlanCache
    from repro_torch.service.plan_cache import cached_plan_layout
    from repro_torch.core.planner import auto_axes

    mat = get_family("Hubbard", **HUBBARD)
    cfg = FDConfig(target=payload["targets"]["pillar"], spmv_kernel=True,
                   layout="auto", **FD)
    path = os.path.join(payload["tmp"], "auto_cache.json")
    fd2, n_row, n_col, rowmap = cli.plan_auto(mat, cfg, WORLD, pm.H100_1CARD,
                                              path, ranks=True, device="cpu")
    cache = PlanCache(path)
    plan, hit = cached_plan_layout(mat, WORLD, cache=cache,
                                   machine=pm.H100_1CARD, ranks=True,
                                   device="cpu",
                                   **auto_axes(cfg, mat.D, WORLD))
    solver = FilterDiag(mat, fd2, device="cpu", n_row=n_row, n_col=n_col,
                        rowmap=rowmap, ranks=True)
    res = solver.solve()
    fd_auto = _hubbard_fd(cfg.target, WORLD, 1, True, layout="auto")
    return dict(cfg=fd2, split=(n_row, n_col),
                fingerprint=plan_fingerprint(fd2, solver.rowmap).tobytes(),
                second=(plan.best.describe(), hit, cache.hits,
                        cache.plan_calls),
                layout=solver.layout.describe(),
                fd_auto=(fd_auto.layout.describe(), fd_auto.engine,
                         fd_auto.plan.best.describe()),
                **_summary(res))


def part_checkpoint(rank: int, payload) -> dict:
    """(n) Checkpoint and resume on ranks (Hubbard(6,3) pillar 1×4)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.runtime import Supervisor, SupervisorConfig
    from repro_torch.service.jobs import FilterDiagJob, unpack_state

    tmp, target = payload["tmp"], payload["targets"]["pillar"]
    sup_cfg = SupervisorConfig(checkpoint_interval=CKPT_INTERVAL,
                               max_restarts=1)
    out = {}
    # a fault on every rank at FAULT_AT; rank 0 keeps a copy of the
    # checkpoints at that moment for the one process to resume
    faulted = os.path.join(tmp, "ckpt_ranks")
    fd = _hubbard_fd(target, 1, WORLD, True, layout="pillar")
    faults = []

    def fault_hook(step):
        if step == FAULT_AT and not faults:
            faults.append(step)
            if rank == 0:
                shutil.copytree(faulted, faulted + "_at_fault")
            raise RuntimeError(f"fault injected at iteration {step}")

    sup = Supervisor(faulted, sup_cfg, link=fd.group.link)
    state = sup.run_job(FilterDiagJob(fd), fault_hook=fault_hook)
    out["faulted"] = dict(restarts=sup.restarts, faults=faults,
                          **_summary(state.result))
    # a one-process checkpoint (rank 0 writes it, faulted past a save)
    one_dir = os.path.join(tmp, "ckpt_one")
    if rank == 0:
        fd1 = _hubbard_fd(target, 1, WORLD, False, layout="pillar")

        def die(step):
            if step == FAULT_AT:
                raise RuntimeError("the one process stops here")

        try:
            Supervisor(one_dir, SupervisorConfig(
                checkpoint_interval=CKPT_INTERVAL, max_restarts=0)).run_job(
                FilterDiagJob(fd1), fault_hook=die)
        except RuntimeError:
            pass
    dist.barrier()
    fd = _hubbard_fd(target, 1, WORLD, True, layout="pillar")
    sup = Supervisor(one_dir, sup_cfg, link=fd.group.link)
    state = sup.run_job(FilterDiagJob(fd))
    out["from_one"] = dict(restarts=sup.restarts, **_summary(state.result))
    # a checkpoint of another row map is refused
    job = FilterDiagJob(fd)
    tree, _, extra = restore(one_dir, job.template(), device="cpu")
    try:
        unpack_state(tree, dict(extra, rowmap="0" * 16), fd)
    except ValueError as e:
        out["mismatch"] = str(e)
    else:
        out["mismatch"] = None
    return out


def part_service(rank: int, payload) -> dict:
    """(o) The batched, supervised service on ranks, then each request
    alone on ranks, through one plan cache."""
    from repro_torch.runtime import SupervisorConfig
    from repro_torch.service import EigenService, PlanCache

    tmp = payload["tmp"]
    cache = PlanCache(os.path.join(tmp, "svc_cache.json"))
    svc = EigenService(n_shards=WORLD, device="cpu", spmv_kernel=True,
                       plan_cache=cache, ckpt_root=os.path.join(tmp, "svc"),
                       supervisor_cfg=SupervisorConfig(
                           checkpoint_interval=CKPT_INTERVAL,
                           max_restarts=1), ranks=True)
    for req in _svc_requests(payload["targets"]["pillar"]):
        svc.submit(req)
    faults = []

    def fault_hook(step):
        if step == FAULT_AT and not faults:
            faults.append(step)
            raise RuntimeError(f"fault injected at iteration {step}")

    batched = svc.drain(fault_hook=fault_hook)
    out = dict(batched={k: _summary(v) for k, v in batched.items()},
               groups=svc.groups, restarts=svc.restarts, faults=faults,
               cell=svc.groups[0]["cell"])
    solo = {}
    for req in _svc_requests(payload["targets"]["pillar"]):
        one = EigenService(n_shards=WORLD, device="cpu", spmv_kernel=True,
                           plan_cache=cache, ranks=True)
        one.submit(req)
        solo.update({k: _summary(v) for k, v in one.drain().items()})
    out.update(solo=solo, hits=cache.hits, misses=cache.misses,
               plan_calls=cache.plan_calls)
    return out


def _svc_requests(target: float) -> list:
    from repro_torch.service import SolveRequest

    return [SolveRequest(rid, family="Hubbard", params=HUBBARD,
                         n_target=n_t, n_search=FD["n_search"],
                         target=target, tol=FD["tol"],
                         max_iters=FD["max_iters"], seed=seed)
            for rid, n_t, seed in SVC_REQUESTS]


def part_proof(rank: int, payload) -> dict:
    from repro_torch.analysis.overlap_check import (check_split_phase,
                                                    dropped_wait)
    from repro_torch.core import make_spmv
    from repro_torch.core.shards import CommTrace

    ell = _operator("RoadNet")
    x = _block(_rng(5), ell.D_pad, 2, torch.float64)[_rows(rank, ell.R)]
    out = {}
    for comm in ("a2a", "compressed"):
        _, gr = _groups()
        spmv = make_spmv(ell.held_by(gr), group=gr, overlap=True, comm=comm,
                         pipeline=False, use_kernel=True)
        trace = CommTrace().attach(gr)
        y = spmv(x)
        ok = check_split_phase(trace)
        kinds = [e.kind for e in trace.entries]
        trace.clear()
        with dropped_wait(gr):
            spmv(x)
        planted = check_split_phase(trace)
        out[spmv.kind] = dict(ok=ok.ok, errors=ok.errors,
                              planted_caught=not planted.ok,
                              kinds=kinds, y=y)
    return out


PARTS = dict(collectives=part_collectives, engines=part_engines,
             dense=part_dense, redistribute=part_redistribute,
             lanczos=part_lanczos, solves=part_solves,
             reference=part_reference, refusals=part_refusals,
             proof=part_proof, sstep=part_sstep, auto=part_auto,
             checkpoint=part_checkpoint, service=part_service)


def _one_process(targets: dict) -> dict:
    """The one-process counterparts of (m), (o) and (p), solved here."""
    from repro_torch.core import FDConfig, FilterDiag
    from repro_torch.core import perf_model as pm
    from repro_torch.launch import solve as cli
    from repro_torch.matrices import get_family
    from repro_torch.service import EigenService

    mat = get_family("Hubbard", **HUBBARD)
    cfg = FDConfig(target=targets["pillar"], spmv_kernel=True, layout="auto",
                   **FD)
    fd2, n_row, n_col, rowmap = cli.plan_auto(mat, cfg, WORLD, pm.H100_1CARD)
    auto = _summary(FilterDiag(mat, fd2, device="cpu", n_row=n_row,
                               n_col=n_col, rowmap=rowmap).solve())
    auto.update(cfg=fd2, split=(n_row, n_col))
    svc = EigenService(n_shards=WORLD, device="cpu", spmv_kernel=True)
    for req in _svc_requests(targets["pillar"]):
        svc.submit(req)
    service = dict(results={k: _summary(v) for k, v in svc.drain().items()},
                   cell=svc.groups[0]["cell"])
    # the degraded retry of (p): n_search 32 -> 16 on the 2x1 sub-grid
    degraded = _summary(_hubbard_fd(targets["pillar"], 2, 1, False,
                                    layout="panel", n_search=16).solve())
    return dict(auto=auto, service=service, degraded=degraded)


def _child(rank: int, store: str, outdir: str, payload) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.core.ranks import init_ranks

    init_ranks("gloo", "cpu", init_method=f"file://{store}", rank=rank,
               world_size=WORLD)
    try:
        results = {name: fn(rank, payload) for name, fn in PARTS.items()}
        torch.save(results, os.path.join(outdir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- parent side --

REF_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import FDConfig, FilterDiag
from repro.matrices import get_family
m = get_family("RoadNet", **{params!r})
P = 4
cfg = FDConfig(target={target!r}, spmv_overlap=True, spmv_comm="a2a",
               layout="stack", **{fd!r})
mesh = jax.make_mesh((P, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:P])
key = jax.random.PRNGKey(cfg.seed)
with mesh:
    fd = FilterDiag(m, mesh, cfg)
    fd.spmv_stack = jax.jit(fd.spmv_stack)
    k0, k1 = jax.random.split(key)
    v0 = np.asarray(jax.random.normal(k0, (fd.D_pad, 1)))
    V0 = np.asarray(jax.random.normal(k1, (fd.D_pad, cfg.n_search)))
    res = fd.solve(key)
np.savez({path!r}, eigenvalues=res.eigenvalues, iterations=res.iterations,
         n_converged=res.n_converged, v0=v0, V0=V0)
print("ok")
"""


def _roadnet_d() -> int:
    """RoadNet(4000)'s D, which 4 shards split with no pad (D_pad = D)."""
    from repro_torch.matrices import get_family

    return get_family("RoadNet", **ROADNET).D


def _targets() -> dict:
    from repro_torch.matrices import get_family

    w = np.linalg.eigvalsh(get_family("Hubbard", **HUBBARD)
                           .build_csr().to_dense())
    return dict(stack=ROADNET_TARGET, panel=ROADNET_TARGET,
                pillar=float(w[0]) - 0.1, sstep=ROADNET_TARGET)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one spawn of 4 ranks, beside it the reference's solve (its
    subprocess on a thread) and the one process's solves here, the stack
    one through the CLI (what (h) holds the rank CLI to). The ranks start
    (g) from the reference's draws, taken here as its script takes them
    (the key split of ``repro/core/filter_diag.py:410-418``) and held to
    the ones it saved. Returns ``(per-rank results, one-process solves,
    the reference)``."""
    import threading

    import jax

    from repro_torch.launch import solve as cli
    from tests.conftest import run_distributed

    tmp = tmp_path_factory.mktemp("ranks")
    path = str(tmp / "ref.npz")
    ref_run = threading.Thread(target=run_distributed, args=(
        REF_SCRIPT.format(params=ROADNET, target=ROADNET_TARGET, fd=FD,
                          path=path),), kwargs=dict(n_devices=8, timeout=900))
    ref_run.start()
    k0, k1 = jax.random.split(jax.random.PRNGKey(7))  # FDConfig.seed
    D = _roadnet_d()
    draws = dict(v0=np.asarray(jax.random.normal(k0, (D, 1))),
                 V0=np.asarray(jax.random.normal(k1, (D, FD["n_search"]))))
    targets = _targets()
    payload = dict(targets=targets, draws=draws, tmp=str(tmp))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    degraded = _launch_degraded(tmp, targets["pillar"])
    try:
        ctx = mp.start_processes(_child, args=(str(tmp / "store"), str(tmp),
                                               payload),
                                 nprocs=WORLD, start_method="spawn",
                                 join=False)
        one = {}
        for name, (fam, params, cfg, (n_row, n_col)) in SOLVES.items():
            if name == "stack":  # the CLI's config is SOLVES["stack"]'s
                one[name] = _summary(cli.main(_cli_argv(), verbose=False))
                continue
            fd = _fd(fam, params, targets[name], n_row, n_col, False, "cpu",
                     **cfg)
            one[name] = _summary(fd.solve())
        one.update(_one_process(targets))
        while not ctx.join():
            pass
        one["resumed_here"] = _resume_here(tmp, targets["pillar"])
        one["degraded_launch"] = degraded.communicate(timeout=600)
        one["degraded_rc"] = degraded.returncode
    finally:
        if degraded.poll() is None:
            degraded.kill()
            degraded.communicate()
        torch.set_num_threads(threads)
        ref_run.join()
    ref = dict(np.load(path))
    ref["draws_equal"] = all(np.array_equal(draws[k], ref[k])
                             for k in ("v0", "V0"))
    ranks = [torch.load(tmp / f"{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, one, ref


def _resume_here(tmp, target: float) -> dict:
    """(n) The ranks' checkpoints as they stood at the fault, resumed in
    one process."""
    from repro_torch.runtime import Supervisor, SupervisorConfig
    from repro_torch.service.jobs import FilterDiagJob

    from repro_torch.checkpoint import latest_step

    fd = _hubbard_fd(target, 1, WORLD, False, layout="pillar")
    path = str(tmp / "ckpt_ranks_at_fault")
    at = latest_step(path)
    sup = Supervisor(path, SupervisorConfig(checkpoint_interval=CKPT_INTERVAL))
    state = sup.run_job(FilterDiagJob(fd))
    return dict(resumed_at=at, **_summary(state.result))


DEGRADED_SCRIPT = r"""
import sys
from repro_torch.core import FilterDiag
from repro_torch.launch import solve as cli
real, seen = FilterDiag.solve, []
def flaky(self, *a, **kw):  # the planted failure, on every rank
    seen.append(self.N_col)
    if len(seen) == 1:
        raise RuntimeError("lost a column group")
    return real(self, *a, **kw)
FilterDiag.solve = flaky
cli.main(sys.argv[1:])
print(f"[rank] N_col of each solve: {seen}", file=sys.stderr)
"""


def _degraded_argv(target: float) -> list:
    return ["--family", "Hubbard",
            "--params", ",".join(f"{k}={v}" for k, v in HUBBARD.items()),
            "--n-target", "4", "--n-search", "32", "--target", repr(target),
            "--tol", "1e-8", "--max-iters", "40", "--spmv-kernel",
            "--n-row", "2", "--n-col", "2", "--layout", "panel",
            "--device", "cpu", "--backend", "gloo", "--degraded-ok"]


def _torchrun_env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [os.path.join(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))), "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _launch_degraded(tmp, target: float) -> subprocess.Popen:
    """(p) ``--degraded-ok`` under ``python -m torch.distributed.run``
    with a failure planted on every rank, started here beside the
    spawn."""
    script = tmp / "degraded.py"
    script.write_text(DEGRADED_SCRIPT)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(script),
         *_degraded_argv(target)],
        env=_torchrun_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp)


def _sum_counts(per_rank: list) -> tuple:
    """Bytes summed over the ranks; each rank's calls."""
    keys = per_rank[0]["bytes"]
    return ({k: sum(r["bytes"][k] for r in per_rank) for k in keys},
            [r["calls"] for r in per_rank])


def _held_to_one_process(per_rank: list) -> None:
    summed, calls = _sum_counts(per_rank)
    assert summed == per_rank[0]["one_bytes"]
    assert all(c == per_rank[0]["one_calls"] for c in calls)


def test_collectives_bit_equal_with_bytes_summed(run):
    """(a) Each collective on 4 ranks equals the one-process group's rows
    bit for bit (a receiver outside the round's permutation holds
    zeros); the bytes summed over the ranks and each rank's calls are
    the one process's."""
    ranks, _, _ = run
    parts = [r["collectives"] for r in ranks]
    for r, p in enumerate(parts):
        assert all(p["eq"].values()), (r, p["eq"])
    _held_to_one_process(parts)
    assert parts[0]["one_calls"] == dict(all_to_all=2, ppermute=2, psum=1,
                                         redistribute=0)


@pytest.mark.parametrize("op", ["RoadNet", "HubNet", "Exciton"])
def test_engines_bit_equal_on_ranks(run, op):
    """(b) The eight halo engines' SpMV and fused step, each rank's rows
    bit-equal to the one-process engine's, bytes and calls as in (a)."""
    ranks, _, _ = run
    kinds = {k for (name, k) in ranks[0]["engines"] if name == op}
    assert len(kinds) == 8
    for kind in kinds:
        per_rank = [r["engines"][(op, kind)] for r in ranks]
        assert per_rank[0]["L"] > 0
        for r, p in enumerate(per_rank):
            assert p["spmv"] and p["step"], (op, kind, r)
        _held_to_one_process(per_rank)


def test_tsqr_gram_svqb_bit_equal(run):
    """(c) TSQR's Q and R, the Gram matrix and SVQB on ranks equal the
    one process's bit for bit, fp64 and complex128."""
    ranks, _, _ = run
    for dt in ranks[0]["dense"]:
        per_rank = [r["dense"][dt] for r in ranks]
        for r, p in enumerate(per_rank):
            assert p["Q"] and p["R"] and p["gram"] and p["svqb"], (dt, r)
        _held_to_one_process(per_rank)


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
def test_redistribution_bit_equal(run, grid):
    """(d) ``to_panel`` / ``to_stack`` within the panel row on ranks:
    each rank's bundle and stack rows equal the one process's, both
    impls, and the ``"redistribute"`` bytes summed over the ranks equal
    its ``N_s·D_pad·(1 − 1/N_col)·S`` per move."""
    ranks, _, _ = run
    for impl in ("explicit", "gspmd"):
        per_rank = [r["redistribute"][(grid, impl)] for r in ranks]
        for r, p in enumerate(per_rank):
            assert p["to_panel"] and p["to_stack"] and p["shape"], (impl, r)
        _held_to_one_process(per_rank)
        assert per_rank[0]["one_bytes"]["redistribute"] > 0


def test_lanczos_interval_on_ranks(run):
    """(e) The interval from the shard-ordered reductions stands within
    1e-12 (rel) of the one process's whole-block ``vdot`` and norm."""
    ranks, _, _ = run
    for r in ranks:
        one, got = np.array(r["lanczos"][False]), np.array(r["lanczos"][True])
        np.testing.assert_allclose(got, one, rtol=1e-12, atol=0)
    assert all(r["lanczos"][True] == ranks[0]["lanczos"][True] for r in ranks)


@pytest.mark.parametrize("name", list(SOLVES))
def test_rank_solves_match_one_process(run, name):
    """(f) Whole solves on 4 ranks: every rank returns the same
    eigenvalues and vectors' shape, within 1e-9 of the one process's,
    iterations within one, and where the iterations and degrees agree
    the bytes summed over the ranks and the calls are the one
    process's."""
    ranks, one, _ = run
    got = [r["solves"][name] for r in ranks]
    want = one[name]
    for g in got:
        np.testing.assert_array_equal(g["eigenvalues"], got[0]["eigenvalues"])
    g = got[0]
    assert g["n_converged"] >= FD["n_target"] and g["vectors"][1] == len(
        g["eigenvalues"])
    assert abs(g["iterations"] - want["iterations"]) <= 1
    np.testing.assert_allclose(np.sort(g["eigenvalues"]),
                               np.sort(want["eigenvalues"]), rtol=0,
                               atol=1e-9)
    ex, ex1 = g["exchange"], want["exchange"]
    assert ex["ranks"]["world"] == WORLD and ex["ranks"]["backend"] == "gloo"
    assert ex["layout"] == ex1["layout"]
    if g["degrees"] == want["degrees"]:
        assert (ex["bytes"], ex["calls"]) == (ex1["bytes"], ex1["calls"])
        assert ex["panel"] == ex1["panel"]


def test_rank_solve_matches_the_reference(run):
    """(g) Stack 4×1 on 4 ranks with the a2a split-phase engine, from the
    reference's draws, against the reference's RoadNet(4000) P = 4
    solve: eigenvalues within 1e-9, iterations within one."""
    ranks, _, ref = run
    g = ranks[0]["reference"]
    assert ref["draws_equal"]  # the draws the ranks started from
    assert g["engine"] == "a2a-overlap"
    assert g["n_converged"] == int(ref["n_converged"]) >= FD["n_target"]
    assert abs(g["iterations"] - int(ref["iterations"])) <= 1
    np.testing.assert_allclose(np.sort(g["eigenvalues"]),
                               np.sort(ref["eigenvalues"]), rtol=0, atol=1e-9)


def test_refusals_on_ranks(run):
    """(i) The refusals that remain on ranks: a world size other than the
    grid's, a sub-grid with another number of members than shards, and a
    rank outside the sub-grid it is asked to build (the others build
    it), each naming why."""
    ranks, _, _ = run
    for rank, r in enumerate(ranks):
        out = r["refusals"]
        assert "one rank a shard" in out["world"]
        assert "needs 2 distinct ranks" in out["members"]
        if rank < 2:
            assert out["outside"] is None
        else:
            assert "is not one of (0, 1)" in out["outside"]


@pytest.mark.parametrize("op", ["RoadNet", "HubNet"])
def test_sstep_filter_bit_equal_on_ranks(run, op):
    """(k) The s-step filter (s = 2, 3; a2a and compressed cyclic and
    matching, with and without overlap) on 4 ranks: each rank's rows
    bit-equal to the one-process filter's, the bytes summed over the
    ranks and each rank's calls the one process's, the census of a
    rank's record (its collectives per device) the one process's, and
    the split-phase proof over one rank's record of one group holding
    exactly where the engine overlaps."""
    ranks, _, _ = run
    keys = [k for k in ranks[0]["sstep"] if k[0] == op]
    assert len(keys) == 2 * len(SSTEP_ENGINES)
    for key in keys:
        per_rank = [r["sstep"][key] for r in ranks]
        for r, p in enumerate(per_rank):
            assert p["rows"], (key, r)
            assert p["census"][0] == p["census"][1], (key, r)
            assert p["proof_ok"] == p["overlap"], (key, r, p["proof_errors"])
        _held_to_one_process(per_rank)
        assert sum(per_rank[0]["one_calls"][k] for k in (
            "all_to_all", "ppermute")) > 0


def test_sstep_solve_on_ranks(run):
    """(l) A stack 4×1 solve with the s = 3 filter (compressed cyclic,
    split-phase) on 4 ranks against the one process's: eigenvalues to
    1e-9, iterations within one, ⌈degree/3⌉ exchanges a filter, and
    where the degrees agree the bytes summed and the calls the one
    process's."""
    ranks, one, _ = run
    g, want = ranks[0]["solves"]["sstep"], one["sstep"]
    assert all(np.array_equal(r["solves"]["sstep"]["eigenvalues"],
                              g["eigenvalues"]) for r in ranks)
    assert g["n_converged"] >= FD["n_target"]
    assert abs(g["iterations"] - want["iterations"]) <= 1
    np.testing.assert_allclose(np.sort(g["eigenvalues"]),
                               np.sort(want["eigenvalues"]), rtol=0,
                               atol=1e-9)
    ex = g["exchange"]
    assert ex["sstep"] == 3
    assert ex["filter_engine"] == "compressed-cyclic-overlap+s3"
    assert ex["filter_exchanges"] == sum(-(-d // 3) for d in g["degrees"]
                                         if d)
    if g["degrees"] == want["degrees"]:
        assert (ex["bytes"], ex["calls"]) == (want["exchange"]["bytes"],
                                              want["exchange"]["calls"])


def test_layout_auto_with_plan_cache_on_ranks(run):
    """(m) ``--layout auto`` on 4 ranks through a plan cache: every rank
    runs rank 0's plan (its config, split and row map), which is the one
    process's; the solve equals the one-process auto solve to 1e-9; the
    second plan is a cache hit with no planner call; and
    ``FilterDiag(layout="auto")`` on ranks plans the grid's layout on
    rank 0 for every rank."""
    ranks, one, _ = run
    got = [r["auto"] for r in ranks]
    want = one["auto"]
    for g in got:
        assert g["fingerprint"] == got[0]["fingerprint"]
        assert (g["cfg"], g["split"]) == (want["cfg"], want["split"])
        assert g["fd_auto"] == got[0]["fd_auto"]
        np.testing.assert_array_equal(g["eigenvalues"], got[0]["eigenvalues"])
    g = got[0]
    # the second plan's own cache: a hit and no planner call
    assert g["second"][1:] == (True, 1, 0)
    assert abs(g["iterations"] - want["iterations"]) <= 1
    np.testing.assert_allclose(np.sort(g["eigenvalues"]),
                               np.sort(want["eigenvalues"]), rtol=0,
                               atol=1e-9)


def _same_result(a: dict, b: dict) -> None:
    """Two summaries of one solve, bit for bit (the exchange summary
    without what only a rank reports)."""
    for k in ("eigenvalues", "residuals"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("iterations", "n_converged", "degrees", "vectors",
              "total_spmvs"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("case", ["faulted", "from_one", "to_one"])
def test_checkpoint_resume_on_ranks(run, case):
    """(n) Checkpoint and resume on 4 ranks (Hubbard(6,3) pillar 1×4,
    a checkpoint every 5 iterations). ``faulted``: a fault on every rank
    at iteration 12, restored from the step-10 checkpoint rank 0 wrote,
    is bit-equal to the uninterrupted rank solve ((f)'s pillar), its
    counters summed over the ranks equal; ``from_one``: a checkpoint one
    process wrote, resumed on the ranks, and ``to_one``: the ranks'
    checkpoints as they stood at the fault, resumed in one process, each
    match the uninterrupted solve to 1e-9 (iterations and degrees
    equal). A checkpoint of another row map is refused."""
    ranks, one, _ = run
    full = ranks[0]["solves"]["pillar"]
    if case == "to_one":
        got = one["resumed_here"]
        assert got["resumed_at"] == 10
    else:
        got = ranks[0]["checkpoint"][case]
        assert all(r["checkpoint"][case]["eigenvalues"].tolist()
                   == got["eigenvalues"].tolist() for r in ranks)
        assert "does not match the solver's" in ranks[0]["checkpoint"][
            "mismatch"]
    if case == "faulted":
        assert got["restarts"] == 1 and got["faults"] == [FAULT_AT]
        _same_result(got, full)
        ex, ex0 = got["exchange"], full["exchange"]
        for k in ("bytes", "calls", "panel", "filter_exchanges", "layout"):
            assert ex[k] == ex0[k], k
        return
    assert (got["iterations"], got["degrees"]) == (full["iterations"],
                                                   full["degrees"])
    np.testing.assert_allclose(got["eigenvalues"], full["eigenvalues"],
                               rtol=0, atol=1e-9)
    for k in ("bytes", "calls", "panel", "filter_exchanges"):
        assert got["exchange"][k] == full["exchange"][k], k


def test_batched_service_on_ranks(run):
    """(o) The service on 4 ranks: rank 0 planned the pattern once
    through the cache (later drains hit), the batched, supervised drain
    restarted once from the fault and is bit-equal to each request
    served alone on the ranks, every rank holds the same results, and
    each request equals the one-process service's to 1e-9 on the same
    planned cell."""
    ranks, one, _ = run
    svc = ranks[0]["service"]
    assert svc["restarts"] == 1 and svc["faults"] == [FAULT_AT]
    assert svc["cell"] == one["service"]["cell"]
    assert (svc["plan_calls"], svc["misses"], svc["hits"]) == (1, 1, 2)
    for rid, _, _ in SVC_REQUESTS:
        b, solo = svc["batched"][rid], svc["solo"][rid]
        _same_result(b, solo)
        for r in ranks[1:]:
            _same_result(r["service"]["batched"][rid], b)
        want = one["service"]["results"][rid]
        assert b["iterations"] == want["iterations"]
        np.testing.assert_allclose(b["eigenvalues"], want["eigenvalues"],
                                   rtol=0, atol=1e-9)


def test_split_phase_proof_on_a_rank(run):
    """(j) The split-phase proof holds on one rank's record of a
    split-phase SpMV (its async exchange between start and wait), and a
    planted dropped ``wait`` is caught; the SpMV equals (b)'s."""
    ranks, _, _ = run
    for r in ranks:
        for kind, p in r["proof"].items():
            assert p["ok"], (kind, p["errors"])
            assert p["planted_caught"], kind
            assert "start" in p["kinds"] and "wait" in p["kinds"]


def _cli_argv(extra=()) -> list:
    return ["--family", "RoadNet",
            "--params", ",".join(f"{k}={v}" for k, v in ROADNET.items()),
            "--n-target", "4", "--n-search", "16", "--target",
            str(ROADNET_TARGET), "--tol", "1e-8", "--max-iters", "40",
            "--spmv-kernel", "--n-row", "4", "--spmv-comm", "compressed",
            "--spmv-overlap", "--device", "cpu", *extra]


def _eigenvalues(out: str) -> np.ndarray:
    text = out.split("eigenvalues:", 1)[1].split("kernel launches", 1)[0]
    return np.array([float(v) for v in
                     text.replace("[", " ").replace("]", " ").split()])


def test_cli_under_torchrun_prints_once(run, tmp_path):
    """(h) ``python -m torch.distributed.run --standalone --nproc-per-node
    4 -m repro_torch.launch.solve ... --backend gloo``: rank 0 alone
    prints, the one-process CLI's eigenvalues (the fixture's stack solve,
    to their printed precision) with the world size, the backend and the
    staged bytes."""
    _, one, _ = run
    env = _torchrun_env()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.solve",
         *_cli_argv(("--backend", "gloo"))],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-4000:]
    out = r.stdout
    assert out.count("eigenvalues:") == 1 and out.count("converged ") == 1
    assert "ranks: 4 (gloo, one process a shard" in out
    assert "stack(4x1)" in out and "compressed-cyclic-overlap" in out
    np.testing.assert_allclose(_eigenvalues(out), one["stack"]["eigenvalues"],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("extra,match", [
    (("--backend", "nccl", "--share-card"), "NCCL refuses"),
    (("--share-card",), "needs --backend"),
], ids=["nccl-share-card", "share-card-alone"])
def test_cli_refuses_on_ranks(capsys, extra, match):
    """(i) The CLI refuses the options a rank launch does not take, before
    it starts a process group."""
    from repro_torch.launch import solve as cli

    with pytest.raises(SystemExit):
        cli.main(_cli_argv(extra))
    assert match in capsys.readouterr().err


def test_cli_degraded_ok_under_torchrun(run):
    """(p) ``--degraded-ok`` under ``python -m torch.distributed.run``
    with a failure planted on every rank's first solve: the panel 2×2
    launch retries on the 2×1 sub-grid of ranks 0 and 2 with n_search
    32 → 16, the last column's ranks wait and print nothing, rank 0
    prints once, and the eigenvalues equal the one-process degraded
    retry's (panel 2×1, n_search 16) to 1e-9."""
    _, one, _ = run
    out, err = one["degraded_launch"]
    assert one["degraded_rc"] == 0, err[-4000:]
    assert out.count("[degraded]") == 1 and out.count("eigenvalues:") == 1
    assert "lost a column group" in out
    assert "retrying with n_search=16 on 2x1" in out
    assert "panel(2x1)" in out and "ranks: 2 (gloo" in out
    assert sorted(ln for ln in err.splitlines()
                  if "N_col of each solve" in ln) == sorted(
        [f"[rank] N_col of each solve: {s}"
         for s in ([2, 1], [2], [2, 1], [2])])
    np.testing.assert_allclose(np.sort(_eigenvalues(out)),
                               np.sort(one["degraded"]["eigenvalues"]),
                               rtol=0, atol=1e-9)


def test_nccl_with_a_shared_card_raises():
    """(i) ``init_ranks`` refuses nccl with a shared card (NCCL refuses
    two ranks on one device) and on the CPU, before any process group."""
    from repro_torch.core.ranks import init_ranks

    with pytest.raises(ValueError, match="NCCL refuses"):
        init_ranks("nccl", "cuda", share_card=True)
    with pytest.raises(ValueError, match="needs CUDA"):
        init_ranks("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        init_ranks("mpi", "cpu")
