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
(i) the refusals on ranks (a world size other than the grid's, the
    s-step filter, ``layout="auto"``, a checkpoint's counters);
(j) the split-phase proof over one rank's ``CommTrace`` of a split-phase
    SpMV (a2a and compressed), and a planted dropped ``wait`` caught.

(h) runs the CLI under ``python -m torch.distributed.run`` (rank 0 alone
prints, the one-process CLI's eigenvalues), and the CLI's refusals need
no launch.
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
}


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
                vectors=res.eigenvectors.shape)


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
    refused("sstep", lambda: _fd("RoadNet", ROADNET, ROADNET_TARGET, WORLD,
                                 1, True, "cpu", layout="stack",
                                 spmv_sstep=2), NotImplementedError)
    refused("auto", lambda: _fd("RoadNet", ROADNET, ROADNET_TARGET, WORLD, 1,
                                True, "cpu", layout="auto"),
            NotImplementedError)
    fd = _fd("RoadNet", ROADNET, ROADNET_TARGET, WORLD, 1, True, "cpu",
             layout="stack")
    refused("checkpoint", lambda: fd.set_counters(fd.counters()),
            NotImplementedError)
    return out


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
             proof=part_proof)


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
                pillar=float(w[0]) - 0.1)


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
    payload = dict(targets=targets, draws=draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
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
        while not ctx.join():
            pass
    finally:
        torch.set_num_threads(threads)
        ref_run.join()
    ref = dict(np.load(path))
    ref["draws_equal"] = all(np.array_equal(draws[k], ref[k])
                             for k in ("v0", "V0"))
    ranks = [torch.load(tmp / f"{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, one, ref


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
    """(i) A world size other than the grid's, the s-step filter,
    ``layout="auto"`` and a checkpoint's counters are refused on ranks,
    each naming why."""
    ranks, _, _ = run
    for r in ranks:
        out = r["refusals"]
        assert "one rank a shard" in out["world"]
        for key in ("sstep", "auto", "checkpoint"):
            assert out[key] and "later slice" in out[key], key


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
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))), "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
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
    (("--backend", "gloo", "--layout", "auto"), "later slice"),
    (("--backend", "gloo", "--spmv-sstep", "2"), "later slice"),
    (("--backend", "gloo", "--serve", "x.json"), "later slice"),
    (("--backend", "gloo", "--plan-cache", "p.json"), "later slice"),
    (("--backend", "nccl", "--share-card"), "NCCL refuses"),
    (("--share-card",), "needs --backend"),
], ids=["auto", "sstep", "serve", "plan-cache", "nccl-share-card",
        "share-card-alone"])
def test_cli_refuses_on_ranks(capsys, extra, match):
    """(i) The CLI refuses the options a rank launch does not take, before
    it starts a process group."""
    from repro_torch.launch import solve as cli

    with pytest.raises(SystemExit):
        cli.main(_cli_argv(extra))
    assert match in capsys.readouterr().err


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
