"""The port's static communication checks (``repro_torch.analysis``) on
the CPU: the plan linter against the JAX package's on the same plans,
clean and with planted defects (identical error lists); the split-phase
and round-pipeline proofs over the ordered record (``CommTrace``) of
every engine, with their negative controls; the record changing nothing
of what it records; and the gate, ``python -m
repro_torch.analysis.check_comm --fast --device cpu``.

The reference's jaxpr proofs cannot run under the installed jax
(``overlap_check.py:122`` reads ``jax.core.Literal``, which jax 0.9.0
removed), so the port's proofs are held to the dependence structure the
reference's docstrings state, each against its negative control.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.analysis import plan_lint as jlint
from repro.core import partition as jpartition
from repro.core import planner as jplanner
from repro.core import sketch as jsketch
from repro.core import spmv as jspmv
from repro.matrices import HubNet as JHubNet
from repro.matrices import RoadNet as JRoadNet
from repro.matrices import SpinChainXXZ as JSpinChainXXZ

from repro_torch.analysis import (CommTrace, ExpectedTerm, attribute,
                                  check_round_pipeline, check_split_phase,
                                  dropped_wait, late_start, plan_lint)
from repro_torch.analysis.census import CollectiveOp
from repro_torch.core import (FDConfig, FilterDiag, build_dist_ell,
                              build_sstep_ell, chebyshev_filter,
                              make_fused_cheb_step, make_spmv,
                              make_sstep_cheb)
from repro_torch.core import partition, planner, sketch
from repro_torch.core.shards import byte_ranges
from repro_torch.matrices import HubNet, RoadNet, SpinChainXXZ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROADNET_SMALL = dict(n=4000, w=2, m=256, k=4)
HUBNET_SMALL = dict(n=4000, w=2, h=4, m=192, k=4)
FAMILIES = {
    "spinchain": (lambda: JSpinChainXXZ(10, 5), lambda: SpinChainXXZ(10, 5)),
    "roadnet": (lambda: JRoadNet(**ROADNET_SMALL),
                lambda: RoadNet(**ROADNET_SMALL)),
    "hubnet": (lambda: JHubNet(**HUBNET_SMALL),
               lambda: HubNet(**HUBNET_SMALL)),
}
#: the six SpMV engine combos: comm x schedule x split-phase
COMBOS = [("a2a", "cyclic", False), ("a2a", "cyclic", True),
          ("compressed", "cyclic", False), ("compressed", "cyclic", True),
          ("compressed", "matching", False), ("compressed", "matching", True)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ plan lint --

@pytest.mark.parametrize("balance", ["rows", "commvol"])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_lint_clean_matches_reference(family, P, balance):
    """``run_plan_lint`` (comm plans, schedules, byte accounting, row
    maps) gives the reference's error list, empty, on each family."""
    jm, tm = (f() for f in FAMILIES[family])
    want = jlint.run_plan_lint(jm, n_rows=(P,), balances=(balance,),
                               label=family)
    got = plan_lint.run_plan_lint(tm, n_rows=(P,), balances=(balance,),
                                  label=family)
    assert got == want == []


def _planted_rounds():
    pc = np.zeros((4, 4), dtype=np.int64)
    pc[0, 1], pc[2, 3], pc[1, 0], pc[3, 2] = 3, 2, 2, 1
    full = (((0, 1), (2, 3)), ((1, 0), (3, 2)))
    return {
        # a pair scheduled twice
        "double-sent": (pc, full + (((0, 1),),), (3, 2, 3), "double-sent"),
        # pair (3 -> 2) in no round
        "dropped": (pc, (((0, 1), (2, 3)), ((1, 0),)), (3, 2),
                    "scheduled in no round"),
        # round 0 padded below its largest pair
        "short pad": (pc, full, (2, 2), "truncated send"),
        # a self-send and two sources into one receiver
        "self-send": (pc, (((0, 1), (2, 1), (3, 3)),) + full[1:], (3, 2),
                      "self-send"),
    }


@pytest.mark.parametrize("case", ["double-sent", "dropped", "short pad",
                                  "self-send"])
def test_lint_rounds_planted_matches_reference(case):
    pc, perms, round_L, needle = _planted_rounds()[case]
    want = jlint.lint_rounds(pc, perms, round_L, label=case)
    got = plan_lint.lint_rounds(pc, perms, round_L, label=case)
    assert got == want
    assert any(needle in e for e in got), got


def test_lint_rowmap_non_bijective_matches_reference():
    """A row map whose perm repeats a row: not a permutation, not a
    bijection, in both linters alike."""
    D, P, R = 10, 2, 5
    perm = np.arange(D, dtype=np.int64)
    perm[3] = 4  # row 3 lost, row 4 twice
    fields = dict(D=D, P=P, balance="commvol", reorder="none", perm=perm,
                  boundaries=np.array([0, 5, 10], dtype=np.int64), R=R)
    want = jlint.lint_rowmap(jpartition.RowMap(**fields), label="rm")
    got = plan_lint.lint_rowmap(partition.RowMap(**fields), label="rm")
    assert got == want
    assert any("not a permutation" in e for e in got), got
    assert any("bijection" in e for e in got), got


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lint_sstep_matches_reference_and_rejects_depth1(family):
    """The depth-2 plan lints clean in both; a depth-1 plan passed as the
    depth-s one is rejected by both with the same message."""
    jm, tm = (f() for f in FAMILIES[family])
    j1, js = (jplanner.comm_plan(jm, 4, exact=True),
              jplanner.comm_plan(jm, 4, sstep=2))
    t1, ts = (planner.comm_plan(tm, 4, exact=True),
              planner.comm_plan(tm, 4, sstep=2))
    assert plan_lint.lint_sstep(t1, ts, label=family) == \
        jlint.lint_sstep(j1, js, label=family) == []
    bad = plan_lint.lint_sstep(t1, t1, label=family)
    assert bad == jlint.lint_sstep(j1, j1, label=family)
    assert bad and "depth-1" in bad[0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lint_comm_plan_planted_matches_reference(family):
    """A plan whose ``n_vc`` disagrees with its pair counts, and one whose
    ``L`` is off by one: the same errors from both linters."""
    jm, tm = (f() for f in FAMILIES[family])
    jcp = jplanner.comm_plan(jm, 8, exact=True)
    tcp = planner.comm_plan(tm, 8, exact=True)
    for change in (dict(n_vc=np.asarray(jcp.n_vc) + 1), dict(L=jcp.L + 1)):
        want = jlint.lint_comm_plan(dataclasses.replace(jcp, **change),
                                    label=family)
        got = plan_lint.lint_comm_plan(dataclasses.replace(tcp, **change),
                                       label=family)
        assert got == want
        assert got


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lint_dist_ell_matches_reference(family):
    """The built operators' engine schedules lint clean in both; a send
    index outside the local row block is flagged by both alike."""
    jm, tm = (f() for f in FAMILIES[family])
    d_pad = -(-jm.D // 8) * 8
    jell = jspmv.build_dist_ell(jm, 8, d_pad=d_pad)
    tell = build_dist_ell(tm, 8, d_pad=d_pad, device="cpu")
    assert plan_lint.lint_dist_ell(tell, label=family) == \
        jlint.lint_dist_ell(jell, label=family) == []
    send = np.array(jell.send_idx)
    send.reshape(-1)[0] = jell.R
    want = jlint.lint_dist_ell(dataclasses.replace(jell, send_idx=send),
                               label=family)
    got = plan_lint.lint_dist_ell(
        dataclasses.replace(tell, send_idx=torch.as_tensor(send)),
        label=family)
    assert got == want
    assert any("send_idx outside the local row block" in e for e in got), got


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lint_sampled_plan_matches_reference(family):
    jm, tm = (f() for f in FAMILIES[family])
    jest = jsketch.estimate_comm(jm, 8, fraction=0.5, seed=0)
    test_ = sketch.estimate_comm(tm, 8, fraction=0.5, seed=0)
    want = jlint.lint_sampled_plan(jest.comm_plan(), band=jest.band,
                                   label=family)
    got = plan_lint.lint_sampled_plan(test_.comm_plan(), band=test_.band,
                                      label=family)
    assert got == want == []
    # a sampled plan marked exact is refused by both
    assert plan_lint.lint_sampled_plan(
        dataclasses.replace(test_.comm_plan(), exact=True), label=family) \
        == jlint.lint_sampled_plan(
            dataclasses.replace(jest.comm_plan(), exact=True), label=family)


# --------------------------------------------- census attribution cases --

def _op(kind, nbytes, mult, name="op"):
    return CollectiveOp(kind=kind, bytes=nbytes, mult=mult, name=name,
                        computation="main")


def test_attribute_flags_spurious_and_missing():
    expected = [ExpectedTerm("halo", "all-to-all", 7680, 6),
                ExpectedTerm("gram", "all-reduce", 512, 1)]
    ok = attribute([_op("all-to-all", 7680, 6.0), _op("all-reduce", 512, 1.0)],
                   expected, cell="cell")
    assert ok.ok, ok.errors
    bad = attribute([_op("all-to-all", 7680, 5.0), _op("all-reduce", 512, 1.0),
                     _op("all-gather", 2048, 1.0, name="all-gather.1")],
                    expected, cell="cell")
    assert not bad.ok
    assert any("unattributed" in e and "all-gather" in e for e in bad.errors)
    assert any("missing collective" in e and "halo" in e for e in bad.errors)


def test_attribute_accepts_alt_bytes():
    term = ExpectedTerm("redist", "all-to-all", 2048, 2, alt_bytes=(1024,))
    assert attribute([_op("all-to-all", 1024, 2.0)], [term]).ok
    assert attribute([_op("all-to-all", 2048, 2.0)], [term]).ok
    assert not attribute([_op("all-to-all", 512, 2.0)], [term]).ok


# ------------------------------------------------------------- the record --

def test_byte_ranges_keep_column_blocks_apart():
    """``xfull[:, :R]`` and ``xfull[:, R:]`` of one block do not alias;
    each overlaps the whole block; a view's ranges lie inside it."""
    from repro_torch.analysis.overlap_check import _by_storage, _overlap

    xfull = torch.zeros((4, 10, 3))
    a, b = byte_ranges(xfull[:, :6]), byte_ranges(xfull[:, 6:])
    assert len(a) == len(b) == 4
    assert not _overlap(_by_storage(a), _by_storage(b))
    whole = _by_storage(byte_ranges(xfull))
    assert _overlap(whole, _by_storage(a)) and _overlap(whole, _by_storage(b))
    assert byte_ranges(xfull[:, :0]) == ()
    col = byte_ranges(torch.zeros((5, 8), dtype=torch.float64)[:, 2:4])
    assert [(s, e) for _, s, e in col] == [(8 * (8 * i + 2), 8 * (8 * i + 4))
                                           for i in range(5)]


def _spin_ell(P=4, split=False):
    m = SpinChainXXZ(10, 5)
    return build_dist_ell(m, P, d_pad=-(-m.D // 8) * 8, split_halo=split,
                          device="cpu")


def _x(ell, nb=4, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (ell.D_pad, nb)))


def test_record_changes_nothing_of_a_filter():
    """A degree-6 filter through the compressed split-phase engine, and an
    s = 3 filter, with a trace attached: the bits, ``bytes`` and
    ``calls`` of the same filter without one, and the trace's totals are
    those counters."""
    m = SpinChainXXZ(10, 5)
    ell = _spin_ell(split=True)
    V = _x(ell)
    mu = np.linspace(1.0, 0.4, 7)
    sell = build_sstep_ell(m, 4, 3, d_pad=ell.D_pad, split_halo=True,
                           device="cpu")
    runs = {}
    for traced in (False, True):
        step = make_fused_cheb_step(ell, overlap=True, comm="compressed",
                                    schedule="matching")
        spmv = make_spmv(ell, group=step.group, overlap=True,
                         comm="compressed", schedule="matching")
        cheb = make_sstep_cheb(sell, overlap=True, comm="compressed",
                               schedule="cyclic")
        trace = CommTrace()
        if traced:
            trace.attach(step.group).attach(cheb.group)
        Y = chebyshev_filter(spmv, mu, 0.3, -0.1, V, fused_step=step)
        Ys = cheb(V, mu, 0.3, -0.1)
        runs[traced] = (Y, Ys, dict(step.group.bytes),
                        dict(step.group.calls), dict(cheb.group.bytes),
                        dict(cheb.group.calls), trace)
    (Y0, Ys0, *c0, _), (Y1, Ys1, *c1, trace) = runs[False], runs[True]
    assert torch.equal(Y0, Y1) and torch.equal(Ys0, Ys1)
    assert c0 == c1
    # the record's collectives are the groups' counters over its span
    for kind, calls in c1[1].items():
        mine = [e for e in trace.entries if e.kind == kind]
        assert (sum(e.n_bytes for e in mine), len(mine)) == (
            c1[0][kind] + c1[2][kind], calls + c1[3][kind])
    kinds = {e.kind for e in trace.entries}
    assert {"ppermute", "start", "wait", "contract", "copy"} <= kinds


def test_record_changes_nothing_of_a_solve():
    """A short FD solve (SpinChainXXZ(10,5), panel 2 × 2, compressed
    split-phase) with a trace on both groups: the eigenvalues, residuals,
    iterations and counters of the solve without one."""
    cfg = FDConfig(n_target=4, n_search=16, target=-0.15, tol=1e-8,
                   max_iters=3, layout="panel", spmv_overlap=True,
                   spmv_comm="compressed", seed=7)
    out = {}
    for traced in (False, True):
        fd = FilterDiag(SpinChainXXZ(10, 5), cfg, device="cpu", n_row=2,
                        n_col=2)
        trace = CommTrace()
        if traced:
            trace.attach(fd.grid)
        res = fd.solve()
        out[traced] = (res, fd.counters(), trace)
    (r0, k0, _), (r1, k1, trace) = out[False], out[True]
    assert np.array_equal(r0.eigenvalues, r1.eigenvalues)
    assert np.array_equal(r0.residuals, r1.residuals)
    assert (r0.iterations, r0.total_spmvs) == (r1.iterations, r1.total_spmvs)
    assert k0 == k1
    labels = {e.label for e in trace.entries}
    assert {"gram", "tsqr[0]", "redistribute[to_panel]",
            "redistribute[to_stack]"} <= labels
    assert {e.group for e in trace.entries} == {"stack", "panel"}


# -------------------------------------------------------------- the proofs --

@pytest.mark.parametrize("comm,schedule,overlap", COMBOS)
def test_split_phase_proof(comm, schedule, overlap):
    """Each split-phase engine passes (A) and (B) on the record of one
    SpMV; each plain engine fails (B), the checker's control."""
    ell = _spin_ell(split=overlap)
    spmv = make_spmv(ell, overlap=overlap, comm=comm, schedule=schedule,
                     pipeline=False)
    trace = CommTrace().attach(spmv.group)
    spmv(_x(ell))
    rep = check_split_phase(trace)
    assert rep.collectives, rep.describe()
    if overlap:
        assert rep.ok, rep.describe()
        assert rep.independent_contractions >= 1
        assert all(e.stream == "side" for e in trace.entries
                   if e.kind in ("all_to_all", "ppermute"))
    else:
        assert not rep.ok
        assert any("no contraction is independent" in e for e in rep.errors)
        assert all(e.stream == "main" for e in trace.entries)


@pytest.mark.parametrize("comm,schedule,pipeline",
                         [("a2a", "cyclic", False),
                          ("compressed", "cyclic", False),
                          ("compressed", "cyclic", True),
                          ("compressed", "matching", True)])
def test_late_start_fails_condition_a(comm, schedule, pipeline):
    """An exchange started after the local blocks were enqueued waits for
    them (the side stream waits for the main one): (A) fails, naming the
    local contraction; the same engine started on time passes."""
    ell = _spin_ell(split=True)
    spmv = make_spmv(ell, overlap=True, comm=comm, schedule=schedule,
                     pipeline=pipeline)
    x = _x(ell)
    want = spmv(x)
    trace = CommTrace().attach(spmv.group)
    with late_start(spmv.group):
        got = spmv(x)
    assert torch.equal(got, want)  # the same values, only the order moved
    rep = check_split_phase(trace)
    assert not rep.ok
    assert any("depends on contraction(s) ['local'" in e for e in rep.errors)
    trace.clear()
    spmv(x)
    assert check_split_phase(trace).ok


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("s", [2, 3])
def test_sstep_group_proof(s, overlap):
    """One group of the s-step filter (a degree-s filter) on a fresh
    input: the split-phase group passes (A) and (B), the plain one fails
    (B) — its step-0 block reads the ghosts the exchange delivered."""
    m = SpinChainXXZ(10, 5)
    sell = build_sstep_ell(m, 4, s, d_pad=-(-m.D // 8) * 8,
                           split_halo=overlap, device="cpu")
    apply = make_sstep_cheb(sell, overlap=overlap, comm="compressed",
                            schedule="matching")
    trace = CommTrace().attach(apply.group)
    apply(_x(sell), np.ones(s + 1), 0.3, 0.1)
    assert sum(e.kind == "ppermute" for e in trace.entries) == len(
        sell.neighbor_plan("matching").round_L)
    rep = check_split_phase(trace)
    assert rep.ok == overlap, rep.describe()
    if not overlap:
        assert any("no contraction is independent" in e for e in rep.errors)


@pytest.mark.parametrize("schedule", ["cyclic", "matching"])
def test_round_pipeline_proof(schedule):
    """The pipelined compressed engine passes (a)–(c), prefix lengths 0,
    a strict one and n witnessed; ``pipeline=False`` fails (c) with only
    {0, n}."""
    ell = _spin_ell(split=True)
    x = _x(ell)
    reps = {}
    for pipeline in (True, False):
        spmv = make_spmv(ell, overlap=True, comm="compressed",
                         schedule=schedule, pipeline=pipeline)
        trace = CommTrace().attach(spmv.group)
        spmv(x)
        reps[pipeline] = check_round_pipeline(trace)
    rep, flat = reps[True], reps[False]
    assert rep.ok, rep.describe()
    assert rep.n_rounds >= 2
    assert 0 in rep.prefix_lengths and rep.n_rounds in rep.prefix_lengths
    assert any(0 < k < rep.n_rounds for k in rep.prefix_lengths)
    assert not flat.ok
    assert flat.prefix_lengths == [0, flat.n_rounds]
    assert any("not round-pipelined" in e for e in flat.errors)


def test_round_pipeline_catches_an_out_of_order_dependence():
    """A planted record in which a contraction reads round 2's slice of
    the receive buffer without round 1's: not a prefix of the chain."""
    from repro_torch.core import ShardGroup

    g = ShardGroup(2, "cpu")
    trace = CommTrace().attach(g)
    x, halo = torch.zeros((4, 2)), torch.zeros((2, 6, 2))
    rows = torch.zeros((2, 3), dtype=torch.int64)
    pends = [g.start(lambda k=k: g.gather_ppermute(
        x, rows, ((0, 1), (1, 0)), key=k, out=halo[:, 3 * k:3 * k + 3]))
        for k in range(2)]
    g.contraction("local", reads=(x,), writes=(torch.zeros(4, 2),))
    g.contraction("round[1]", reads=(halo[:, 3:],),
                  writes=(torch.zeros(4, 2),))
    for p in pends:
        g.wait(p)
    rep = check_round_pipeline(trace)
    assert any("not a prefix" in e for e in rep.errors), rep.describe()


def _is_race(e: str) -> bool:
    return "before its wait: a race" in e or "never waited" in e


@pytest.mark.parametrize("engine", [
    "a2a/cyclic", "compressed/cyclic", "compressed/matching",
    "compressed/cyclic+pipeline", "compressed/matching+pipeline",
    "sstep2", "sstep3"])
def test_dropped_wait_is_a_race(engine):
    """An engine that drops its ``wait``: rule 1 still orders its halo
    contraction after the exchange, so (A), (B) and (a)–(c) pass, but the
    record shows a main-stream read of the exchange's ranges before any
    wait and a start never waited — a race on the card. The same engine
    with its waits passes."""
    m = SpinChainXXZ(10, 5)
    if engine.startswith("sstep"):
        s = int(engine[-1])
        op = build_sstep_ell(m, 4, s, d_pad=-(-m.D // 8) * 8,
                             split_halo=True, device="cpu")
        fn = make_sstep_cheb(op, overlap=True, comm="compressed",
                             schedule="matching")
        args = (np.ones(s + 1), 0.3, 0.1)
    else:
        comm, rest = engine.split("/")
        schedule, _, pipe = rest.partition("+")
        op = _spin_ell(split=True)
        fn = make_spmv(op, overlap=True, comm=comm, schedule=schedule,
                       pipeline=bool(pipe))
        args = ()
    check = (check_round_pipeline if engine.endswith("pipeline")
             else check_split_phase)
    x = _x(op)
    trace = CommTrace().attach(fn.group)
    with dropped_wait(fn.group):
        fn(x, *args)
    rep = check(trace)
    assert not rep.ok
    assert all(_is_race(e) for e in rep.errors), rep.describe()
    assert any("never waited" in e for e in rep.errors)
    assert any("before its wait: a race" in e for e in rep.errors)
    assert not any(e.kind == "wait" for e in trace.entries)
    trace.clear()
    fn(x, *args)
    assert check(trace).ok, check(trace).describe()


def test_race_check_reads_ranges_not_storages():
    """A planted record: before the wait, a main-stream op that reads what
    an exchange reads and writes the other half of its receive block is
    no race, one that writes the exchange's half is; after the wait
    nothing is, and the start stops being unwaited."""
    from repro_torch.analysis.overlap_check import race_errors
    from repro_torch.core import ShardGroup

    g = ShardGroup(2, "cpu")
    trace = CommTrace().attach(g)
    x, buf = torch.zeros((4, 2)), torch.zeros((2, 4, 2))
    rows = torch.zeros((2, 2), dtype=torch.int64)
    pend = g.start(lambda: g.gather_ppermute(
        x, rows, ((0, 1), (1, 0)), key=0, out=buf[:, 2:]), "halo")
    g.contraction("local", reads=(x,), writes=(buf[:, :2],))
    errs = race_errors(trace)
    assert len(errs) == 1 and "never waited" in errs[0], errs
    g.contraction("clobber", reads=(), writes=(buf[:, 3:],))
    errs = race_errors(trace)
    assert len(errs) == 2 and "never waited" in errs[0], errs
    assert "clobber" in errs[1] and "halo-round[0]" in errs[1], errs
    g.wait(pend)
    g.contraction("halo", reads=(buf,), writes=(x,))
    errs = race_errors(trace)
    assert len(errs) == 1 and "clobber" in errs[0], errs


# ---------------------------------------------------------------- the gate --

def _gate(*args, timeout=300, **env_extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env_extra)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.analysis.check_comm", *args],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=timeout)
    return r, time.perf_counter() - t0


def test_check_comm_fast_gate_on_the_cpu():
    """The fast gate passes on the CPU in under 120 s and lists the parts
    that need the card as not run, never as passed."""
    r, seconds = _gate("--fast", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[check_comm] PASS"
    assert seconds < 120
    assert "kernel-parity: not run (needs the card" in r.stdout
    assert "+krn/rows+none/P8: not run (needs the card" in r.stdout
    assert "BITEQ" not in r.stdout
    for needle in ("plan-lint SpinChainXXZ(10,5): OK",
                   "sampled-plan HubNet-small: OK",
                   "a2a/cyclic+ov late start: fails (A) as expected",
                   "compressed/matching+ov control: fails (c) as expected",
                   "census SpinChainXXZ(10,5) panel/a2a-cyclic+s2",
                   "plan-cache RoadNet-small: OK", "no-jax scan: OK"):
        assert needle in r.stdout, needle


def test_check_comm_without_a_card_raises():
    """Without ``--device cpu`` the gate targets the card, and with none
    (none visible here) it raises before it checks anything."""
    r, _ = _gate("--fast", timeout=120, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "[check_comm]" not in r.stdout
