"""Static communication gate of the port (the counterpart of the
reference's ``scripts/check_comm.py``).

Proves, from pattern-only plans and from the ordered record of what the
engines issue (``core/shards.py::CommTrace``), that the communication
the port's engines carry out is exactly what the paper's χ model
predicts::

    python -m repro_torch.analysis.check_comm [--fast] [--device cuda|cpu]
        [--family spinchain|roadnet|hubnet ...] [--no-census]

It runs on the card unless ``--device cpu`` is given, and raises when
there is no card and ``--device cpu`` was not given. Sections:

  1. **plan lint** (:mod:`.plan_lint`): neighbour rounds are partial
     permutations covering every nonzero pair exactly once,
     H_matching <= H_cyclic, the RowMap embed/extract is a bijection,
     zero-halo plans collapse, and the ``SpmvCommPlan`` byte accounting is
     consistent — SpinChain (and, without ``--fast``, RoadNet/HubNet) at
     4 and 8 shards × {rows, commvol};
  1b. **s-step plan lint** (``lint_sstep``): the depth-s ghost plan covers
     the depth-1 halo and its whole-filter bytes are
     ``moved × (2·⌈n/s⌉ − 1) × n_b × S_d``; a depth-1 plan must be
     rejected (the non-vacuity control);
  1c. **sampled-plan lint** (``core/sketch.py``): the half-fraction
     sampled plan passes ``lint_sampled_plan``, its band holds the exact
     χ, its moved entries are within 20 % of the exact plan's, and the
     matrix-free build is bit-identical to the CSR build — all three
     families, in ``--fast`` too;
  2. **split-phase proof** (:mod:`.overlap_check`) of every engine combo,
     kernels off (and on, on the card), over the record of one SpMV: the
     split-phase engines pass (A) and (B), the plain ones must fail (B);
     the s-step filter's split-phase group passes, its plain group fails
     (B); an exchange started after the local blocks must fail (A);
  2b. **round-pipeline proof**: the pipelined compressed engines pass
     (a)–(c); ``pipeline=False`` must fail (c);
  2c. **kernel parity** (the card only): the kernelized engines equal the
     plain versions bit for bit;
  3. **collective census** (:mod:`.census`): engine cells run one FD
     macro-iteration with the record on, every collective attributed to a
     predicted term — zero unattributed, zero missing; ``+krn`` cells
     (the card only) against the same terms; ``+s2``/``+s3`` cells against
     ``sstep_collectives``;
  4b. **plan-cache lint** (``service/plan_cache.py``): a plan served from
     the cache equals the freshly planned one, RowMap arrays included, and
     the second fetch is a hit that never calls the planner;
  5. **linters**: the built-in unused-import scan and the import check
     (no module of the package imports jax or ``repro``) over
     ``src/repro_torch``, plus ``ruff``/``mypy`` when installed.

On the CPU the sections that need the card (2c, the ``+krn`` census
cells, the kernel-on proofs) are listed as not run, with the reason.
Ends with ``[check_comm] PASS`` (exit 0) or ``FAIL: n error(s)`` (1).
"""
from __future__ import annotations

import argparse
import ast
import os
import shutil
import subprocess
import sys

import numpy as np

#: the package the import scans cover
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: small instances of the three bench families (RoadNet ~ sparse
#: planar-ish, HubNet ~ hub-dominated); SpinChainXXZ is pattern-exact
ROADNET_SMALL = dict(n=4000, w=2, m=256, k=4)
HUBNET_SMALL = dict(n=4000, w=2, h=4, m=192, k=4)

#: the six SpMV engine combos: comm x schedule x split-phase
ENGINE_COMBOS = (
    ("a2a", "cyclic", False),
    ("a2a", "cyclic", True),
    ("compressed", "cyclic", False),
    ("compressed", "cyclic", True),
    ("compressed", "matching", False),
    ("compressed", "matching", True),
)

#: why the card-only parts do not run on the CPU
NO_CARD = "needs the card: the CUDA kernels have no CPU mode"


def log(msg: str) -> None:
    print(f"[check_comm] {msg}", flush=True)


def _families(fast: bool):
    from ..matrices import HubNet, RoadNet, SpinChainXXZ

    fams = [("SpinChainXXZ(10,5)", SpinChainXXZ(10, 5))]
    if not fast:
        fams.append(("RoadNet-small", RoadNet(**ROADNET_SMALL)))
        fams.append(("HubNet-small", HubNet(**HUBNET_SMALL)))
    return fams


def _status(errs) -> str:
    return "OK" if not errs else f"{len(errs)} error(s)"


def check_plan_invariants(fast: bool = False) -> list[str]:
    """Section 1: pattern-only lint of plans, schedules and row maps."""
    from .plan_lint import run_plan_lint

    errors: list[str] = []
    for name, matrix in _families(fast):
        errs = run_plan_lint(matrix, n_rows=(4, 8), label=f"{name}/")
        log(f"plan-lint {name}: {_status(errs)}")
        errors += [f"plan-lint: {e}" for e in errs]
    return errors


def check_sstep_plans(fast: bool = False) -> list[str]:
    """Section 1b: depth-s ghost-zone plan lint, with the depth-1 plan
    rejected as the non-vacuity control."""
    import warnings

    from ..core.partition import plan_rowmap
    from ..core.planner import comm_plan
    from .plan_lint import lint_comm_plan, lint_sstep

    errors: list[str] = []
    depths = (2,) if fast else (2, 3)
    for name, matrix in _families(fast):
        for P in ((4,) if fast else (4, 8)):
            cp1 = comm_plan(matrix, P, exact=True)
            for s in depths:
                cell = f"{name}/P{P}+s{s}"
                cps = comm_plan(matrix, P, sstep=s)
                errs = lint_sstep(cp1, cps, label=cell)
                errs += lint_comm_plan(cps, label=cell)
                # the planned partition at depth s: no stale-depth warning
                rm = plan_rowmap(matrix, P, balance="commvol", sstep=s)
                with warnings.catch_warnings():
                    warnings.simplefilter("error", UserWarning)
                    cps_m = comm_plan(matrix, P, rowmap=rm, sstep=s)
                cp1_m = comm_plan(matrix, P, rowmap=rm)
                errs += lint_sstep(cp1_m, cps_m, label=cell + "+cv")
                if not lint_sstep(cp1, cp1, label=cell):
                    errs.append(f"[{cell}] lint_sstep accepted a depth-1 "
                                f"plan — the linter is vacuous")
                log(f"sstep-lint {cell}: {_status(errs)}")
                errors += [f"sstep-lint: {e}" for e in errs]
    return errors


def check_sampled_plans(fast: bool = False) -> list[str]:
    """Section 1c: the sampled planner's plan, band and moved entries
    against the exact plan; the matrix-free build against the CSR one."""
    from ..core.planner import comm_plan
    from ..core.sketch import estimate_comm
    from ..core.spmv import build_dist_ell
    from ..matrices import HubNet, RoadNet, SpinChainXXZ
    from ..matrices.matfree import collect_row_entries
    from .plan_lint import _np, lint_sampled_plan

    del fast  # the estimator contract is cheap and load-bearing: always full
    SAMPLED_TOL = 0.2
    errors: list[str] = []
    fams = [("SpinChainXXZ(12,6)", SpinChainXXZ(12, 6)),
            ("RoadNet-small", RoadNet(**ROADNET_SMALL)),
            ("HubNet-small", HubNet(**HUBNET_SMALL))]
    for name, matrix in fams:
        errs: list[str] = []
        est = estimate_comm(matrix, 8, fraction=0.5, seed=0)
        cp_s = est.comm_plan()
        cp_e = comm_plan(matrix, 8, exact=True)
        errs += lint_sampled_plan(cp_s, band=est.band, label=name)
        if not est.band.contains(cp_e.chi):
            errs.append(f"[{name}] confidence band misses the exact χ")
        for engine, sched in (("a2a", "cyclic"), ("compressed", "cyclic"),
                              ("compressed", "matching")):
            m_s = cp_s.moved_entries_per_device(engine, sched)
            m_e = cp_e.moved_entries_per_device(engine, sched)
            if abs(m_s - m_e) > SAMPLED_TOL * max(m_e, 1):
                errs.append(f"[{name}] sampled {engine}/{sched} moves "
                            f"{m_s} entries/shard vs exact {m_e} "
                            f"(> {SAMPLED_TOL:.0%} off)")
        d_pad = -(-matrix.D // 8) * 8
        ell_mf = build_dist_ell(matrix, 8, d_pad=d_pad, device="cpu")
        ell_csr = build_dist_ell(matrix.build_csr(), 8, d_pad=d_pad,
                                 device="cpu")
        for field in ("cols", "vals", "send_idx", "pair_counts"):
            a, b = getattr(ell_mf, field), getattr(ell_csr, field)
            if not np.array_equal(_np(a), _np(b)):
                errs.append(f"[{name}] matfree build_dist_ell.{field} "
                            f"differs from the CSR build")
        rows = np.arange(matrix.D, dtype=np.int64)
        r1, c1, v1 = matrix.row_entries(rows)
        rw, cw, vw = collect_row_entries(matrix, rows, window=257)
        o1, ow = np.lexsort((c1, r1)), np.lexsort((cw, rw))
        if not (np.array_equal(r1[o1], rw[ow])
                and np.array_equal(c1[o1], cw[ow])
                and np.array_equal(v1[o1], vw[ow])):
            errs.append(f"[{name}] collect_row_entries(window=257) is not "
                        f"multiset-equal to the one-shot row_entries")
        log(f"sampled-plan {name}: {_status(errs)}")
        errors += [f"sampled-plan: {e}" for e in errs]
    return errors


class ProofOperator:
    """The operator of the proofs: ``matrix`` over ``P`` row shards of
    ``device``, with and without the split form (``ells[split]``), and a
    fresh input ``x [D_pad, n_b]`` (default: SpinChainXXZ(10,5) over the
    4 row shards of the reference's ``(4, 2)`` panel, n_b = 4)."""

    def __init__(self, device, matrix=None, P: int = 4, n_b: int = 4,
                 label: str = "SpinChainXXZ(10,5)"):
        import torch

        from ..core.spmv import build_dist_ell
        from ..matrices import SpinChainXXZ

        self.matrix = matrix if matrix is not None else SpinChainXXZ(10, 5)
        self.P, self.label, self.device = P, label, device
        self.D_pad = -(-self.matrix.D // (2 * P)) * (2 * P)
        self.ells = {split: build_dist_ell(self.matrix, P, d_pad=self.D_pad,
                                           split_halo=split, device=device)
                     for split in (False, True)}
        g = torch.Generator(device=device).manual_seed(7)
        self.x = torch.randn((self.D_pad, n_b), generator=g, device=device,
                             dtype=self.ells[False].vals.dtype)


def _record(fn, group, *args):
    """The record of one call ``fn(*args)`` on ``group``."""
    from ..core.shards import CommTrace

    trace = CommTrace().attach(group)
    try:
        fn(*args)
    finally:
        CommTrace.detach(group)
    return trace


def _dropped_wait_control(tag: str, check, fn, *args) -> list[str]:
    """The dropped-wait control: ``fn(*args)`` recorded with its group's
    ``wait`` dropped must fail ``check`` with a race (rule 1 alone would
    pass it)."""
    from .overlap_check import dropped_wait

    with dropped_wait(fn.group):
        rep = check(_record(fn, fn.group, *args))
    caught = any("race" in e or "never waited" in e for e in rep.errors)
    log(f"{tag.replace('[', ' ').rstrip(']')} dropped wait: "
        f"{'fails (race) as expected' if caught else 'UNEXPECTED PASS'}")
    return [] if caught else [f"{tag}: an engine that drops its wait "
                              f"passed — the race check is vacuous"]


def check_overlap(device, op: ProofOperator | None = None,
                  depths=(2, 3)) -> list[str]:
    """Section 2: the split-phase proof of every engine combo (kernels
    off, and on the card on) on ``op``, with the plain engines' (B)
    failure, the late start's (A) failure and the dropped wait's race as
    controls; the s-step groups at ``depths``, the overlapped ones with
    the dropped wait as control. The compressed split-phase engines run as the
    solver runs them, without the round pipeline (section 2b has it)."""
    from ..core.spmv import build_sstep_ell, make_spmv, make_sstep_cheb
    from .overlap_check import check_split_phase, dropped_wait, late_start

    on_card = device.type == "cuda"
    errors: list[str] = []
    op = op if op is not None else ProofOperator(device)
    ells, x = op.ells, op.x
    kernels = (False, True) if on_card else (False,)
    if not on_card:
        log(f"overlap +krn: not run ({NO_CARD})")
    for comm, schedule, overlap in ENGINE_COMBOS:
        for use_kernel in kernels:
            tag = (f"{op.label} {comm}/{schedule}{'+ov' if overlap else ''}"
                   f"{'+krn' if use_kernel else ''}")
            spmv = make_spmv(ells[overlap], use_kernel=use_kernel,
                             overlap=overlap, comm=comm, schedule=schedule,
                             pipeline=False)
            rep = check_split_phase(_record(spmv, spmv.group, x),
                                    real_side=on_card)
            if overlap:
                errors += [f"overlap[{tag}]: {e}" for e in rep.errors]
                log(f"overlap {tag}: {_status(rep.errors)} "
                    f"({rep.independent_contractions} hideable "
                    f"contraction(s))")
                with late_start(spmv.group):
                    late = check_split_phase(_record(spmv, spmv.group, x))
                if late.ok:
                    errors.append(f"overlap[{tag}]: an exchange started "
                                  f"after the local blocks passed (A) — the "
                                  f"checker is vacuous")
                log(f"overlap {tag} late start: "
                    f"{'fails (A) as expected' if not late.ok else 'UNEXPECTED PASS'}")
                errors += _dropped_wait_control(
                    f"overlap[{tag}]", check_split_phase, spmv, x)
            else:
                if rep.ok:
                    errors.append(f"overlap[{tag}]: plain engine "
                                  f"unexpectedly passed the split-phase "
                                  f"check — the checker is vacuous")
                log(f"overlap {tag}: "
                    f"{'fails (B) as expected' if not rep.ok else 'UNEXPECTED PASS'}")
    # the s-step filter: one group (a degree-s filter) on a fresh input
    for s in depths:
        for overlap in (False, True):
            sell = build_sstep_ell(op.matrix, op.P, s, d_pad=op.D_pad,
                                   split_halo=overlap, device=device)
            for use_kernel in kernels:
                tag = (f"{op.label} compressed/matching"
                       f"{'+ov' if overlap else ''}"
                       f"{'+krn' if use_kernel else ''}+s{s}")
                apply = make_sstep_cheb(sell, use_kernel=use_kernel,
                                        overlap=overlap, comm="compressed",
                                        schedule="matching")
                rep = check_split_phase(
                    _record(apply, apply.group, x, np.ones(s + 1), 0.3, 0.1),
                    real_side=on_card)
                if overlap:
                    errors += [f"overlap[{tag}]: {e}" for e in rep.errors]
                    log(f"overlap {tag}: {_status(rep.errors)}")
                    errors += _dropped_wait_control(
                        f"overlap[{tag}]", check_split_phase, apply, x,
                        np.ones(s + 1), 0.3, 0.1)
                else:
                    if rep.ok:
                        errors.append(f"overlap[{tag}]: plain s-step group "
                                      f"unexpectedly passed")
                    log(f"overlap {tag}: "
                        f"{'fails (B) as expected' if not rep.ok else 'UNEXPECTED PASS'}")
    return errors


def check_pipeline(device, op: ProofOperator | None = None) -> list[str]:
    """Section 2b: the prefix-chain proof of the pipelined compressed
    engines on ``op``, with ``pipeline=False`` as the failing control."""
    from ..core.spmv import make_spmv
    from .overlap_check import check_round_pipeline

    on_card = device.type == "cuda"
    errors: list[str] = []
    op = op if op is not None else ProofOperator(device)
    ells, x = op.ells, op.x
    for schedule in ("cyclic", "matching"):
        for use_kernel in ((False, True) if on_card else (False,)):
            tag = (f"{op.label} compressed/{schedule}+ov"
                   f"{'+krn' if use_kernel else ''}")
            for pipeline in (True, False):
                spmv = make_spmv(ells[True], use_kernel=use_kernel,
                                 overlap=True, comm="compressed",
                                 schedule=schedule, pipeline=pipeline)
                rep = check_round_pipeline(_record(spmv, spmv.group, x),
                                           real_side=on_card)
                if pipeline:
                    errors += [f"pipeline[{tag}]: {e}" for e in rep.errors]
                    log(f"pipeline {tag}: {_status(rep.errors)} "
                        f"({rep.n_rounds} round(s), prefixes "
                        f"{rep.prefix_lengths})")
                    errors += _dropped_wait_control(
                        f"pipeline[{tag}]", check_round_pipeline, spmv, x)
                else:
                    if rep.n_rounds >= 2 and rep.ok:
                        errors.append(f"pipeline[{tag}]: the unpipelined "
                                      f"control passed the prefix-chain "
                                      f"proof — the checker is vacuous")
                    log(f"pipeline {tag} control: "
                        f"{'fails (c) as expected' if not rep.ok else 'UNEXPECTED PASS'}")
    return errors


def check_kernel_parity(device, fast: bool = False) -> list[str]:
    """Section 2c (the card): the kernelized engines against the plain
    versions, bit for bit."""
    import torch

    from ..core.spmv import make_spmv

    if device.type != "cuda":
        log(f"kernel-parity: not run ({NO_CARD})")
        return []
    errors: list[str] = []
    op = ProofOperator(device)
    ells, x = op.ells, op.x
    combos = (ENGINE_COMBOS if not fast
              else (("a2a", "cyclic", False),
                    ("compressed", "matching", True)))
    for comm, schedule, overlap in combos:
        tag = f"{comm}/{schedule}{'+ov' if overlap else ''}"
        kw = dict(overlap=overlap, comm=comm, schedule=schedule)
        y = make_spmv(ells[overlap], **kw)(x)
        y_krn = make_spmv(ells[overlap], use_kernel=True, **kw)(x)
        biteq = bool(torch.equal(y, y_krn))
        if not biteq:
            errors.append(f"kernel-parity[{tag}]: the kernelized engine is "
                          f"not bit-identical to the plain one (max diff "
                          f"{float((y - y_krn).abs().max()):.3e})")
        log(f"kernel-parity {tag}: {'BITEQ' if biteq else 'MISMATCH'}")
    return errors


def census_grid(fast: bool) -> list:
    """``(layout, comm, schedule, overlap, balance, reorder, kernel,
    sstep)`` of the census cells: the reference's four ``--fast`` cells,
    or the full grid (6 combos × 3 layouts × 2 balances, kernels on and
    off on panel/rows, and three s-step cells)."""
    if fast:
        return [("panel", "a2a", "cyclic", False, "rows", "none", False, 1),
                ("panel", "compressed", "matching", True, "commvol", "rcm",
                 False, 1),
                ("panel", "compressed", "matching", True, "rows", "none",
                 True, 1),
                ("panel", "a2a", "cyclic", False, "rows", "none", False, 2)]
    grid = [(layout, comm, schedule, overlap, balance, "none", uk, 1)
            for layout in ("stack", "panel", "pillar")
            for comm, schedule, overlap in ENGINE_COMBOS
            for balance in ("rows", "commvol")
            for uk in ((False, True)
                       if layout == "panel" and balance == "rows"
                       else (False,))]
    grid += [("panel", "a2a", "cyclic", False, "rows", "none", False, 2),
             ("panel", "compressed", "matching", False, "rows", "none",
              False, 2),
             ("panel", "compressed", "cyclic", False, "commvol", "none",
              False, 3)]
    return grid


def check_census(device, fast: bool = False,
                 families=("spinchain",)) -> list[str]:
    """Section 3: the collective census over the engine grid."""
    from ..matrices import HubNet, RoadNet, SpinChainXXZ
    from .census import census_cell_tag, run_census_cell

    mats = {"spinchain": ("SpinChainXXZ(10,5)", SpinChainXXZ(10, 5)),
            "roadnet": ("RoadNet-small", RoadNet(**ROADNET_SMALL)),
            "hubnet": ("HubNet-small", HubNet(**HUBNET_SMALL))}
    if fast:
        families = ("spinchain",)
    errors: list[str] = []
    for fam in families:
        name, matrix = mats[fam]
        for (layout, comm, schedule, overlap, balance, reorder, uk,
             sstep) in census_grid(fast):
            if uk and device.type != "cuda":
                tag = census_cell_tag(layout, comm, schedule, overlap, uk,
                                      sstep, balance, reorder, 8)
                log(f"census {name} {tag}: not run ({NO_CARD})")
                continue
            rep = run_census_cell(matrix, P_total=8, layout=layout,
                                  comm=comm, schedule=schedule,
                                  overlap=overlap, use_kernel=uk,
                                  balance=balance, reorder=reorder,
                                  sstep=sstep, device=device)
            if uk and rep.launches == 0:
                rep.errors.append(f"[{rep.cell}] no kernel launched")
            log(f"census {name} {rep.cell}: {_status(rep.errors)}"
                + (f" ({rep.launches} launches)" if uk else ""))
            if not rep.ok:
                print(rep.describe(), flush=True)
            errors += [f"census[{name}]: {e}" for e in rep.errors]
    return errors


def check_plan_cache(fast: bool = False) -> list[str]:
    """Section 4b: a cached plan equals the freshly planned one, and the
    second fetch is a hit that never calls the planner."""
    import tempfile

    from ..matrices import HubNet, RoadNet, SpinChainXXZ
    from ..service.plan_cache import PlanCache, cached_plan_layout

    del fast  # the cache contract is cheap and load-bearing: always full
    errors: list[str] = []
    fams = [("SpinChainXXZ(10,5)", SpinChainXXZ(10, 5)),
            ("RoadNet-small", RoadNet(**ROADNET_SMALL)),
            ("HubNet-small", HubNet(**HUBNET_SMALL))]
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(os.path.join(tmp, "plans.json"))
        for name, matrix in fams:
            kw = dict(n_search=16, d_pad=-(-matrix.D // 8) * 8)
            fresh, hit0 = cached_plan_layout(matrix, 8, cache=cache, **kw)
            calls_before = cache.plan_calls
            cached, hit1 = cached_plan_layout(matrix, 8, cache=cache, **kw)
            errs: list[str] = []
            if hit0 or not hit1:
                errs.append(f"hit sequence (miss, hit) expected, got "
                            f"({hit0}, {hit1})")
            if cache.plan_calls != calls_before:
                errs.append("the hit path re-invoked plan_layout")
            if cached.candidates != fresh.candidates:
                errs.append("cached candidates differ from freshly planned")
            for c_f, c_c in zip(fresh.candidates, cached.candidates):
                if (c_f.rowmap is None) != (c_c.rowmap is None):
                    errs.append(f"rowmap presence differs in {c_f.layout}"
                                f"/{c_f.comm}")
                elif c_f.rowmap is not None and not (
                        np.array_equal(c_f.rowmap.perm, c_c.rowmap.perm)
                        and np.array_equal(c_f.rowmap.boundaries,
                                           c_c.rowmap.boundaries)):
                    errs.append(f"rowmap arrays differ in {c_f.layout}"
                                f"/{c_f.comm}/{c_f.balance}")
            if cached.best != fresh.best:
                errs.append("cached plan selects a different engine cell")
            log(f"plan-cache {name}: {_status(errs)}")
            errors += [f"plan-cache[{name}]: {e}" for e in errs]
    return errors


def _unused_imports(path: str) -> list[str]:
    """Built-in F401-style scan: imported top-level names never used.

    Skips ``__future__`` imports, ``# noqa`` lines, and names re-exported
    via ``__all__`` (the ``__init__.py`` pattern)."""
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    lines = src.splitlines()
    exported: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    try:
                        exported = set(ast.literal_eval(node.value))
                    except ValueError:
                        pass
    imported: dict = {}  # name -> lineno
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                imported[a.asname or a.name.split(".")[0]] = node.lineno
        elif isinstance(node, ast.Import):
            for a in node.names:
                imported[a.asname or a.name.split(".")[0]] = node.lineno
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    out = []
    for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
        if name in used or name in exported or name == "*":
            continue
        if "noqa" in lines[lineno - 1]:
            continue
        out.append(f"{path}:{lineno}: unused import {name!r}")
    return out


def _foreign_imports(path: str) -> list[str]:
    """Absolute imports of jax, jaxlib or the JAX package ``repro``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                out.append(f"{path}:{node.lineno}: imports {n!r}")
    return out


def check_linters() -> list[str]:
    """Section 5: ruff/mypy when installed, the built-in import scans."""
    errors: list[str] = []
    for tool, args in (("ruff", ["check", PKG]), ("mypy", [PKG])):
        exe = shutil.which(tool)
        if exe is None:
            log(f"{tool}: not installed (skipped)")
            continue
        proc = subprocess.run([exe] + args, cwd=os.path.dirname(PKG),
                              capture_output=True, text=True)
        ok = proc.returncode == 0
        log(f"{tool}: {'OK' if ok else 'FAILED'}")
        if not ok:
            tail = (proc.stdout + proc.stderr).strip().splitlines()
            errors += [f"{tool}: {line}" for line in tail[:20]]
    unused: list[str] = []
    foreign: list[str] = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                unused += _unused_imports(path)
                foreign += _foreign_imports(path)
    log(f"import-scan: "
        f"{'OK' if not unused else f'{len(unused)} unused import(s)'}")
    log(f"no-jax scan: "
        f"{'OK' if not foreign else f'{len(foreign)} import(s) of jax/repro'}")
    return errors + unused + foreign


def run_all(device, fast: bool = False, census: bool = True,
            families=("spinchain",)) -> list[str]:
    errors = check_plan_invariants(fast)
    errors += check_sstep_plans(fast)
    errors += check_sampled_plans(fast)
    errors += check_overlap(device)
    errors += check_pipeline(device)
    errors += check_kernel_parity(device, fast)
    if census:
        errors += check_census(device, fast, families)
    errors += check_plan_cache(fast)
    errors += check_linters()
    return errors


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="small subset: SpinChain-only lint (incl. one s=2 "
                         "s-step plan cell), every proof, four census cells "
                         "(incl. one +s2 and one +krn); the sampled-plan and "
                         "plan-cache lints still cover all three families")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the engines run (default: the card; raises "
                         "without one)")
    ap.add_argument("--no-census", action="store_true",
                    help="skip the collective census")
    ap.add_argument("--family", action="append", default=None,
                    choices=["spinchain", "roadnet", "hubnet"],
                    help="census families (full mode; default spinchain; "
                         "repeatable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    errors = run_all(device, fast=args.fast, census=not args.no_census,
                     families=tuple(args.family or ("spinchain",)))
    for e in errors:
        log(f"ERROR: {e}")
    log("PASS" if not errors else f"FAIL: {len(errors)} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
