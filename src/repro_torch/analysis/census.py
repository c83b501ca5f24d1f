"""Collective census: run one FD macro-iteration with a
:class:`~repro_torch.core.shards.CommTrace` attached and attribute every
collective it issued to a predicted term (the port's counterpart of
``repro/analysis/census.py``).

The paper's point is that the communication structure of the solver is
known from the sparsity pattern *before running any code*; this pass
holds the port's engines to that claim. The reference compiles its cell
and reads the collectives of the optimized HLO; the port cannot compile
without running, so a cell *executes* one macro-iteration — TSQR in the
stack layout, the redistribution to the filter layout, a degree-``n``
Chebyshev filter through the cell's halo engine, the redistribution
back, and a Gram all-reduce — from a :class:`~repro_torch.core.
filter_diag.FilterDiag`'s own bound pieces (``orthogonalize``,
``to_panel``, ``_filter_bundles``, ``to_stack``, ``gram``), so the census
checks what a solve runs. :func:`measured` turns the record into the
reference's per-device ``(kind, operand bytes, multiplicity)`` multiset,
in its HLO names, and :func:`attribute` matches it against the terms of
:func:`expected_census`, exact in both directions:

* a group counts a collective's bytes summed over its shards, the
  reference per device: an entry of a group of ``P`` shards is
  ``n_bytes / P`` per device;
* a panel's bundles run one after another on the panel group of
  ``N_row`` shards, so each of its entries is executed by ``N_row`` of
  the ``P_total`` devices: multiplicity ``N_row / P_total``, and the
  filter's ``N_col`` passes add up to the reference's count;
* the redistribution counts the off-device bytes (the term's ``moved``
  size, which it admits beside ``full``); at ``N_col = 1`` it is a view
  and counts nothing, and the reference has no term there either;
* pillar has ``N_row = 1``: no halo term;
* an s-step filter ships one single-width seed exchange, then
  width-doubled ones (``SpmvCommPlan.sstep_collectives``);
* the TSQR butterfly's ``ppermute`` is one ``[P, N_s, N_s]`` segment a
  level, ``N_s·N_s·S`` per device.

Any measured collective not covered by a term — a spurious all-reduce,
say — is an *unattributed collective* error; any term the record does
not realize is a *missing collective* error.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["ExpectedTerm", "CensusReport", "CollectiveOp", "HLO_KINDS",
           "attribute", "expected_census", "measured", "census_of",
           "macro_iteration",
           "extra_psum", "skip_gram", "run_census_cell", "census_cell_tag"]

_TOL = 1e-6

#: The reference's HLO name of each of the port's collective kinds.
HLO_KINDS = {"all_to_all": "all-to-all", "ppermute": "collective-permute",
             "psum": "all-reduce", "redistribute": "all-to-all"}


@dataclasses.dataclass(frozen=True)
class ExpectedTerm:
    """One predicted collective term: ``count`` executions of ``kind``
    with ``bytes`` operand bytes each. ``alt_bytes`` lists other operand
    sizes the same op may legally print (dialect differences such as
    full-slice vs moved-only all-to-all operands)."""

    label: str
    kind: str
    bytes: int
    count: float
    alt_bytes: tuple = ()


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One measured collective per device, in the reference's terms:
    ``bytes`` the operand of one execution, ``mult`` the executions per
    device, ``name`` the call site's label, ``computation`` the group."""

    kind: str
    bytes: int
    mult: float
    name: str
    computation: str


@dataclasses.dataclass
class CensusReport:
    """Attribution of a cell's collectives to predicted terms;
    ``launches`` counts the kernel launches of its contractions."""

    cell: str
    expected: list  # [ExpectedTerm]
    measured: list  # [CollectiveOp]
    errors: list
    launches: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors

    def describe(self) -> str:
        lines = [f"census[{self.cell}]: "
                 f"{'OK' if self.ok else f'{len(self.errors)} error(s)'}"]
        lines.append("  predicted:")
        for t in self.expected:
            lines.append(f"    {t.label:<28s} {t.count:g} x "
                         f"{t.kind}({t.bytes}B)")
        lines.append("  measured:")
        agg: dict = {}
        for c in self.measured:
            agg[(c.kind, c.bytes)] = agg.get((c.kind, c.bytes), 0.0) + c.mult
        for (kind, b), m in sorted(agg.items()):
            lines.append(f"    {m:g} x {kind}({b}B)")
        lines += [f"  ERROR: {e}" for e in self.errors]
        return "\n".join(lines)


def attribute(measured, expected, cell: str = "",
              extra_errors=()) -> CensusReport:
    """Match the measured collective multiset against the predicted terms
    — exact in both directions. Terms and ops are aggregated by
    (kind, bytes-per-op), so byte-size collisions between terms simply
    add their counts; ``alt_bytes`` sizes are tried once the primary
    size is exhausted."""
    errors = list(extra_errors)
    meas_mult: dict = {}
    meas_names: dict = {}
    for c in measured:
        key = (c.kind, c.bytes)
        meas_mult[key] = meas_mult.get(key, 0.0) + c.mult
        meas_names.setdefault(key, []).append(c.name)
    remaining = dict(meas_mult)
    for t in expected:
        need = float(t.count)
        for b in (t.bytes,) + tuple(t.alt_bytes):
            key = (t.kind, int(b))
            take = min(need, remaining.get(key, 0.0))
            if take > 0:
                remaining[key] -= take
                need -= take
            if need <= _TOL:
                break
        if need > _TOL:
            errors.append(
                f"[{cell}] missing collective: predicted term {t.label!r} "
                f"({t.count:g} x {t.kind}({t.bytes}B)) is short by "
                f"{need:g} in the record")
    for (kind, b), mult in sorted(remaining.items()):
        if mult > _TOL:
            names = ", ".join(meas_names[(kind, b)][:4])
            errors.append(
                f"[{cell}] unattributed collective: {mult:g} x "
                f"{kind}({b}B) matches no predicted term (ops: {names})")
    return CensusReport(cell=cell, expected=list(expected),
                        measured=list(measured), errors=errors)


def expected_census(cp, *, comm: str, schedule: str, degree: int, n_b: int,
                    S_d: int, n_s: int, P_total: int, n_col: int,
                    D_pad: int) -> list:
    """Predicted terms of one FD macro-iteration: the halo exchange of
    ``degree`` SpMV applications plus the layout-level collectives.
    ``n_b`` is the filter layout's local bundle width (n_s / N_col).

    A depth-s plan (``cp.sstep > 1``) swaps the per-SpMV halo term for
    the χ(A^s) exchange terms of :meth:`SpmvCommPlan.sstep_collectives`
    — one single-width seed exchange plus ``⌈degree/s⌉ - 1``
    width-doubled group exchanges, already whole-filter counts."""
    terms = []
    if getattr(cp, "sstep", 1) > 1:
        for k, (kind, b, cnt) in enumerate(cp.sstep_collectives(
                comm, schedule, n_b, S_d, degree)):
            terms.append(ExpectedTerm(
                label=f"sstep-exchange[{comm}/{schedule}#{k}]",
                kind=kind, bytes=b, count=cnt))
    else:
        for kind, b, cnt in cp.spmv_collectives(comm, schedule, n_b, S_d):
            terms.append(ExpectedTerm(
                label=f"halo-exchange[{comm}/{schedule}]", kind=kind,
                bytes=b, count=cnt * degree))
    if P_total > 1:
        levels = int(math.log2(P_total))
        terms.append(ExpectedTerm("tsqr-butterfly", "collective-permute",
                                  n_s * n_s * S_d, levels))
        terms.append(ExpectedTerm("gram-allreduce", "all-reduce",
                                  n_s * n_s * S_d, 1))
    if n_col > 1:
        full = (D_pad // P_total) * n_s * S_d
        moved = full * (n_col - 1) // n_col
        for leg in ("to_panel", "to_stack"):
            terms.append(ExpectedTerm(f"redistribute[{leg}]", "all-to-all",
                                      full, 1, alt_bytes=(moved,)))
    return terms


def measured(trace, P_total: int | None = None) -> list:
    """The record's collectives per device (module docstring): one
    :class:`CollectiveOp` per (kind, bytes, label, group), ``mult`` the
    executions per device over ``P_total`` devices (default: the largest
    group's shards). A rank's record (one shard's share an entry, its
    ``n_loc``) gives the same multiset as the one process's: every
    member of a group issues each of its collectives."""
    entries = [e for e in trace.entries if e.collective]
    if P_total is None:
        P_total = max((e.P for e in entries), default=1)
    agg: dict = {}
    for e in entries:
        n = e.n_loc or e.P
        if e.n_bytes % n:
            raise ValueError(f"entry {e.index} ({e.label}): {e.n_bytes} B "
                             f"do not split over {n} shards")
        key = (HLO_KINDS[e.kind], e.n_bytes // n, e.label, e.group)
        agg[key] = agg.get(key, 0.0) + e.P / P_total
    return [CollectiveOp(kind=k, bytes=b, mult=m, name=lbl, computation=grp)
            for (k, b, lbl, grp), m in agg.items()]


def census_cell_tag(layout, comm, schedule, overlap, use_kernel, sstep,
                    balance, reorder, P_total) -> str:
    """The reference's cell tag, e.g. ``panel/a2a-cyclic+krn/rows+none/P8``."""
    return (f"{layout}/{comm}-{schedule}{'+ov' if overlap else ''}"
            f"{'+krn' if use_kernel else ''}"
            f"{f'+s{sstep}' if sstep > 1 else ''}"
            f"/{balance}+{reorder}/P{P_total}")


def macro_iteration(fd, degree: int, gram: bool = True):
    """One FD macro-iteration of ``fd`` from its own bound pieces: TSQR
    (or SVQB) in the stack layout, the redistribution to the filter
    layout, a degree-``degree`` filter over the bundles, the
    redistribution back and, with ``gram``, the Gram all-reduce. The
    filter maps the operator's Gershgorin interval onto [-1, 1] with
    coefficients ``linspace(1, 0.5)``. Returns ``iteration(V) -> (V_s,
    G)`` (``G`` None without ``gram``)."""
    if degree < 2:
        raise ValueError("chebyshev_filter needs degree >= 2")
    bound = float(fd.ell.vals.abs().sum(-1).max())
    lam = (-bound, bound)
    mu = np.linspace(1.0, 0.5, degree + 1)

    def iteration(V):
        Q = fd.orthogonalize(V)
        Vp = fd.to_panel(Q)
        Vs = fd.to_stack(fd._filter_bundles(Vp, mu, degree, lam))
        return Vs, fd.gram(Vs, Vs) if gram else None

    return iteration


def census_of(fd, cp, *, degree: int, cell: str = "", wrap=None,
              extra_errors=()) -> CensusReport:
    """Run one macro-iteration of ``fd`` (a
    :class:`~repro_torch.core.filter_diag.FilterDiag`) with a trace
    attached to its grid and attribute the record against ``cp``'s terms
    (the pattern-only plan of its filter level). ``wrap(iteration, fd)``,
    the planted-defect seam, may return a changed iteration whose extra
    or missing collectives the census must flag. The block is drawn from
    seed 0; the filter maps the operator's Gershgorin interval onto
    [-1, 1], and its outputs must be finite."""
    import torch

    from ..core.shards import CommTrace

    n_s, N_col = fd.cfg.n_search, fd.N_col
    S_d = fd.ell.vals.element_size()
    iteration = macro_iteration(fd, degree)
    if wrap is not None:
        iteration = wrap(iteration, fd)
    V = fd.random_search_vectors(fd.generator(0))
    groups = {id(g): g for g in (fd.grid.stack, fd.grid.panel)}.values()
    before = [(g, g.trace) for g in groups]
    trace = CommTrace().attach(fd.grid)
    try:
        Vs, G = iteration(V)
    finally:
        for g, t in before:
            g.trace = t
    errors = [f"[{cell}] {e}" for e in extra_errors]
    outs = [t for t in (Vs, G) if isinstance(t, torch.Tensor)]
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        errors.append(f"[{cell}] the iteration's outputs are not finite")
    expected = expected_census(cp, comm=fd.cfg.spmv_comm,
                               schedule=fd.cfg.spmv_schedule, degree=degree,
                               n_b=n_s // N_col, S_d=S_d, n_s=n_s,
                               P_total=fd.P, n_col=N_col, D_pad=fd.D_pad)
    rep = attribute(measured(trace, fd.P), expected, cell=cell,
                    extra_errors=errors)
    rep.launches = sum(e.launches for e in trace.entries)
    return rep


def extra_psum(iteration, fd):
    """A planted defect for :func:`census_of`'s ``wrap``: an all-reduce of
    the Gram matrix after the iteration, which no term predicts (the
    census must report it unattributed)."""
    def planted(V):
        Vs, G = iteration(V)
        fd.group.psum([G] * fd.group.P)
        return Vs, G
    return planted


def skip_gram(iteration, fd):
    """A planted defect for :func:`census_of`'s ``wrap``: the Gram product
    taken without its all-reduce (the census must report the Gram term
    missing, and nothing unattributed)."""
    def planted(V):
        gram, fd.gram = fd.gram, lambda A, B: A.conj().T @ B
        try:
            return iteration(V)
        finally:
            fd.gram = gram
    return planted


def run_census_cell(matrix, *, P_total: int, layout: str = "panel",
                    comm: str = "a2a", schedule: str = "cyclic",
                    overlap: bool = False, use_kernel: bool = False,
                    balance: str = "rows", reorder: str = "none",
                    sstep: int = 1, n_s: int = 8, degree: int = 6,
                    dtype: str = "float64", device=None, wrap=None,
                    rowmap=None) -> CensusReport:
    """Run one engine cell on ``P_total`` shards of ``device`` (the card
    unless ``"cpu"`` is given) and attribute its collectives; the
    reference's cell arguments and cell tag
    (``repro/analysis/census.py:167-326``).

    The grid is the reference's mesh, ``(P_total/2, 2)``, with ``layout``
    on it (``layouts.layout_on_grid``): stack ``P × 1``, panel
    ``P/2 × 2``, pillar ``1 × P``; ``n_s`` is rounded up to a multiple of
    ``N_col``. ``balance``/``reorder`` plan a row map at the filter level
    (``block_multiple = P_total / N_row``, so its padded extent divides
    every shard count), as the reference's cell does; a pillar has no
    halo to re-balance and takes the equal-rows map. A ``rowmap`` (at a
    level whose ``D_pad`` ``P_total`` divides) is used as given, and the
    tag names its balance and order. ``use_kernel`` runs the kernels
    (``+krn``; on the CPU their plain versions) against the same terms;
    ``sstep > 1`` the s-step filter (``+s2``, ``+s3``) against
    ``sstep_collectives``. ``wrap`` is :func:`census_of`'s seam.
    The plan's ``L`` and pair volumes must be the built operator's."""
    from ..core.filter_diag import FDConfig, FilterDiag
    from ..core.layouts import layout_on_grid
    from ..core.partition import RowMap, plan_rowmap
    from ..core.planner import comm_plan

    sstep = int(sstep)
    if sstep < 1:
        raise ValueError(f"sstep must be >= 1 (got {sstep})")
    if degree < 2:
        raise ValueError("chebyshev_filter needs degree >= 2")
    n_row_mesh = max(P_total // 2, 1)
    n_col_mesh = P_total // n_row_mesh
    lay = layout_on_grid(layout, n_row_mesh, n_col_mesh)
    N_row, N_col = lay.n_row, lay.n_col
    n_s = -(-n_s // N_col) * N_col
    D = matrix.shape[0] if hasattr(matrix, "shape") else matrix.D
    if rowmap is not None:
        balance, reorder = rowmap.balance, rowmap.reorder
        if rowmap.identity:
            rowmap = None
    elif (balance, reorder) != ("rows", "none"):
        if N_row > 1:
            rowmap = plan_rowmap(matrix, N_row, balance=balance,
                                 reorder=reorder, sstep=sstep,
                                 block_multiple=P_total // N_row)
            if rowmap.identity:
                rowmap = None  # the planned map degenerated to equal rows
        else:
            balance, reorder = "rows", "none"  # no halo to re-balance
    fd_map = rowmap if rowmap is not None else RowMap.rows(D, P_total)
    cfg = FDConfig(n_target=1, n_search=n_s, layout=layout,
                   spmv_overlap=overlap, spmv_comm=comm,
                   spmv_schedule=schedule, spmv_kernel=use_kernel,
                   spmv_sstep=sstep, dtype=dtype)
    fd = FilterDiag(matrix, cfg, device=device, n_row=n_row_mesh,
                    n_col=n_col_mesh, rowmap=fd_map)
    extra = []
    built = fd.sell_panel if sstep > 1 else fd.ell_panel
    if rowmap is not None:
        cp = comm_plan(matrix, N_row, rowmap=rowmap, sstep=sstep)
    elif sstep > 1:
        cp = comm_plan(matrix, N_row, d_pad=fd.D_pad, sstep=sstep)
    else:
        cp = comm_plan(matrix, N_row, d_pad=fd.D_pad, exact=True)
    depth = f"depth-{sstep} " if sstep > 1 else ""
    if cp.L != built.L:
        extra.append(f"{depth}comm_plan L = {cp.L} != engine L = {built.L}")
    if (cp.pair_counts is not None and built.pair_counts is not None
            and not np.array_equal(cp.pair_counts, built.pair_counts)):
        extra.append(f"{depth}comm_plan pair_counts diverge from the "
                     f"built operator's pair_counts")
    cell = census_cell_tag(layout, comm, schedule, overlap, use_kernel,
                           sstep, balance, reorder, P_total)
    return census_of(fd, cp, degree=degree, cell=cell, wrap=wrap,
                     extra_errors=extra)
