"""χ-driven layout & engine planner — the perf model as the control path
(the port's copy of ``repro/core/planner.py``; host-side numpy, held equal
to the original by ``tests/test_torch_planner.py``).

The paper's central observation is that the communication metric χ (Eqs.
8–10, ``core/metrics.py``) is computable **from the sparsity pattern
alone**, before any code runs, and predicts when each of the two
orthogonal layers of parallelism wins:

  * low χ   → the horizontal layer scales: keep ``stack``/wide ``panel``
              row grids (D sliced over many shards),
  * high χ  → SpMV communication destroys scaling (Eq. 11): shrink the
              row grid — at the extreme the ``pillar`` layout (n_col = P)
              makes the filter communication-free — and pay the explicit
              redistribution (Eqs. 17/18) instead,
  * overlap → the split-phase SpMV engine (``spmv.py overlap=True``)
              replaces the additive χ term of Eq. 12 with
              ``max(T_comm, T_local)`` (``perf_model.cheb_iter_time_overlap``),
  * comm    → the padded ``all_to_all`` moves ``P·L`` entries per shard
              (χ₃-scaled), the compressed neighbor-permute engine
              (``comm="compressed"``) ``H = Σ_r L_r`` (≈ χ₂-scaled),
  * schedule → ``"cyclic"`` pays one round per nonzero cyclic shift,
              ``"matching"`` packs hot pairs of different shifts into one
              round's pad (``spmv.neighbor_schedule``),
  * partition → ``balance="commvol"`` plans non-uniform shard boundaries,
              ``reorder="rcm"`` re-orders the rows first
              (``core/partition.py``) — χ and every byte prediction are
              evaluated on the *planned* partition.

This module enumerates candidate configurations — grid splits
``n_row × n_col`` with ``n_row · n_col = P``, vector layouts
{stack, panel, pillar}, comm engine {a2a, compressed-cyclic,
compressed-matching}, overlap on/off, row partition — scores each with
the analytic model fed the **engine-exact** wire volumes predicted by
:func:`comm_plan`, and returns a ranked :class:`Plan`. It is wired into
the port's entry points:

  * ``FDConfig(layout="auto")`` → :func:`plan_on_grid` inside
    ``FilterDiag`` (the splits the given ``n_row × n_col`` grid realizes),
  * ``python -m repro_torch.launch.solve --layout auto`` →
    :func:`plan_layout` over every split of ``P = n_row·n_col`` shards.

  * sstep → the s-step filter (``spmv.make_sstep_cheb``): one depth-s
              ghost exchange (``comm_plan(..., sstep=s)``, the χ(A^s)
              volumes of ``spmv.sstep_ghosts``) per s recurrence steps,
              ⌈n/s⌉ a filter, for redundant ghost-row work
              (``SpmvCommPlan.sstep_work_factor``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..matrices.sparse import CSR, gather_row_entry_idx
from . import perf_model as pm
from .metrics import ChiMetrics, chi_from_nvc
from .partition import (PLAN_MODES, SPMV_BALANCES, SPMV_REORDERS, RowMap,
                        partition_plan_default, plan_rowmap)
from .redistribute import redistribution_volume
from .spmv import SPMV_COMM_ENGINES, SPMV_SCHEDULES, neighbor_schedule

__all__ = [
    "SpmvCommPlan", "Candidate", "Plan", "comm_plan", "exact_comm_default",
    "estimate_nnzr", "plan_layout", "plan_on_grid", "auto_axes",
    "config_for", "DEFAULT_PLAN_DEGREE",
]


def _equal_rows(D: int, n_row: int,
                d_pad: int | None) -> tuple[np.ndarray, int]:
    """(boundaries, R) of the equal-rows partition — the reference's
    ``spmv.Partition(D, n_row, d_pad)``, i.e. ``RowMap.rows``."""
    rm = RowMap.rows(D, n_row, d_pad)
    return rm.boundaries, rm.R


def exact_comm_default(matrix) -> bool:
    """Whether the exact per-pair pattern pass is affordable for
    ``matrix`` — the policy behind ``comm_plan(exact=None)``: CSR inputs,
    small instances, and reach-limited families (whose ``_remote_cols``
    scan is windowed to block boundaries) are exact; unbounded generators
    at paper scale fall back to the n_vc estimate (no compressed-engine
    ranking)."""
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    return (isinstance(matrix, CSR) or D <= 2_000_000
            or getattr(matrix, "reach", None) is not None)


#: Planning-time Chebyshev degree when the caller has not run the filter
#: selector yet. FD filter degrees are O(100) at paper tolerances (Table 4),
#: far above the pillar break-even n* = 2/χ[P] (Eq. 23) for high-χ matrices.
DEFAULT_PLAN_DEGREE = 100


# --------------------------------------------------------------------------
# pattern-only communication plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpmvCommPlan:
    """Pattern-derived stats of the SpMV engines' exchanges at ``n_row``
    horizontal shards.

    ``L`` is the padded per-(sender, receiver) slot count the a2a engine
    uses (``build_dist_ell``): with ``exact=True`` it is the true maximum
    pair volume, the ``L`` of the built operator; with ``exact=False`` it
    is the χ-based estimate ``ceil(max n_vc / (P-1))``.

    ``pair_counts`` (exact path, or a sampled estimate) are the per-pair
    volumes L_qp, from which :meth:`permute_schedule` reproduces the
    compressed engine's neighbor rounds for either scheduler (cyclic
    shifts or greedy matchings). Without pair counts the compressed
    volume is conservatively estimated as ``max n_vc``.
    """

    n_row: int
    D: int
    L: int
    n_vc: np.ndarray
    exact: bool
    d_pad: int | None = None
    pair_counts: np.ndarray | None = None  # [P, P] L_qp (sender q -> recv p)
    #: ghost-zone depth the stats describe: 1 = the per-SpMV halo, s > 1 =
    #: the depth-s ghost set of the s-step filter (χ(A^s)-derived volumes;
    #: always an exact pattern pass)
    sstep: int = 1
    #: [s+1] max-over-shards ghost count at BFS depth ≤ d (d = 0 is 0): the
    #: s-step filter's redundant-work statistic
    ghost_cum: tuple | None = None
    #: schedule name -> (perms, round_L) memo — the greedy matching
    #: decomposition is O(P² log P), and plan_layout asks for it several
    #: times per candidate
    _sched_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)
    #: planned row decomposition the counts were computed on (None =
    #: the equal-rows partition) — χ is evaluated on ITS block sizes
    rowmap: RowMap | None = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def chi(self) -> ChiMetrics:
        """χ metrics evaluated on the *planned* partition: real rows per
        block come from the rowmap when one is set (``balance="commvol"``
        blocks are non-uniform), else from the equal-rows cuts."""
        if self.rowmap is not None:
            n_vm = self.rowmap.block_sizes(self.n_row)
        else:
            n_vm = np.diff(_equal_rows(self.D, self.n_row, self.d_pad)[0])
        return chi_from_nvc(self.n_vc, n_vm, self.D)

    def a2a_bytes_per_device(self, n_b: int, S_d: int) -> int:
        """Operand bytes of one SpMV's all_to_all on each shard (the
        ``[P, L, n_b]`` send buffer)."""
        if self.n_row <= 1:
            return 0
        return self.n_row * self.L * n_b * S_d

    def permute_schedule(self, schedule: str = "cyclic",
                         ) -> tuple[tuple[tuple[tuple[int, int], ...], ...],
                                    tuple[int, ...]]:
        """(perms, round_L) of the compressed engine under ``schedule``
        (``"cyclic"`` shifts or greedy ``"matching"`` rounds), via the
        same ``spmv.neighbor_schedule`` the engine itself uses —
        predicted and executed schedules cannot diverge."""
        if self.pair_counts is None:
            raise ValueError("permute_schedule needs exact pair counts")
        if schedule not in self._sched_cache:
            self._sched_cache[schedule] = neighbor_schedule(
                self.pair_counts, schedule)
        return self._sched_cache[schedule]

    def moved_entries_per_device(self, comm: str = "a2a",
                                 schedule: str = "cyclic") -> int:
        """Vector entries one shard moves per SpMV column: ``P·L`` for the
        padded all_to_all, ``H = Σ_r L_r`` of the ``schedule`` rounds for
        the compressed engine.

        Without pair counts the compressed volume is a *lower bound*
        (``max n_vc`` — what a per-round-padded schedule can never beat);
        the planner refuses to rank compressed candidates on that bound
        (see :func:`plan_layout`), so it is diagnostics-only.
        """
        if self.n_row <= 1:
            return 0
        if comm == "a2a":
            return self.n_row * self.L
        if comm != "compressed":
            raise ValueError(f"unknown comm engine {comm!r}")
        if self.pair_counts is not None:
            return int(sum(self.permute_schedule(schedule)[1]))
        return int(self.n_vc.max())  # estimated-path lower bound

    def comm_bytes_per_device(self, comm: str, n_b: int, S_d: int,
                              schedule: str = "cyclic") -> int:
        """Predicted per-shard SpMV exchange bytes of engine ``comm``
        with compressed rounds derived by ``schedule``."""
        return self.moved_entries_per_device(comm, schedule) * n_b * S_d

    def rounds_per_exchange(self, comm: str, schedule: str = "cyclic") -> int:
        """Collective rounds one exchange launches: 1 for the a2a engine,
        the schedule's round count for the compressed engine (the α
        latency multiplier of the perf model)."""
        if self.n_row <= 1 or self.L == 0:
            return 0
        if comm == "a2a":
            return 1
        if comm != "compressed":
            raise ValueError(f"unknown comm engine {comm!r}")
        return len(self.permute_schedule(schedule)[1])

    def spmv_collectives(self, comm: str, schedule: str, n_b: int, S_d: int
                         ) -> tuple[tuple[str, int, int], ...]:
        """``(kind, operand bytes, count)`` terms of ONE SpMV's halo
        exchange, per shard, in the reference's HLO names (its
        ``spmv_collectives``, the census's contract;
        ``repro_torch.analysis.census``): ``"a2a"`` one ``all-to-all`` over
        the padded ``[P, L, n_b]`` send buffer, ``"compressed"`` one
        ``collective-permute`` per ``schedule`` round of ``round_L[r]·n_b``
        slots; nothing for a zero-halo partition (L = 0 or one shard)."""
        if self.n_row <= 1 or self.L == 0:
            return ()
        if comm == "a2a":
            return (("all-to-all", self.n_row * self.L * n_b * S_d, 1),)
        if comm != "compressed":
            raise ValueError(f"unknown comm engine {comm!r}")
        _, round_L = self.permute_schedule(schedule)
        return tuple(("collective-permute", Lk * n_b * S_d, 1)
                     for Lk in round_L)

    # ----------------------------------------------------- s-step stats --

    @property
    def level_R(self) -> int:
        """Padded rows per shard the plan's volumes were computed on."""
        if self.rowmap is not None and not self.rowmap.identity:
            return self.rowmap.level_R(self.n_row)
        if self.d_pad is not None:
            return self.d_pad // self.n_row
        return -(-self.D // self.n_row)

    def n_groups(self, degree: int) -> int:
        """Exchanges of a degree-n s-step filter: ⌈n/s⌉."""
        return -(-int(degree) // self.sstep)

    def sstep_work_factor(self) -> float:
        """Matrix-traffic inflation of the s-step filter: a group's steps
        also contract the ghost rows still needed at later depths,
        ``1 + Σ_{d=1}^{s-1} ghosts(≤d) / (s·R)`` (exactly 1 at s = 1)."""
        if self.sstep < 2 or not self.ghost_cum:
            return 1.0
        extra = float(sum(self.ghost_cum[1:self.sstep]))
        return 1.0 + extra / (self.sstep * max(self.level_R, 1))

    def sstep_collectives(self, comm: str, schedule: str, n_b: int, S_d: int,
                          degree: int) -> tuple[tuple[str, int, int], ...]:
        """Whole-filter ``(kind, operand bytes, count)`` terms of the s-step
        filter at ``degree`` (per shard): the first group ships the
        single-width seed (``n_b`` columns), every later group
        ``[w1 | w2]`` at twice the width in the same collective, so a2a
        makes one single-width and ``⌈n/s⌉ − 1`` double-width
        all-to-alls, and the compressed engine that pattern per round.
        The port's :class:`~repro_torch.core.shards.ShardGroup` counts P
        times these bytes (every shard's payload) and these counts of
        calls."""
        if self.sstep < 2:
            raise ValueError("sstep_collectives needs a depth-s plan "
                             "(comm_plan(..., sstep>=2))")
        if self.n_row <= 1 or self.L == 0:
            return ()
        ng = self.n_groups(degree)
        if comm == "a2a":
            b1 = self.n_row * self.L * n_b * S_d
            terms = [("all-to-all", b1, 1)]
            if ng > 1:
                terms.append(("all-to-all", 2 * b1, ng - 1))
            return tuple(terms)
        if comm != "compressed":
            raise ValueError(f"unknown comm engine {comm!r}")
        _, round_L = self.permute_schedule(schedule)
        terms = []
        for Lk in round_L:
            terms.append(("collective-permute", Lk * n_b * S_d, 1))
            if ng > 1:
                terms.append(("collective-permute", 2 * Lk * n_b * S_d,
                              ng - 1))
        return tuple(terms)


def _remote_cols(matrix, a: int, b: int, chunk: int = 2_000_000) -> np.ndarray:
    """Distinct columns outside [a, b) referenced by rows [a, b)."""
    if isinstance(matrix, CSR):
        lo, hi = int(matrix.indptr[a]), int(matrix.indptr[b])
        cols = matrix.indices[lo:hi]
        return np.unique(cols[(cols < a) | (cols >= b)])
    parts = []
    for lo, hi in matrix._scan_ranges(a, b):
        for c0 in range(lo, hi, chunk):
            _, cols = matrix.row_cols(np.arange(c0, min(c0 + chunk, hi),
                                                dtype=np.int64))
            cols = cols[(cols < a) | (cols >= b)]
            if cols.size:
                parts.append(np.unique(cols))
    return np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)


def _mapped_row_cols(matrix, rows: np.ndarray, chunk: int = 2_000_000):
    """Pattern columns of an arbitrary row set (mapped-partition pass)."""
    if isinstance(matrix, CSR):
        gather, _ = gather_row_entry_idx(matrix.indptr, rows)
        yield matrix.indices[gather].astype(np.int64)
        return
    for lo in range(0, len(rows), chunk):
        _, cols = matrix.row_cols(rows[lo: lo + chunk])
        yield np.asarray(cols, dtype=np.int64)


def comm_plan(matrix, n_row: int, *, d_pad: int | None = None,
              exact: bool | None = None,
              n_vc: np.ndarray | None = None,
              rowmap: RowMap | None = None,
              sstep: int = 1) -> SpmvCommPlan:
    """Communication plan of the SpMV engine at ``n_row`` shards, computed
    from the sparsity pattern without building the operator.

    ``exact`` controls whether ``L`` comes from true per-pair distinct
    counts (matches ``build_dist_ell`` exactly; cost ~ one pattern pass) or
    from the aggregate n_vc counts (cheap at any D via the family's
    streamed ``n_vc``). Default: :func:`exact_comm_default`. Only the
    exact path carries per-pair counts, so only it can rank the
    compressed engine. A precomputed ``n_vc`` (on the equal-rows
    boundaries ``RowMap.rows(D, n_row, d_pad)``) skips the pattern pass
    entirely and implies the estimated-L path.

    ``rowmap`` evaluates the plan on a *planned* partition
    (``core/partition.py``: ``balance="commvol"`` boundaries and/or the
    RCM row order) instead of the equal-rows one — always an exact pass,
    and :attr:`SpmvCommPlan.chi` is then computed on the planned block
    sizes. ``L == 0`` (a zero-halo partition) predicts zero bytes, which
    the engines realize exactly.

    ``sstep > 1`` computes the depth-s ghost-zone stats instead of the
    per-SpMV halo: the pair volumes are the positions the breadth-first
    search of ``spmv.sstep_ghosts`` reaches (the pass ``build_sstep_ell``
    runs, so predicted equals built), and :attr:`SpmvCommPlan.ghost_cum`
    carries the per-depth redundant-work counts. The depth-s pass is
    always exact; it warns when scored on a :class:`RowMap` planned at
    another depth.
    """
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    sstep = int(sstep)
    if sstep < 1:
        raise ValueError(f"sstep must be >= 1, got {sstep}")
    if sstep > 1:
        return _sstep_comm_plan(matrix, D, n_row, sstep, d_pad=d_pad,
                                rowmap=rowmap)
    if rowmap is not None and not rowmap.identity:
        if rowmap.D != D:
            raise ValueError("rowmap.D does not match the matrix")
        R = rowmap.level_R(n_row)
        if n_row <= 1:
            return SpmvCommPlan(1, D, 0, np.zeros(1, np.int64), True,
                                rowmap.D_pad, rowmap=rowmap)
        pos = rowmap.pos
        L = 0
        n_vc = np.zeros(n_row, dtype=np.int64)
        pair_counts = np.zeros((n_row, n_row), dtype=np.int64)
        for p in range(n_row):
            rows_g, _ = rowmap.shard_rows(p, n_row)
            parts = []
            for cols in _mapped_row_cols(matrix, rows_g):
                cpos = pos[cols]
                cpos = cpos[cpos // R != p]
                if cpos.size:
                    parts.append(np.unique(cpos))
            if not parts:
                continue
            remote = np.unique(np.concatenate(parts))
            n_vc[p] = remote.size
            pair_counts[:, p] = np.bincount(remote // R, minlength=n_row)
            L = max(L, int(pair_counts[:, p].max()))
        return SpmvCommPlan(n_row, D, L, n_vc, True, rowmap.D_pad,
                            pair_counts=pair_counts, rowmap=rowmap)
    bnds, R = _equal_rows(D, n_row, d_pad)
    if n_row <= 1:
        return SpmvCommPlan(1, D, 0, np.zeros(1, np.int64), True, d_pad)
    if n_vc is not None:
        n_vc = np.asarray(n_vc, dtype=np.int64)
        L = -(-int(n_vc.max()) // (n_row - 1))
        return SpmvCommPlan(n_row, D, L, n_vc, False, d_pad)
    if exact is None:
        exact = exact_comm_default(matrix)
    if not exact:
        n_vc = matrix.n_vc(bnds)
        L = -(-int(n_vc.max()) // (n_row - 1))
        return SpmvCommPlan(n_row, D, L, n_vc, False, d_pad)
    L = 0
    n_vc = np.zeros(n_row, dtype=np.int64)
    pair_counts = np.zeros((n_row, n_row), dtype=np.int64)
    for p in range(n_row):
        a, b = int(bnds[p]), int(bnds[p + 1])
        cols = _remote_cols(matrix, a, b)
        if not cols.size:
            continue
        n_vc[p] = cols.size
        pair_counts[:, p] = np.bincount(np.minimum(cols // R, n_row - 1),
                                        minlength=n_row)
        L = max(L, int(pair_counts[:, p].max()))
    return SpmvCommPlan(n_row, D, L, n_vc, True, d_pad,
                        pair_counts=pair_counts)


def _sstep_comm_plan(matrix, D: int, n_row: int, sstep: int, *,
                     d_pad: int | None, rowmap: RowMap | None
                     ) -> SpmvCommPlan:
    """Depth-s ghost-zone stats through ``build_sstep_ell``'s own
    breadth-first search (``spmv.sstep_ghosts``) over the pattern in
    position space (the reference's ``_sstep_comm_plan``,
    ``repro/core/planner.py:445-505``)."""
    import warnings

    from .partition import _pattern_csr
    from .spmv import sstep_ghosts

    mapped = rowmap is not None and not rowmap.identity
    if mapped and rowmap.D != D:
        raise ValueError("rowmap.D does not match the matrix")
    if mapped and int(getattr(rowmap, "sstep", 1)) != sstep:
        warnings.warn(
            f"comm_plan(sstep={sstep}) scored on a RowMap planned at "
            f"sstep={getattr(rowmap, 'sstep', 1)} — its cuts were not "
            f"optimized for the depth-{sstep} ghost volumes, so the "
            f"redistribution/byte accounting may under-count; re-plan "
            f"with plan_rowmap(..., sstep={sstep})",
            UserWarning, stacklevel=3)
    if n_row <= 1:
        return SpmvCommPlan(1, D, 0, np.zeros(1, np.int64), True,
                            rowmap.D_pad if mapped else d_pad,
                            sstep=sstep, ghost_cum=(0,) * (sstep + 1),
                            rowmap=rowmap)
    indptr, cols = _pattern_csr(matrix)
    if mapped:
        R = rowmap.level_R(n_row)
        pos = rowmap.pos
        rows = np.repeat(np.arange(D, dtype=np.int64), np.diff(indptr))
        prow, pcol = pos[rows], pos[cols]
        order = np.lexsort((pcol, prow))
        prow, pcol = prow[order], pcol[order]
        counts = np.bincount(prow, minlength=n_row * R)
        indptr_pos = np.concatenate([[0], np.cumsum(counts)])
        cols_pos = pcol
        pad = rowmap.D_pad
    else:
        R = (d_pad // n_row) if d_pad is not None else -(-D // n_row)
        # the equal-rows cuts put row g at position g; pad rows are empty
        indptr_pos = np.concatenate(
            [indptr, np.full(n_row * R - D, indptr[-1], dtype=indptr.dtype)])
        cols_pos = cols
        pad = d_pad
    ghosts = sstep_ghosts(indptr_pos, cols_pos, n_row, R, sstep)
    n_vc = np.zeros(n_row, dtype=np.int64)
    pair_counts = np.zeros((n_row, n_row), dtype=np.int64)
    ghost_cum = np.zeros(sstep + 1, dtype=np.int64)
    for p, (gpos, gdep) in enumerate(ghosts):
        n_vc[p] = gpos.size
        if gpos.size:
            pair_counts[:, p] = np.bincount(gpos // R, minlength=n_row)
        for d in range(1, sstep + 1):
            ghost_cum[d] = max(ghost_cum[d], int((gdep <= d).sum()))
    L = int(pair_counts.max()) if pair_counts.size else 0
    return SpmvCommPlan(n_row, D, L, n_vc, True, pad,
                        pair_counts=pair_counts, sstep=sstep,
                        ghost_cum=tuple(int(g) for g in ghost_cum),
                        rowmap=rowmap)


def estimate_nnzr(matrix, probe_rows: int = 4096) -> float:
    """Average stored nonzeros per row: exact for CSR, leading-row probe
    for generator families (pattern rows are statistically homogeneous)."""
    if isinstance(matrix, CSR):
        return matrix.n_nzr
    rows = np.arange(0, min(matrix.D, probe_rows), dtype=np.int64)
    r, _ = matrix.row_cols(rows)
    return len(r) / len(rows)


# --------------------------------------------------------------------------
# candidate scoring
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored configuration of the two parallelism layers."""

    layout: str        # "stack" | "panel" | "pillar"
    n_row: int         # horizontal layer width (D split)
    n_col: int         # vertical layer width (bundle split)
    overlap: bool      # split-phase SpMV engine on
    comm: str          # "a2a" (padded all_to_all) | "compressed" (ppermute)
    schedule: str      # compressed rounds: "cyclic" | "matching"
    redistribute: bool # pays Eq. 17/18 twice per filter pass (n_col > 1)
    chi1: float        # χ₁ of the filter layout's row partition
    chi2: float
    chi_eng: float     # effective χ of the comm engine (exact wire volume)
    t_iter: float      # one Chebyshev iteration [s] (Eq. 12 / overlap model)
    t_redist: float    # one redistribution [s] (Eq. 17/18 over b_c)
    t_pass: float      # degree·t_iter + 2·t_redist [s]
    comm_bytes_per_device: int  # predicted SpMV exchange operand bytes
    balance: str = "rows"   # row partition: "rows" | "commvol"
    reorder: str = "none"   # row order: "none" | "rcm"
    kernel: bool = False    # fused kernel engine (κ=5 traffic term)
    sstep: int = 1          # ghost-zone depth (s-step filter; 1 = per-SpMV)
    #: the planned RowMap behind a non-default balance/reorder (shared by
    #: every candidate of that combo; None for the equal-rows partition).
    #: FilterDiag builds its operators from exactly this map, so the
    #: scored χ/bytes are the ones the engines realize.
    rowmap: RowMap | None = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def name(self) -> str:
        """Layout name with the ``+cv``/``+rcm`` partition and
        ``+cmp``/``+mat``/``+ov`` engine suffixes (``+cv`` = commvol
        boundaries, ``+rcm`` = RCM row order, ``+cmp`` =
        compressed-cyclic, ``+mat`` = compressed with the matching
        scheduler, ``+krn`` = the kernels, ``+s2``/``+s3`` = the s-step
        ghost-zone depth)."""
        suffix = ""
        if self.balance == "commvol":
            suffix += "+cv"
        if self.reorder == "rcm":
            suffix += "+rcm"
        if self.comm == "compressed":
            suffix += "+cmp" if self.schedule == "cyclic" else "+mat"
        if self.overlap:
            suffix += "+ov"
        if self.kernel:
            suffix += "+krn"
        if self.sstep > 1:
            suffix += f"+s{self.sstep}"
        return self.layout + suffix

    def describe(self) -> str:
        return f"{self.name}({self.n_row}x{self.n_col})"

    def row(self) -> str:
        return (f"{self.describe():22s} {self.chi1:7.2f} {self.chi_eng:7.2f} "
                f"{self.t_iter * 1e3:9.3f} {self.t_redist * 1e3:9.3f} "
                f"{self.t_pass * 1e3:10.2f}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Ranked candidate configurations (best first) for one matrix."""

    matrix: str
    D: int
    n_devices: int
    n_search: int
    degree: int
    machine: str
    candidates: tuple[Candidate, ...]

    @property
    def best(self) -> Candidate:
        return self.candidates[0]

    @property
    def baseline(self) -> Candidate:
        """Speedup reference: the additive a2a stack candidate on the
        equal-rows partition (n_col = 1, no overlap, padded all_to_all —
        the paper's reference point) when it was enumerated, otherwise
        the slowest candidate (``report()`` says which)."""
        for c in self.candidates:
            if c.n_col == 1 and not c.overlap and c.comm == "a2a" \
                    and c.balance == "rows" and c.reorder == "none" \
                    and c.sstep == 1:
                return c
        return max(self.candidates, key=lambda c: c.t_pass)

    def speedup(self, c: Candidate) -> float:
        """Predicted filter-pass speedup of ``c`` over :attr:`baseline`."""
        return self.baseline.t_pass / c.t_pass

    def report(self) -> str:
        base = self.baseline
        vs = ("additive a2a stack"
              if base.n_col == 1 and not base.overlap and base.comm == "a2a"
              else f"slowest candidate {base.describe()}")
        lines = [
            f"layout plan: {self.matrix}  D={self.D}  P={self.n_devices}  "
            f"N_s={self.n_search}  degree={self.degree}  machine={self.machine}",
            f"{'config':22s} {'chi1':>7s} {'chi_eng':>7s} {'t_iter':>9s} "
            f"{'t_redist':>9s} {'t_pass':>10s} {'speedup':>8s}   "
            f"(ms; speedup vs {vs})",
        ]
        for i, c in enumerate(self.candidates):
            mark = " <- best" if i == 0 else ""
            lines.append(f"{c.row()} {self.speedup(c):8.2f}{mark}")
        return "\n".join(lines)


def _matrix_label(matrix) -> str:
    if isinstance(matrix, CSR):
        return f"CSR{matrix.shape}"
    return matrix.describe() if hasattr(matrix, "describe") else str(matrix)


def plan_layout(matrix, n_devices: int, *, n_search: int,
                degree: int = DEFAULT_PLAN_DEGREE,
                machine: pm.MachineModel = pm.H100_1CARD,
                overlap: tuple[bool, ...] = (False, True),
                comm: tuple[str, ...] = ("a2a", "compressed"),
                schedule: tuple[str, ...] = ("cyclic", "matching"),
                balance: tuple[str, ...] = ("rows", "commvol"),
                reorder: tuple[str, ...] = ("none",),
                kernel: tuple[bool, ...] = (False,),
                sstep: tuple[int, ...] = (1,),
                splits=None, S_d: int | None = None,
                n_nzr: float | None = None, d_pad: int | None = None,
                exact_comm: bool | None = None,
                n_vc_by_row: dict | None = None,
                comm_plan_by_row: dict | None = None,
                plan_mode: str = "exact", sample_seed: int = 0,
                sample_fraction: float | None = None) -> Plan:
    """Enumerate and rank layout/engine configurations for ``matrix`` on
    ``n_devices`` shards with an ``n_search``-wide vector bundle.

    ``splits`` restricts the candidate ``(n_row, n_col)`` grids (default:
    every n_col dividing both P and n_search). ``overlap``, ``comm``, and
    ``schedule`` select which SpMV engines to consider — the full grid is
    {a2a, compressed-cyclic, compressed-matching} × {additive, overlap};
    variants are only generated where they differ from the additive a2a
    model (χ > 0). Every candidate is scored with its **engine-exact**
    wire volume: ``comm_plan`` predicts the padded all_to_all's ``P·L``
    (χ₃-scaled) or the neighbor-permute schedule's ``H = Σ_r L_r``
    moved entries, which become the effective χ of the iteration-time
    model (``perf_model.engine_chi``). The ranking key is the predicted
    time of one filter pass, ``degree`` Chebyshev iterations plus two
    redistributions (Alg. 1 steps 7/9).

    ``balance`` × ``reorder`` is the fifth axis — the **row partition
    itself** (``core/partition.py``): each non-default combination plans
    one :class:`~repro_torch.core.partition.RowMap` at the finest level P
    and scores every split on that map's grouped boundaries with the same
    engine-exact byte predictions (``comm_plan(rowmap=...)``). Planned
    combinations need the full per-row pattern pass and are skipped when
    it is unaffordable (``partition.partition_plan_default``) or when a
    split has no halo exchange at all. Ties prefer the equal-rows,
    natural-order partition.

    ``kernel`` widens the grid with the fused-kernel variant of each
    engine (``make_spmv(use_kernel=True)`` + ``make_fused_cheb_step``),
    scored by clamping the machine's κ vector-traffic factor to the fused
    kernel's κ = 5 (``perf_model.fused_kernel_machine``). The axis
    defaults to off (``(False,)``).

    ``sstep`` widens the grid with the s-step ghost-zone depth of the
    communication-avoiding filter (``spmv.make_sstep_cheb``). An s > 1
    candidate replaces the per-SpMV halo by one depth-s exchange per s
    steps: per iteration it pays ``(2·⌈n/s⌉ − 1)/n`` of the depth-s
    exchange bytes (later groups ship ``[w1 | w2]``), ``⌈n/s⌉·rounds/n``
    of the machine's per-round α, and a matrix-traffic term inflated by
    the redundant ghost rows (``SpmvCommPlan.sstep_work_factor``), so
    only α can make it win. s > 1 candidates are enumerated on the
    default partition, where there is an exchange and the plan is exact,
    without overlap (steps ≥ 1 of a group read the ghosts).

    ``n_vc_by_row`` maps n_row -> precomputed n_vc counts (on the
    equal-rows boundaries) and ``comm_plan_by_row`` maps n_row -> a full
    precomputed :class:`SpmvCommPlan` (same ``d_pad``); both apply to the
    equal-rows combo only.

    ``plan_mode`` ∈ ``partition.PLAN_MODES`` selects the pattern-pass
    strategy. ``"exact"``: full per-pair passes where affordable, and the
    balance/reorder axis is **dropped with a ``UserWarning``** when the
    instance exceeds the ``partition_plan_default`` gate. ``"sampled"``
    routes every pattern pass through ``core/sketch.py`` — seeded
    row-subsample χ/L_qp estimates (``sample_seed``/``sample_fraction``)
    and the coarsened commvol descent; sampled plans carry estimated
    per-pair counts (``exact=False``), so the compressed engines still
    rank, while ``reorder="rcm"`` is skipped. ``"auto"`` resolves to
    exact below the gate and sampled above it.
    """
    P = int(n_devices)
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if S_d is None:
        S_d = matrix.S_d if hasattr(matrix, "S_d") else (
            matrix.data.dtype.itemsize if getattr(matrix, "data", None) is not None else 8)
    if n_nzr is None:
        n_nzr = estimate_nnzr(matrix)
    if splits is None:
        splits = [(P // c, c) for c in range(1, P + 1)
                  if P % c == 0 and n_search % c == 0]
    if not splits:
        raise ValueError(f"no (n_row, n_col) split of P={P} divides n_search={n_search}")
    for sch in set(schedule):
        # validated up front so a typo is caught even when the comm axis
        # happens to exclude "compressed"
        if sch not in SPMV_SCHEDULES:
            raise ValueError(f"unknown schedule {sch!r}")
    ssteps = tuple(dict.fromkeys(int(s) for s in sstep))
    for s in ssteps:
        if s < 1:
            raise ValueError(f"sstep values must be >= 1, got {s}")
    partitions: list[tuple[str, str]] = []
    for bal in dict.fromkeys(balance):
        if bal not in SPMV_BALANCES:
            raise ValueError(f"unknown balance {bal!r} "
                             f"(expected one of {SPMV_BALANCES})")
        for ro in dict.fromkeys(reorder):
            if ro not in SPMV_REORDERS:
                raise ValueError(f"unknown reorder {ro!r} "
                                 f"(expected one of {SPMV_REORDERS})")
            partitions.append((bal, ro))
    if plan_mode not in PLAN_MODES:
        raise ValueError(f"unknown plan_mode {plan_mode!r} "
                         f"(expected one of {PLAN_MODES})")
    plan_ok = partition_plan_default(matrix, P)
    use_sampled = plan_mode == "sampled" or (plan_mode == "auto"
                                             and not plan_ok)

    plans: dict[int, SpmvCommPlan] = dict(comm_plan_by_row or {})
    mapped_plans: dict[tuple[str, str, int], SpmvCommPlan] = {}
    sstep_plans: dict[tuple[int, int], SpmvCommPlan] = {}  # (n_row, s>1)
    rowmaps: dict[tuple[str, str], RowMap] = {}
    pattern = None  # one pattern pass shared by every planned combo
    cands: list[Candidate] = []
    gate_warned = False
    for bal, ro in partitions:
        default_part = bal == "rows" and ro == "none"
        if not default_part:
            if not plan_ok and not use_sampled:
                # per-row pattern pass unaffordable at this D/P — the
                # axis is dropped, but never silently
                if not gate_warned:
                    import warnings

                    from .partition import (PARTITION_PLAN_MAX_D,
                                            PARTITION_PLAN_MAX_P)
                    warnings.warn(
                        f"plan_layout: dropping the balance/reorder "
                        f"partition axis — D={D}, P={P} exceeds the "
                        f"exact partition-planner gate "
                        f"(PARTITION_PLAN_MAX_D={PARTITION_PLAN_MAX_D}, "
                        f"PARTITION_PLAN_MAX_P={PARTITION_PLAN_MAX_P}); "
                        f"pass plan_mode='sampled' (CLI: --plan-mode "
                        f"sampled) to plan it from a row subsample "
                        f"instead", UserWarning, stacklevel=2)
                    gate_warned = True
                continue
            if use_sampled and ro != "none":
                continue  # RCM needs the full adjacency — exact-only
            if (bal, ro) not in rowmaps:
                if use_sampled:
                    rowmaps[(bal, ro)] = plan_rowmap(
                        matrix, P, balance=bal, reorder=ro,
                        plan_mode="sampled", sample_seed=sample_seed,
                        sample_fraction=sample_fraction)
                else:
                    if pattern is None:
                        from .partition import _pattern_csr

                        pattern = _pattern_csr(matrix)
                    rowmaps[(bal, ro)] = plan_rowmap(matrix, P,
                                                     balance=bal,
                                                     reorder=ro,
                                                     pattern=pattern)
            rowmap = rowmaps[(bal, ro)]
            if rowmap.identity:
                continue  # the planned map degenerated to equal rows —
                # its candidates would be pure duplicates
        for n_row, n_col in splits:
            if n_row * n_col != P:
                raise ValueError(f"split {n_row}x{n_col} != P={P}")
            if default_part:
                if n_row not in plans:
                    n_vc_pre = (n_vc_by_row or {}).get(n_row)
                    if (use_sampled and n_row > 1 and n_vc_pre is None
                            and exact_comm is not True):
                        from .sketch import sampled_comm_plan

                        plans[n_row] = sampled_comm_plan(
                            matrix, n_row, d_pad=d_pad,
                            fraction=sample_fraction, seed=sample_seed)
                    else:
                        plans[n_row] = comm_plan(
                            matrix, n_row, d_pad=d_pad, exact=exact_comm,
                            n_vc=n_vc_pre)
                cp = plans[n_row]
            else:
                key = (bal, ro, n_row)
                if key not in mapped_plans:
                    if use_sampled:
                        from .sketch import sampled_comm_plan

                        mapped_plans[key] = sampled_comm_plan(
                            matrix, n_row, rowmap=rowmap,
                            fraction=sample_fraction, seed=sample_seed)
                    else:
                        mapped_plans[key] = comm_plan(matrix, n_row,
                                                      rowmap=rowmap)
                cp = mapped_plans[key]
            chim = cp.chi
            chi1 = chim.chi1 if n_row > 1 else 0.0
            if not default_part and chi1 <= 0.0:
                # no halo exchange to re-balance: the planned partition
                # is a pure duplicate of the equal-rows candidate
                continue
            n_b = n_search // n_col
            name = "stack" if n_col == 1 else (
                "pillar" if n_col == P else "panel")
            t_red = 0.0
            if n_col > 1:
                # per-shard moved bytes of one redistribution (Eq. 18
                # total spread over P shards) through the inter-process
                # bandwidth
                t_red = (redistribution_volume(D, n_search, P, n_col, S_d)
                         ["bytes_total"] / P / machine.b_c)
            engines: list[tuple[str, str]] = []
            for eng in sorted(set(comm)):
                if eng not in SPMV_COMM_ENGINES:
                    raise ValueError(f"unknown comm engine {eng!r}")
                if eng == "a2a":
                    engines.append((eng, "cyclic"))  # schedule is a no-op
                    continue
                for sch in sorted(set(schedule)):
                    engines.append((eng, sch))
            for eng, sch in engines:
                if eng == "compressed" and chi1 <= 0.0:
                    continue  # no halo exchange: compressed == a2a
                if eng == "compressed" and cp.pair_counts is None:
                    # estimated-path n_vc gives only a lower bound on the
                    # schedule volume — never claim a compressed win the
                    # pattern hasn't proven
                    continue
                for s in ssteps:
                    if s == 1:
                        moved = cp.moved_entries_per_device(eng, sch)
                        rounds = float(cp.rounds_per_exchange(eng, sch))
                        wf = 1.0
                        bytes_dev = cp.comm_bytes_per_device(eng, n_b,
                                                             S_d, sch)
                    else:
                        # the s-step axis: default partition only (the
                        # depth-s search needs the exact pattern; a planned
                        # map would need re-planning at depth s), and only
                        # where there is an exchange to avoid
                        if not default_part or chi1 <= 0.0 or not cp.exact:
                            continue
                        if (n_row, s) not in sstep_plans:
                            sstep_plans[(n_row, s)] = comm_plan(
                                matrix, n_row, d_pad=d_pad, sstep=s)
                        cps = sstep_plans[(n_row, s)]
                        ng = cps.n_groups(degree)
                        # bytes per iteration: one single-width and ng-1
                        # double-width exchanges over the whole filter
                        moved = (cps.moved_entries_per_device(eng, sch)
                                 * (2 * ng - 1) / degree)
                        rounds = (cps.rounds_per_exchange(eng, sch)
                                  * ng / degree)
                        wf = cps.sstep_work_factor()
                        bytes_dev = int(round(moved * n_b * S_d))
                    chi_eng = pm.engine_chi(moved, D, n_row)
                    kw = dict(D=D, N_p=n_row, n_b=n_b, chi=chi_eng,
                              n_nzr=n_nzr, S_d=S_d)
                    for ov in sorted(set(overlap)):
                        if ov and chi1 <= 0.0:
                            continue  # overlap is a no-op without an exchange
                        if ov and s > 1:
                            continue  # steps >= 1 depend on the ghosts
                        for kn in sorted(set(kernel)):
                            mk = (pm.fused_kernel_machine(machine)
                                  if kn else machine)
                            t_iter = (pm.cheb_iter_time_overlap(
                                          mk, **kw, rounds=rounds)
                                      if ov else pm.cheb_iter_time(
                                          mk, **kw, rounds=rounds,
                                          work_factor=wf))
                            cands.append(Candidate(
                                layout=name, n_row=n_row, n_col=n_col,
                                overlap=ov, comm=eng, schedule=sch,
                                redistribute=n_col > 1,
                                chi1=chi1, chi2=chim.chi2, chi_eng=chi_eng,
                                t_iter=t_iter, t_redist=t_red,
                                t_pass=degree * t_iter + 2.0 * t_red,
                                comm_bytes_per_device=bytes_dev,
                                balance=bal, reorder=ro, kernel=kn,
                                sstep=s,
                                rowmap=None if default_part else rowmap,
                            ))
    if not cands:
        raise ValueError(
            f"no candidate survived for P={P}, n_search={n_search}, "
            f"overlap={overlap}, splits={splits} — overlap-only planning "
            f"needs at least one split with chi > 0 (n_row > 1)")
    # ties prefer fewer wire bytes first (the overlap model hides a
    # fully-overlapped exchange, so engines/partitions that differ only
    # in moved bytes tie on time — the lighter wire footprint is the
    # robust choice), then the simpler configuration: a2a before
    # compressed, cyclic rounds before matching, equal rows before
    # commvol, natural order before rcm, additive before overlap
    cands.sort(key=lambda c: (c.t_pass, c.comm_bytes_per_device,
                              c.comm != "a2a", c.schedule != "cyclic",
                              c.balance != "rows", c.reorder != "none",
                              c.overlap, c.kernel, c.sstep, c.n_col))
    return Plan(matrix=_matrix_label(matrix), D=D, n_devices=P,
                n_search=n_search, degree=degree, machine=machine.name,
                candidates=tuple(cands))


# --------------------------------------------------------------------------
# grid-constrained planning (FDConfig.layout = "auto")
# --------------------------------------------------------------------------


def auto_axes(cfg, D: int, P: int) -> dict:
    """The keyword arguments an auto solve plans ``cfg`` with at ``P``
    shards: its block width, the engine's padded equal-rows partition
    ``d_pad = ceil(D/P)·P`` (so that the scored χ and L are the built
    operator's), the reorders {none, ``cfg.spmv_reorder``}, the kernel
    axis held at ``cfg.spmv_kernel``, the depths {1, ``cfg.spmv_sstep``}
    and ``cfg.plan_mode``. The
    reference widens the kernel axis to ``(False, cfg.spmv_kernel)``
    (``repro/core/filter_diag.py:235``); where the two tie, its
    tiebreak prefers ``kernel=False``, and ``--spmv-kernel`` would run
    the plain versions."""
    return dict(n_search=cfg.n_search, d_pad=-(-int(D) // P) * P,
                reorder=tuple(dict.fromkeys(("none", cfg.spmv_reorder))),
                kernel=(cfg.spmv_kernel,),
                sstep=tuple(dict.fromkeys((1, int(cfg.spmv_sstep)))),
                plan_mode=cfg.plan_mode)


def config_for(cfg, best: Candidate):
    """A copy of ``cfg`` set to the candidate ``best``: its layout, halo
    engine, row partition, kernel axis and s-step depth."""
    return dataclasses.replace(
        cfg, layout=best.layout, spmv_overlap=best.overlap,
        spmv_comm=best.comm, spmv_schedule=best.schedule,
        spmv_balance=best.balance, spmv_reorder=best.reorder,
        spmv_kernel=best.kernel, spmv_sstep=best.sstep)


def plan_on_grid(matrix, n_row: int, n_col: int, *, n_search: int,
                 **kwargs) -> Plan:
    """Rank the layouts realizable on an ``n_row × n_col`` grid of shards
    (the reference's ``plan_for_mesh``, ``repro/core/planner.py:981``):
    stack (``P × 1``), panel (``n_row × n_col``) and pillar (``1 × P``),
    ``P = n_row·n_col``, each where ``n_search`` splits over its columns.
    ``layouts.layout_on_grid`` realizes the winner's layout on the grid.
    Used by ``FilterDiag`` when ``FDConfig.layout == "auto"``."""
    P = int(n_row) * int(n_col)
    splits = []
    for nr, nc in ((P, 1), (int(n_row), P // max(int(n_row), 1)), (1, P)):
        if nr >= 1 and nc >= 1 and nr * nc == P and n_search % nc == 0 \
                and (nr, nc) not in splits:
            splits.append((nr, nc))
    return plan_layout(matrix, P, n_search=n_search, splits=splits, **kwargs)
