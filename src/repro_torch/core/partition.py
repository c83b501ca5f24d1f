"""χ-aware row partitioning: the horizontal layer's row decomposition as
a planned quantity (the port's copy of ``repro/core/partition.py``; numpy
on the host, held equal to the original array for array by
``tests/test_torch_partition.py``).

* ``balance="commvol"`` computes non-uniform shard boundaries: a
  prefix-balanced seed from the per-row cost ``c(r) = α·nnz(r) +
  β·cut(r)`` (``cut(r)``: the entries of row r whose column lies outside
  r's block), then a greedy descent of every cut on the engines' wire
  volume ``P·L + H_cyclic + H_matching``, never worse than equal rows.
* ``reorder="rcm"`` applies a reverse-Cuthill-McKee row permutation
  first: a similarity transform, so the eigenvalues are unchanged, and
  ``FilterDiag.gather_global`` un-permutes the eigenvectors.

Both are one object, :class:`RowMap`: an embed of the D rows into a
padded position space of ``D_pad = P·R`` slots in which every shard owns
an equal, contiguous slice of positions. Row g lives at ``pos(g) = p·R +
(r − boundaries[p])``, r its place in the (reordered) row order and p its
block. Because the position space is uniform, the shards, TSQR and the
stack↔panel redistribution never notice the map, and any level
``n_row | P`` reuses it by grouping positions (``RowMap.level_R``), so the
stack- and panel-level operators of one solve share one map. Pad
positions hold exact zeros everywhere (``lanczos_interval`` masks them).

``plan_mode="sampled"`` plans the commvol cuts from a seeded row
subsample instead (``core/sketch.py::coarsened_commvol_boundaries``), and
``"auto"`` samples above the exact planner's gate.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..matrices.sparse import CSR, gather_row_entry_idx

__all__ = ["RowMap", "SPMV_BALANCES", "SPMV_REORDERS", "PLAN_MODES",
           "equal_cuts", "plan_rowmap", "rcm_permutation",
           "commvol_boundaries", "partition_plan_default"]

#: Row-balance modes of the partition planner (``FDConfig.spmv_balance``).
SPMV_BALANCES = ("rows", "commvol")

#: Row-reorder modes of the partition planner (``FDConfig.spmv_reorder``).
SPMV_REORDERS = ("none", "rcm")

#: Planning modes (``FDConfig.plan_mode`` / ``--plan-mode``): ``exact``
#: walks the full pattern (gated by :func:`partition_plan_default`),
#: ``sampled`` estimates from a seeded row subsample (``core/sketch.py``),
#: ``auto`` = exact below the gate, sampled above it.
PLAN_MODES = ("exact", "sampled", "auto")

#: Largest D for which the partition planner's full pattern pass
#: (per-row nnz + cut counts, RCM adjacency) is considered affordable.
PARTITION_PLAN_MAX_D = 1_000_000

#: Largest shard count at which the planner enumerates planned
#: partitions by default — the cut descent is O(P · passes · grid)
#: objective evaluations, each O(P²), so very wide meshes (the 256-chip
#: dry-run) keep the equal-rows partition unless a map is planned
#: explicitly.
PARTITION_PLAN_MAX_P = 64


def partition_plan_default(matrix, P: int | None = None,
                           plan_mode: str = "exact") -> bool:
    """Whether ``plan_rowmap`` is affordable for ``matrix`` (and shard
    count ``P``, when given) — the single policy behind the planner's
    balance/reorder axis gating. Unlike the χ pattern pass (windowed by
    ``reach``), the exact partition planner needs per-row costs over
    *all* rows, so instance size matters; the cut descent additionally
    scales with the shard count. ``plan_mode="sampled"`` (and ``"auto"``,
    which falls back to sampling above the gate) plans from a row
    subsample and is affordable at any size."""
    if plan_mode not in PLAN_MODES:
        raise ValueError(f"unknown plan_mode {plan_mode!r} "
                         f"(expected one of {PLAN_MODES})")
    if plan_mode in ("sampled", "auto"):
        return True
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    return D <= PARTITION_PLAN_MAX_D and (P is None
                                          or P <= PARTITION_PLAN_MAX_P)


# --------------------------------------------------------------------------
# the row map
# --------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class RowMap:
    """Planned row decomposition: reorder permutation + (possibly
    non-uniform) block boundaries, realized as an embed of global rows
    into a padded equal-block position space.

    ``perm[r]`` is the original row occupying reordered position r
    (identity for ``reorder="none"``); ``boundaries`` are the P+1 block
    cuts in reordered row space; ``R`` is the per-block padded extent —
    every block p owns positions ``[p·R, (p+1)·R)`` and places its
    ``boundaries[p+1]-boundaries[p]`` real rows at the slice's start,
    zero-pad after. ``D_pad = P·R``. Any shard count Q with
    ``D_pad % Q == 0`` reuses the map by grouping positions.
    """

    D: int
    P: int
    balance: str
    reorder: str
    perm: np.ndarray         # [D] original row at each reordered position
    boundaries: np.ndarray   # [P+1] block cuts in reordered row space
    R: int                   # padded rows per plan-level block
    #: ghost-zone depth the map was planned/validated at (the
    #: ``spmv_sstep`` axis). A map planned at s=1 scored under an s>1
    #: comm plan under-counts the depth-s volumes its cuts were never
    #: optimized for — ``planner.comm_plan`` warns on the mismatch.
    sstep: int = 1
    _pos: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _row_of: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @property
    def D_pad(self) -> int:
        return self.P * self.R

    @property
    def identity(self) -> bool:
        """True when the map is exactly the equal-rows partition:
        untouched row order and the equal-rows boundaries at this R —
        either by construction (``balance="rows", reorder="none"``) or
        because a planned map degenerated to it (e.g. the commvol
        never-worse guard kept the equal cuts)."""
        if self.balance == "rows" and self.reorder == "none":
            return True
        eq = np.minimum(np.arange(self.P + 1, dtype=np.int64) * self.R,
                        self.D)
        return bool(np.array_equal(self.boundaries, eq)
                    and np.array_equal(self.perm,
                                       np.arange(self.D, dtype=np.int64)))

    @property
    def pos(self) -> np.ndarray:
        """[D] padded position of every original row (the embed)."""
        if self._pos is None:
            pos = np.empty(self.D, dtype=np.int64)
            for p in range(self.P):
                a, b = int(self.boundaries[p]), int(self.boundaries[p + 1])
                pos[self.perm[a:b]] = p * self.R + np.arange(b - a)
            self._pos = pos
        return self._pos

    @property
    def row_of(self) -> np.ndarray:
        """[D_pad] original row at every padded position, -1 at pads."""
        if self._row_of is None:
            row_of = np.full(self.D_pad, -1, dtype=np.int64)
            row_of[self.pos] = np.arange(self.D, dtype=np.int64)
            self._row_of = row_of
        return self._row_of

    def valid_mask(self) -> np.ndarray:
        """[D_pad] bool: positions holding a real row (False = pad)."""
        return self.row_of >= 0

    def is_bijection(self) -> bool:
        """True iff the embed is injective into [0, D_pad) and ``row_of``
        inverts it on every real row — i.e. ``extract(embed(X)) == X``
        holds structurally. The static plan linter
        (``repro.analysis.plan_lint``) gates on this."""
        pos = self.pos
        if pos.size != self.D:
            return False
        if pos.size and (pos.min() < 0 or pos.max() >= self.D_pad):
            return False
        if np.unique(pos).size != self.D:
            return False
        return bool((self.row_of[pos] == np.arange(self.D)).all())

    def level_R(self, n_row: int) -> int:
        """Padded rows per shard at a grouped level of ``n_row`` shards."""
        if self.D_pad % n_row:
            raise ValueError(f"D_pad={self.D_pad} not divisible by "
                             f"n_row={n_row} (map planned at P={self.P})")
        return self.D_pad // n_row

    def owner(self, rows: np.ndarray, n_row: int | None = None) -> np.ndarray:
        """Shard owning each original row id at level ``n_row``
        (default: the plan level P)."""
        R = self.level_R(n_row) if n_row is not None else self.R
        return self.pos[np.asarray(rows, dtype=np.int64)] // R

    def block_sizes(self, n_row: int | None = None) -> np.ndarray:
        """Real rows per shard at level ``n_row`` (the n_vm of Eq. 3)."""
        if n_row is None or n_row == self.P:
            return np.diff(self.boundaries.astype(np.int64))
        R = self.level_R(n_row)
        return np.bincount(self.pos // R, minlength=n_row)

    def shard_rows(self, p: int, n_row: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(original rows, local offsets) owned by shard ``p`` at level
        ``n_row``, ordered by position."""
        R = self.level_R(n_row) if n_row is not None else self.R
        rows = self.row_of[p * R: (p + 1) * R]
        off = np.nonzero(rows >= 0)[0]
        return rows[off], off

    def embed(self, X: np.ndarray) -> np.ndarray:
        """Scatter row-space data [D, ...] into position space [D_pad, ...]
        (pads exactly zero). ``extract(embed(X))`` is bit-identical to X."""
        X = np.asarray(X)
        out = np.zeros((self.D_pad,) + X.shape[1:], dtype=X.dtype)
        out[self.pos] = X
        return out

    def extract(self, Xp: np.ndarray) -> np.ndarray:
        """Gather position-space data [D_pad, ...] back to the original
        row order [D, ...] — the eigenvector un-permutation."""
        return np.asarray(Xp)[self.pos]

    def describe(self) -> str:
        sizes = self.block_sizes()
        return (f"RowMap(balance={self.balance}, reorder={self.reorder}, "
                f"P={self.P}, R={self.R}, rows/block "
                f"{int(sizes.min())}..{int(sizes.max())})")

    # ------------------------------------------------------- constructors --

    @classmethod
    def rows(cls, D: int, P: int, d_pad: int | None = None) -> "RowMap":
        """The identity map: the equal-rows partition, block p the rows
        ``[p·R, min((p+1)·R, D))`` with ``R = d_pad / P`` (default
        ``ceil(D/P)``), the pad at the tail."""
        if d_pad is not None and d_pad % P:
            raise ValueError(f"d_pad={d_pad} not divisible by P={P}")
        R = (d_pad if d_pad is not None else (-(-D // P)) * P) // P
        if P * R < D:
            raise ValueError(f"d_pad={d_pad} < D={D}")
        boundaries = np.minimum(np.arange(P + 1, dtype=np.int64) * R, D)
        return cls(D=D, P=P, balance="rows", reorder="none",
                   perm=np.arange(D, dtype=np.int64),
                   boundaries=boundaries, R=R)


# --------------------------------------------------------------------------
# pattern access
# --------------------------------------------------------------------------


def _pattern_csr(matrix, chunk: int = 2_000_000):
    """(indptr, cols) pattern of ``matrix`` in original row order, columns
    sorted (and deduplicated) within each row."""
    if isinstance(matrix, CSR):
        D = matrix.shape[0]
        rows = np.repeat(np.arange(D, dtype=np.int64),
                         np.diff(matrix.indptr))
        cols = matrix.indices.astype(np.int64)
    else:
        D = matrix.D
        parts_r, parts_c = [], []
        for lo in range(0, D, chunk):
            r, c = matrix.row_cols(np.arange(lo, min(lo + chunk, D),
                                             dtype=np.int64))
            parts_r.append(np.asarray(r, dtype=np.int64))
            parts_c.append(np.asarray(c, dtype=np.int64))
        rows = np.concatenate(parts_r)
        cols = np.concatenate(parts_c)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    if len(rows):  # drop duplicate (row, col) pairs — families may emit them
        keep = np.ones(len(rows), dtype=bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(D + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols


def _reordered_pattern(indptr, cols, perm):
    """Pattern re-expressed in reordered space: row r of the output is
    original row ``perm[r]``, with columns mapped through the inverse
    permutation."""
    D = len(indptr) - 1
    inv = np.empty(D, dtype=np.int64)
    inv[perm] = np.arange(D, dtype=np.int64)
    gather, counts = gather_row_entry_idx(indptr, perm)
    indptr_r = np.concatenate([[0], np.cumsum(counts)])
    return indptr_r, inv[cols[gather]]


def equal_cuts(D: int, P: int) -> np.ndarray:
    """The engine's equal-rows block cuts — ``RowMap.rows(D, P).boundaries``:
    ``min(p·ceil(D/P), D)``. This (NOT the round-based
    ``uniform_partition``) is the baseline every planned partition is
    compared against, so the never-worse guard and the degenerate-map
    detection agree with what ``balance="rows"`` actually builds."""
    R = -(-D // P)
    return np.minimum(np.arange(P + 1, dtype=np.int64) * R, D)


# --------------------------------------------------------------------------
# reorder: reverse Cuthill-McKee
# --------------------------------------------------------------------------


def rcm_permutation(matrix, pattern=None) -> np.ndarray:
    """Reverse-Cuthill-McKee row permutation of the symmetric pattern.

    Deterministic: BFS from the lowest-(degree, index) unvisited vertex,
    visiting neighbors in ascending (degree, index) order, final order
    reversed. Returns ``perm`` with ``perm[r]`` = the original row at
    reordered position r, so ``A_reordered[r, s] = A[perm[r], perm[s]]``
    — a similarity transform (eigenvalues unchanged). ``pattern`` may
    carry a precomputed ``(indptr, cols)`` pair to skip the pattern
    pass.
    """
    indptr, cols = pattern if pattern is not None else _pattern_csr(matrix)
    D = len(indptr) - 1
    deg = np.diff(indptr)
    visited = np.zeros(D, dtype=bool)
    order = np.empty(D, dtype=np.int64)
    seeds = np.lexsort((np.arange(D), deg))
    si = 0
    k = 0
    q: deque[int] = deque()
    while k < D:
        while visited[seeds[si]]:
            si += 1
        s = int(seeds[si])
        visited[s] = True
        q.append(s)
        while q:
            u = q.popleft()
            order[k] = u
            k += 1
            nbrs = cols[indptr[u]: indptr[u + 1]]
            nbrs = nbrs[(nbrs != u) & ~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)  # sorted, distinct
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(nbrs.tolist())
    return order[::-1].copy()


def pattern_bandwidth(matrix, perm: np.ndarray | None = None) -> int:
    """max |pos(col) - pos(row)| of the pattern under ``perm`` (identity
    if None) — the quantity RCM minimizes heuristically."""
    indptr, cols = _pattern_csr(matrix)
    D = len(indptr) - 1
    if perm is not None:
        indptr, cols = _reordered_pattern(indptr, cols, perm)
    rows = np.repeat(np.arange(D, dtype=np.int64), np.diff(indptr))
    return int(np.abs(cols - rows).max()) if len(rows) else 0


# --------------------------------------------------------------------------
# balance: comm-volume prefix balancing + greedy cut descent
# --------------------------------------------------------------------------


def _normalize_boundaries(b: np.ndarray, D: int, P: int, cap: int) -> np.ndarray:
    """Project block cuts onto the feasible set: monotone, ≥ 1 row and
    ≤ ``cap`` rows per block (requires P ≤ D ≤ P·cap)."""
    b = b.astype(np.int64).copy()
    b[0], b[P] = 0, D
    for p in range(1, P):          # forward: respect the left neighbor
        b[p] = min(max(b[p], b[p - 1] + 1), b[p - 1] + cap)
    for p in range(P - 1, 0, -1):  # backward: respect the right neighbor
        b[p] = min(max(b[p], b[p + 1] - cap), b[p + 1] - 1)
    sizes = np.diff(b)
    if (sizes < 1).any() or (sizes > cap).any():
        # infeasible request (D < P or cap too tight) — fall back to the
        # equal-rows cuts rather than produce a broken map
        return equal_cuts(D, P)
    return b


class _WireObjective:
    """Engine-exact wire volume of a contiguous block partition of the
    (reordered) pattern, with incremental re-evaluation under single-cut
    moves.

    The per-(sender, receiver) distinct volumes are exactly what
    ``build_dist_ell`` realizes: ``pc[q, p]`` counts the distinct columns
    in block q that rows of block p reference. Receiver p's remote set
    ``S_p`` depends only on p's *own* cuts; the split of ``S_p`` among
    senders is a ``searchsorted`` against the full cut vector. Moving
    one cut therefore only recomputes two remote sets — everything else
    is O(P log nnz).

    The objective is the sum of the engines' per-device moved entries:
    the padded all_to_all's ``P·L`` plus the cyclic and matching round
    sums ``H = Σ_r L_r`` — reducing it reduces what every engine puts on
    the wire.
    """

    def __init__(self, indptr: np.ndarray, cols: np.ndarray, P: int,
                 cost: np.ndarray | None = None):
        self.indptr = indptr
        self.cols = cols
        self.P = P
        #: cumulative per-row cost (len D+1); candidate cut positions are
        #: drawn from its quantiles, so they cluster where the rows that
        #: source halo traffic cluster (hub regions) instead of being
        #: uniformly spaced
        self.cumcost = (np.concatenate([[0.0], np.cumsum(cost)])
                        if cost is not None else None)
        self._shift = None  # value()'s flat [k, q] index, built once

    def remote_set(self, a: int, b: int) -> np.ndarray:
        """Sorted distinct columns outside [a, b) referenced by rows
        [a, b) — receiver block (a, b)'s remote needs."""
        c = self.cols[self.indptr[a]: self.indptr[b]]
        return np.unique(c[(c < a) | (c >= b)])

    def remote_sets(self, bnds: np.ndarray) -> list[np.ndarray]:
        return [self.remote_set(int(bnds[p]), int(bnds[p + 1]))
                for p in range(self.P)]

    def pair_counts(self, bnds: np.ndarray, S: list[np.ndarray]) -> np.ndarray:
        """``pc[q, p]``: the columns of ``S[p]`` in block q. One pass over
        all remote sets: each column's sender block is where it falls
        among the cuts (the same counts as ``diff(searchsorted(S_p,
        bnds))`` receiver by receiver)."""
        P = self.P
        sizes = np.fromiter(map(len, S), dtype=np.int64, count=P)
        if not sizes.any():
            return np.zeros((P, P), dtype=np.int64)
        sender = np.searchsorted(bnds, np.concatenate(S), side="right") - 1
        receiver = np.repeat(np.arange(P), sizes)
        inside = (sender >= 0) & (sender < P)  # outside the cuts: no block
        return np.bincount(sender[inside] * P + receiver[inside],
                           minlength=P * P).reshape(P, P)

    #: above this shard count the descent objective substitutes the
    #: cyclic round sum for the matching one — the greedy matching
    #: decomposition is a Python first-fit over up to P² pairs and the
    #: descent evaluates the objective thousands of times (H_matching ≤
    #: H_cyclic always, so the substitution only over-counts, never
    #: under-counts, the wire)
    MATCHING_EVAL_MAX_P = 32

    def _cyclic(self) -> None:
        """``_shift[k, q]``: the flat index of ``pc[q, (q + k) % P]``."""
        if self._shift is None:
            q = np.arange(self.P)
            self._shift = q[None, :] * self.P + (q[None, :] + q[:, None]) \
                % self.P
            self._q, self._r = self._shift // self.P, self._shift % self.P

    def value(self, pc: np.ndarray) -> tuple[int, int]:
        """(wire, progress): ``wire`` is the engines' moved-entry total
        ``P·L + H_cyclic + H_matching``; ``progress`` (Σ pc², the
        tie-break) rewards splitting *individual* hot pairs even while
        the max-based wire terms are still pinned by other pairs — the
        descent needs it to split several hub regions one cut at a
        time."""
        L = int(pc.max())  # the counts are >= 0
        if L == 0:
            return (0, 0)
        # vectorized cyclic round sum Σ_k max_q pc[q, (q+k) % P] — the
        # descent calls this thousands of times, so it must not build
        # the schedule's permutation tuples
        P = self.P
        self._cyclic()
        flat = pc.reshape(-1)
        # [k, q]: pc[q, (q+k) % P], each shift's maximum along a row
        H_cyc = int(flat[self._shift[1:]].max(axis=1).sum())
        if P <= self.MATCHING_EVAL_MAX_P:
            from .spmv import neighbor_schedule  # spmv imports this module
            H_mat = int(sum(neighbor_schedule(pc, "matching")[1]))
        else:
            H_mat = H_cyc
        flat = flat.astype(np.int64, copy=False)
        return (P * L + H_cyc + H_mat, int(np.dot(flat, flat)))

    def evaluate(self, bnds: np.ndarray, S: list[np.ndarray] | None = None
                 ) -> tuple[tuple[int, int], list[np.ndarray]]:
        S = self.remote_sets(bnds) if S is None else S
        return self.value(self.pair_counts(bnds, S)), S

    def _moved_lines(self, pc: np.ndarray, needs: tuple, bnds: np.ndarray,
                     p: int, c: int, S2: list[np.ndarray]) -> tuple:
        """Rows and columns ``p - 1`` and ``p`` of :meth:`pair_counts`
        after cut ``p`` moves to ``c`` (``[2, P]`` and ``[P, 2]``); every
        other count is ``pc``'s. The columns between the old and the new
        cut change sender block (``needs``: every remote column sorted,
        with its receiver), and receivers ``p - 1`` and ``p``, whose
        remote sets ``S2`` changed, are counted anew."""
        old = int(bnds[p])
        cols, receiver = needs
        i0, i1 = np.searchsorted(cols, (min(old, c), max(old, c)))
        delta = np.bincount(receiver[i0:i1], minlength=self.P)
        rows = pc[p - 1:p + 1].copy()
        if c > old:  # [old, c) moves from block p to block p - 1
            rows[0] += delta
            rows[1] -= delta
        else:
            rows[0] -= delta
            rows[1] += delta
        trial = bnds.copy()
        trial[p] = c
        lines = np.stack([np.diff(np.searchsorted(S2[r], trial))
                          for r in (p - 1, p)], axis=1)
        rows[:, p - 1:p + 1] = lines[p - 1:p + 1]
        return rows, lines

    def _with_lines(self, pc: np.ndarray, p: int, rows, lines) -> np.ndarray:
        out = pc.copy()
        out[p - 1:p + 1] = rows
        out[:, p - 1:p + 1] = lines
        return out

    def _line_base(self, pc: np.ndarray, p: int) -> tuple:
        """What :meth:`value` takes from the counts outside rows and
        columns ``p - 1``, ``p``: their max, their sum of squares and,
        for each cyclic shift k ≥ 1, their max along it; and where along
        each shift the two rows and two columns lie."""
        P = self.P
        self._cyclic()
        live = np.ones(P, dtype=bool)
        live[p - 1:p + 1] = False
        sub = pc[live][:, live].reshape(-1)
        shifted = np.where(live[self._q] & live[self._r],
                           pc.reshape(-1)[self._shift], 0)
        k = np.arange(1, P)
        at = ((p - 1 + k) % P, (p + k) % P, (p - 1 - k) % P, (p - k) % P)
        return (int(sub.max()) if sub.size else 0, int(np.dot(sub, sub)),
                shifted[1:].max(axis=1), at)

    def _lines_value(self, base: tuple, p: int, rows, lines) -> tuple[int, int]:
        """:meth:`value` of the counts ``base`` came from with rows and
        columns ``p - 1``, ``p`` replaced by ``rows`` and ``lines``, where
        P is past ``MATCHING_EVAL_MAX_P`` (the matching term is the cyclic
        one): the same integers, from O(P) of the P² counts."""
        base_L, base_sq, base_k, (a, b, c, d) = base
        L = max(base_L, int(rows.max()), int(lines.max()))
        if L == 0:
            return (0, 0)
        h = np.maximum(base_k, rows[0, a])
        np.maximum(h, rows[1, b], out=h)
        np.maximum(h, lines[c, 0], out=h)
        np.maximum(h, lines[d, 1], out=h)
        r, col = rows.reshape(-1), lines.reshape(-1)
        both = lines[p - 1:p + 1].reshape(-1)
        sq = base_sq + int(np.dot(r, r) + np.dot(col, col)
                           - np.dot(both, both))
        return (self.P * L + 2 * int(h.sum()), sq)

    def _needs(self, S: list[np.ndarray]) -> tuple:
        """Every remote column of ``S`` sorted, with its receiver."""
        cols = np.concatenate(S)
        receiver = np.repeat(np.arange(self.P),
                             np.fromiter(map(len, S), dtype=np.int64,
                                         count=self.P))
        order = np.argsort(cols, kind="stable")
        return cols[order], receiver[order]

    def refine(self, bnds: np.ndarray, cap: int, *, passes: int = 3,
               grid: int = 13) -> tuple[np.ndarray, tuple[int, int]]:
        """Greedy coordinate descent on the P-1 interior cuts: each cut
        tries a coarse grid of feasible positions, then a finer grid
        around the best, and keeps any strict improvement. Deterministic
        (fixed grids, fixed pass count; both scaled down at large P —
        the eval count is O(P·passes·grid))."""
        if self.P > self.MATCHING_EVAL_MAX_P:
            passes = min(passes, 2)
            grid = min(grid, 9)
        b = bnds.astype(np.int64).copy()
        S = self.remote_sets(b)
        pc = self.pair_counts(b, S)
        J, needs = self.value(pc), self._needs(S)
        for _ in range(passes):
            improved = False
            for p in range(1, self.P):
                lo = max(int(b[p - 1]) + 1, int(b[p + 1]) - cap)
                hi = min(int(b[p + 1]) - 1, int(b[p - 1]) + cap)
                if hi <= lo:
                    continue
                span = hi - lo
                best_c, best_J, best_S2, best_pc = int(b[p]), J, None, None
                base = (self._line_base(pc, p)
                        if self.P > self.MATCHING_EVAL_MAX_P else None)
                seen = {int(b[p])}
                for level in range(2):
                    center = best_c
                    width = span if level == 0 else max(span // grid, grid)
                    cands = np.linspace(center - width / 2,
                                        center + width / 2, grid)
                    if level == 0 and self.cumcost is not None:
                        # cost-quantile candidates: equal-cost split points
                        # of the window, clustered inside cost-dense (hub)
                        # stretches a uniform grid would mostly miss
                        clo, chi_ = self.cumcost[lo], self.cumcost[hi]
                        q = clo + (chi_ - clo) * np.arange(1, grid) / grid
                        cands = np.concatenate([
                            cands, np.searchsorted(self.cumcost, q) - 1])
                    cands = np.unique(np.clip(
                        cands.astype(np.int64), lo, hi))
                    for c in cands:
                        c = int(c)
                        if c in seen:
                            continue
                        seen.add(c)
                        S2 = list(S)
                        S2[p - 1] = self.remote_set(int(b[p - 1]), c)
                        S2[p] = self.remote_set(c, int(b[p + 1]))
                        lines = self._moved_lines(pc, needs, b, p, c, S2)
                        Jt = (self._lines_value(base, p, *lines)
                              if base is not None else
                              self.value(self._with_lines(pc, p, *lines)))
                        if Jt < best_J:
                            best_c, best_J, best_S2, best_pc = \
                                c, Jt, S2, lines
                if best_c != int(b[p]) and best_S2 is not None:
                    b[p] = best_c
                    J = best_J
                    S, pc = best_S2, self._with_lines(pc, p, *best_pc)
                    needs = self._needs(S)
                    improved = True
            if not improved:
                break
        return b, J


def commvol_boundaries(matrix, P: int, *, perm: np.ndarray | None = None,
                       alpha: float = 1.0, beta: float = 4.0,
                       sweeps: int = 3, growth: float = 1.5,
                       refine_passes: int = 3,
                       pattern=None) -> np.ndarray:
    """Non-uniform block cuts minimizing the engines' wire volumes.

    Two stages, both deterministic:

    1. **Prefix-balanced seed** — per-row cost ``c(r) = α·nnz(r) +
       β·cut(r)`` where ``cut(r)`` counts entries of (reordered) row r
       whose column lies outside r's current block (the rows that source
       halo traffic). Each of ``sweeps`` iterations recomputes the cut
       counts on the current boundaries and prefix-balances the
       cumulative cost into P equal parts, so cost-dense (hub) stretches
       get fewer rows per block.

    2. **Greedy cut descent** — from both the seed and the equal-rows
       cuts, each interior cut coordinate-descends on the engine-exact
       wire objective ``P·L + H_cyclic + H_matching`` (the per-device
       moved entries of the padded a2a and both neighbor schedules,
       computed from the same distinct per-pair counts
       ``build_dist_ell`` realizes). This is what actually *splits* hot
       structures across cuts — e.g. a hub region's corridor source
       halves its pair pad when a cut lands inside it.

    The equal-rows cuts participate as a candidate, so the result is
    **never worse** than ``balance="rows"`` under this objective.
    ``growth`` caps any block at ``ceil(D/P·growth)`` rows so the padded
    extent ``R = max block size`` stays bounded. ``pattern`` may carry a
    precomputed ``(indptr, cols)`` pair (original row order) to skip the
    pattern pass.
    """
    indptr, cols = pattern if pattern is not None else _pattern_csr(matrix)
    D = len(indptr) - 1
    if perm is not None:
        indptr, cols = _reordered_pattern(indptr, cols, perm)
    if P <= 1 or D <= P:
        return equal_cuts(D, P)
    nnz_row = np.diff(indptr).astype(np.float64)
    row_ids = np.repeat(np.arange(D, dtype=np.int64),
                        np.diff(indptr))
    cap = int(-(-D // P) * growth)
    equal = equal_cuts(D, P)
    bnds = equal
    for _ in range(sweeps):
        blk_row = np.searchsorted(bnds, row_ids, side="right") - 1
        blk_col = np.searchsorted(bnds, cols, side="right") - 1
        cut = np.bincount(row_ids, weights=(blk_col != blk_row),
                          minlength=D)
        cost = alpha * nnz_row + beta * cut
        cum = np.concatenate([[0.0], np.cumsum(cost)])
        targets = cum[-1] * np.arange(1, P, dtype=np.float64) / P
        inner = np.searchsorted(cum, targets, side="left")
        new = _normalize_boundaries(
            np.concatenate([[0], inner, [D]]), D, P, cap)
        if (new == bnds).all():
            break
        bnds = new
    # final per-row cost on the seed boundaries — drives the descent's
    # cost-quantile candidate positions
    blk_row = np.searchsorted(bnds, row_ids, side="right") - 1
    blk_col = np.searchsorted(bnds, cols, side="right") - 1
    cut = np.bincount(row_ids, weights=(blk_col != blk_row), minlength=D)
    obj = _WireObjective(indptr, cols, P, cost=alpha * nnz_row + beta * cut)
    J_equal, _ = obj.evaluate(equal)
    cand: list[tuple[tuple[int, int], np.ndarray]] = [(J_equal, equal)]
    starts = [equal] if (bnds == equal).all() else [bnds, equal]
    for start in starts:
        if refine_passes > 0:
            b_ref, J_ref = obj.refine(start, cap, passes=refine_passes)
            cand.append((J_ref, b_ref))
        else:
            cand.append((obj.evaluate(start)[0], start))
    J_best, best = min(cand, key=lambda t: t[0])
    # never-worse guard: keep the equal-rows cuts unless the descent
    # strictly reduced the wire objective (the Σpc² tie-break alone does
    # not justify a non-uniform map)
    return equal if J_best[0] >= J_equal[0] else best


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------


def plan_rowmap(matrix, P: int, *, balance: str = "rows",
                reorder: str = "none", d_pad: int | None = None,
                block_multiple: int = 1, alpha: float = 1.0,
                beta: float = 4.0, sweeps: int = 3,
                growth: float = 1.5, refine_passes: int = 3,
                pattern=None, sstep: int = 1, plan_mode: str = "exact",
                sample_seed: int = 0,
                sample_fraction: float | None = None) -> RowMap:
    """Plan the row decomposition of ``matrix`` at ``P`` shards.

    ``balance`` ∈ :data:`SPMV_BALANCES` picks the block cuts (equal rows
    vs comm-volume prefix balancing); ``reorder`` ∈ :data:`SPMV_REORDERS`
    optionally applies the RCM permutation first. ``d_pad`` is honored
    only by the identity combination (:meth:`RowMap.rows`);
    planned maps derive their own padding ``R = max block size``,
    rounded up to ``block_multiple`` so callers embedding the map into a
    larger device count (e.g. the dry-run's production mesh) get a
    divisible ``D_pad``. ``pattern`` may carry a precomputed
    ``(indptr, cols)`` pair so callers planning several maps of one
    matrix (the planner's balance × reorder axis) pay the pattern pass
    once. ``sstep`` stamps the ghost-zone depth the map is intended for
    (:attr:`RowMap.sstep`); the cut objective itself stays the depth-1
    wire volume (a proxy for the depth-s one — the stamp is what lets
    ``planner.comm_plan`` warn when a map is scored at a different
    depth, rather than silently under-counting).

    ``plan_mode`` ∈ :data:`PLAN_MODES` selects the exact full-pattern
    pass or the sampled one (``core/sketch.py``:
    ``coarsened_commvol_boundaries`` driven by ``sample_seed`` /
    ``sample_fraction``); ``auto`` resolves via
    :func:`partition_plan_default`. The sampled path supports
    ``balance`` only — ``reorder="rcm"`` needs the full adjacency and
    raises.

    Deterministic: same matrix, same arguments → the same map.
    """
    if int(sstep) < 1:
        raise ValueError(f"sstep must be >= 1, got {sstep}")
    if balance not in SPMV_BALANCES:
        raise ValueError(f"unknown balance {balance!r} "
                         f"(expected one of {SPMV_BALANCES})")
    if reorder not in SPMV_REORDERS:
        raise ValueError(f"unknown reorder {reorder!r} "
                         f"(expected one of {SPMV_REORDERS})")
    if plan_mode not in PLAN_MODES:
        raise ValueError(f"unknown plan_mode {plan_mode!r} "
                         f"(expected one of {PLAN_MODES})")
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if plan_mode == "auto":
        plan_mode = ("exact" if partition_plan_default(matrix, P)
                     else "sampled")
    if balance == "rows" and reorder == "none":
        rm = RowMap.rows(D, P, d_pad)
        if block_multiple > 1 and rm.R % block_multiple:
            R = -(-rm.R // block_multiple) * block_multiple
            rm = RowMap.rows(D, P, R * P)
        rm.sstep = int(sstep)
        return rm
    if plan_mode == "sampled":
        if reorder != "none":
            raise ValueError(
                f"plan_mode='sampled' cannot plan reorder={reorder!r} — "
                f"the RCM pass needs the full adjacency; use "
                f"plan_mode='exact' below the gate or reorder='none'")
        from .sketch import coarsened_commvol_boundaries  # lazy: no cycle

        boundaries = coarsened_commvol_boundaries(
            matrix, P, alpha=alpha, beta=beta, fraction=sample_fraction,
            seed=sample_seed, sweeps=sweeps, growth=growth,
            refine_passes=refine_passes)
        R = max(int(np.diff(boundaries).max()) if P else 0, 1)
        R = -(-R // block_multiple) * block_multiple
        return RowMap(D=D, P=P, balance=balance, reorder=reorder,
                      perm=np.arange(D, dtype=np.int64),
                      boundaries=np.asarray(boundaries, dtype=np.int64),
                      R=R, sstep=int(sstep))
    if pattern is None:
        pattern = _pattern_csr(matrix)
    perm = (rcm_permutation(matrix, pattern=pattern) if reorder == "rcm"
            else np.arange(D, dtype=np.int64))
    if balance == "commvol":
        boundaries = commvol_boundaries(
            matrix, P, perm=perm if reorder == "rcm" else None,
            alpha=alpha, beta=beta, sweeps=sweeps, growth=growth,
            refine_passes=refine_passes, pattern=pattern)
    else:
        boundaries = equal_cuts(D, P)
    R = int(np.diff(boundaries).max()) if P else 0
    R = max(R, 1)
    R = -(-R // block_multiple) * block_multiple
    return RowMap(D=D, P=P, balance=balance, reorder=reorder, perm=perm,
                  boundaries=np.asarray(boundaries, dtype=np.int64), R=R,
                  sstep=int(sstep))
