"""Sampled pattern statistics: streaming-scale planning for D ≥ 10⁷
(the port's copy of ``repro/core/sketch.py``; numpy on the host, held
equal to the original estimate for estimate by
``tests/test_torch_sketch.py``).

The paper's metric χ (Eqs. 8–10) is a *pattern statistic*: it depends on
the sparsity pattern alone, not on any matrix values or executed code.
Statistics subsample — a planner does not need every row to estimate
them. This module is the sampled counterpart of the exact pattern passes
in ``core/partition.py`` / ``core/planner.py``, and is what
``plan_mode="sampled"`` (CLI ``--plan-mode sampled``) routes through:

  * :func:`estimate_comm` — estimate the per-pair distinct volumes
    ``L_qp`` (and from them n_vc, χ₁/χ₂/χ₃) from a seeded row subsample
    with a Horvitz–Thompson-style scale-up, plus an explicit
    **confidence band** per χ metric from deterministic sample folds.
    :meth:`SampledCommEstimate.comm_plan` wraps the estimates in the
    same :class:`~repro_torch.core.planner.SpmvCommPlan` the exact pass
    produces (``exact=False``, estimated ``pair_counts``), so the
    planner's scoring and the compressed-engine schedules consume them
    unchanged.

  * :func:`coarsened_commvol_boundaries` — ``commvol_boundaries``' cut
    descent run on a supernode-coarsened cost graph: rows are bucketed,
    per-bucket ``α·nnz + β·cut`` costs are aggregated from the sample
    (HT-weighted), the descent moves cuts at bucket granularity, and a
    row-granularity refinement pass then polishes the cuts on the
    sampled pattern. The never-worse-than-equal-rows guard is kept
    (under the sampled objective). At ``fraction >= 1`` the sampled
    pattern *is* the exact pattern, so the estimators degrade gracefully
    into their exact counterparts.

The estimator: sample each block's rows without replacement at realized
rate ``r = m/n``. A distinct remote column with row-multiplicity ``d``
(it appears in ``d`` of the block's rows) is *observed* with probability
``π(d) = 1 − (1−r)^d``. We cannot see ``d`` directly, but the observed
mean incidences-per-distinct-column ``μ = t/u`` identifies it:
``E[μ | observed] = d·r / π(d)``, which is strictly increasing in d, so
a bisection inverts it per (sender, receiver) pair. The
Horvitz–Thompson scale-up ``L̂ = u / π(d̂)`` is then clipped to the
logical bounds ``[u, min(t/r, n_sender)]`` (at ``r = 1``: ``L̂ = u``
exactly). Confidence bands come from K deterministic folds of the
sample (fold = rank within the block mod K): the per-fold χ estimates,
the full-sample center, and a Richardson-style extrapolation span an
interval that is padded and advertised at :data:`CONF_LEVEL`.

Everything is deterministic per ``(seed, fraction)``: one
``np.random.default_rng(seed)`` is consumed block-by-block in a fixed
order, so the same call always yields the same plan — the property the
plan cache and the test harness both rely on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..matrices.sparse import CSR, gather_row_entry_idx
from .metrics import ChiMetrics, chi_from_nvc
from .partition import RowMap, _WireObjective, _normalize_boundaries, equal_cuts

__all__ = ["SAMPLE_TARGET_ROWS", "MIN_BLOCK_SAMPLE", "MIN_BUCKET_SAMPLE",
           "DEFAULT_FOLDS", "CONF_LEVEL", "ChiBand", "SampledCommEstimate",
           "default_fraction", "estimate_comm", "sampled_comm_plan",
           "coarsened_commvol_boundaries"]

#: Total sampled rows the default fraction aims for — enough that every
#: block of a P ≤ 64 partition sees thousands of rows, small enough that
#: a D = 10⁷ instance samples under 1% of its rows.
SAMPLE_TARGET_ROWS = 65_536

#: Per-block floor on sampled rows for the χ/L_qp estimator (blocks
#: smaller than this are read in full).
MIN_BLOCK_SAMPLE = 64

#: Per-bucket floor for the coarsened descent's cost aggregation (B is
#: large, so a handful of rows per bucket suffices).
MIN_BUCKET_SAMPLE = 4

#: Fold count of the confidence-band construction.
DEFAULT_FOLDS = 5

#: Advertised coverage of :class:`ChiBand` — the statistical test
#: harness checks the realized coverage over seeds against this rate.
CONF_LEVEL = 0.8

#: Band padding: half-widths are ``_BAND_SPREAD_PAD · (fold spread)``
#: plus ``_BAND_REL_PAD · center`` — the additive relative term keeps
#: zero-spread bands (e.g. fully sampled blocks) honestly non-degenerate.
_BAND_SPREAD_PAD = 0.75
_BAND_REL_PAD = 0.05


def default_fraction(D: int, n_blocks: int = 1) -> float:
    """Sampling fraction targeting :data:`SAMPLE_TARGET_ROWS` rows total
    (with at least :data:`MIN_BLOCK_SAMPLE` expected per block)."""
    target = max(SAMPLE_TARGET_ROWS, MIN_BLOCK_SAMPLE * n_blocks)
    return min(1.0, target / max(int(D), 1))


def _sample_block(rng: np.random.Generator, a: int, b: int,
                  fraction: float, min_rows: int) -> np.ndarray:
    """Sorted distinct row indices sampled from [a, b).

    Draws with replacement and deduplicates — conditioned on its size the
    result is a uniform without-replacement subset, and the draw count
    ``-n·ln(1-f)`` makes the expected distinct count ≈ ``f·n``. The
    realized rate ``m/n`` (not ``f``) feeds the HT scale-up.
    """
    n = int(b) - int(a)
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    want = max(min(n, int(min_rows)), int(np.ceil(fraction * n)))
    if fraction >= 1.0 or want >= n:
        return np.arange(a, b, dtype=np.int64)
    draws = max(int(np.ceil(-n * np.log1p(-want / n))), want)
    return np.unique(rng.integers(a, b, size=draws))


def _rows_cols(matrix, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, col) pattern incidences of ``rows`` for a CSR or a family."""
    rows = np.asarray(rows, dtype=np.int64)
    if isinstance(matrix, CSR):
        gather, counts = gather_row_entry_idx(matrix.indptr, rows)
        return np.repeat(rows, counts), matrix.indices[gather].astype(np.int64)
    r, c = matrix.row_cols(rows)
    return np.asarray(r, dtype=np.int64), np.asarray(c, dtype=np.int64)


def _dedup_pairs(r: np.ndarray, c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (row, col) pairs, sorted by (row, col) — families may emit
    duplicate entries, and the HT multiplicity model counts *rows*."""
    if not len(r):
        return r, c
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.ones(len(r), dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    return r[keep], c[keep]


def _invert_multiplicity(mu: np.ndarray, r: float) -> np.ndarray:
    """Solve ``μ = d·r / (1 − (1−r)^d)`` for the row-multiplicity d ≥ 1.

    The right side is strictly increasing in d (from 1 at d = 1 toward
    ``d·r``), so a vectorized bisection converges unconditionally; the
    upper bracket ``2μ/r`` satisfies ``g(d) ≥ d·r = 2μ ≥ μ``.
    """
    mu = np.maximum(np.asarray(mu, dtype=np.float64), 1.0)
    if r >= 1.0:
        return mu
    log1mr = np.log1p(-r)

    def g(d):
        return d * r / -np.expm1(d * log1mr)

    lo = np.ones_like(mu)
    hi = np.maximum(2.0 * mu / r, 2.0)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        low = g(mid) < mu
        lo = np.where(low, mid, lo)
        hi = np.where(low, hi, mid)
    return 0.5 * (lo + hi)


def _estimate_sender_counts(owner: np.ndarray, col: np.ndarray, r: float,
                            P: int, sender_cap: np.ndarray) -> np.ndarray:
    """Per-sender estimated distinct remote columns of one receiver.

    ``owner``/``col`` are the receiver's deduplicated (sampled row,
    remote col) incidences, reduced to the column's owner block and
    partition-space column id. Per sender the observed distinct count
    ``u`` and incidence count ``t`` give ``μ = t/u``; the inverted
    multiplicity yields the inclusion probability ``π`` and the HT
    estimate ``u/π``, clipped to ``[u, min(t/r, sender size)]``.
    """
    est = np.zeros(P, dtype=np.int64)
    if not len(owner):
        return est
    order = np.lexsort((col, owner))
    o, c = owner[order], col[order]
    new = np.ones(len(o), dtype=bool)
    new[1:] = (o[1:] != o[:-1]) | (c[1:] != c[:-1])
    u = np.bincount(o[new], minlength=P).astype(np.float64)
    t = np.bincount(o, minlength=P).astype(np.float64)
    nz = u > 0
    if not nz.any():
        return est
    if r >= 1.0:
        est[nz] = u[nz].astype(np.int64)
        return est
    d = _invert_multiplicity(t[nz] / u[nz], r)
    pi = -np.expm1(d * np.log1p(-r))
    raw = u[nz] / np.maximum(pi, 1e-300)
    hi = np.maximum(u[nz], np.minimum(t[nz] / r, sender_cap[nz]))
    est[nz] = np.round(np.clip(raw, u[nz], hi)).astype(np.int64)
    return est


# --------------------------------------------------------------------------
# sampled χ / L_qp estimation with confidence bands
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChiBand:
    """Per-metric confidence intervals of a sampled χ estimate."""

    level: float
    chi1: tuple[float, float]
    chi2: tuple[float, float]
    chi3: tuple[float, float]

    def valid(self) -> bool:
        """Structural validity: advertised level in (0, 1), lo ≤ hi."""
        return (0.0 < self.level < 1.0
                and all(lo <= hi and lo >= 0.0
                        for lo, hi in (self.chi1, self.chi2, self.chi3)))

    def contains(self, chi: ChiMetrics) -> bool:
        """Whether every metric of ``chi`` falls inside its interval."""
        return all(lo <= v <= hi for v, (lo, hi) in
                   ((chi.chi1, self.chi1), (chi.chi2, self.chi2),
                    (chi.chi3, self.chi3)))


@dataclasses.dataclass(frozen=True)
class SampledCommEstimate:
    """Sampled communication statistics of one partition of one matrix.

    ``pair_counts[q, p]`` is the estimated distinct-column volume sender
    q ships receiver p; ``n_vc`` its column sums (the estimated Eq. 5
    counts), ``chi`` the χ metrics on the real per-block row counts
    ``n_vm``, and ``band`` the per-metric confidence intervals.
    """

    n_row: int
    D: int
    fraction: float
    seed: int
    sampled_rows: int
    pair_counts: np.ndarray
    n_vc: np.ndarray
    n_vm: np.ndarray
    chi: ChiMetrics
    band: ChiBand
    d_pad: int | None = None
    rowmap: RowMap | None = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def L(self) -> int:
        """Estimated max per-pair volume — the a2a engine's pad."""
        return int(self.pair_counts.max()) if self.pair_counts.size else 0

    def comm_plan(self):
        """The estimate as a :class:`~repro_torch.core.planner.SpmvCommPlan`
        (``exact=False`` but with per-pair counts, so the planner can
        rank the compressed engines on it)."""
        from .planner import SpmvCommPlan  # lazy: planner imports us lazily

        return SpmvCommPlan(self.n_row, self.D, self.L, self.n_vc, False,
                            self.d_pad, pair_counts=self.pair_counts,
                            rowmap=self.rowmap)


def _partition_geometry(matrix, n_row: int, d_pad: int | None,
                        rowmap: RowMap | None):
    """(boundaries, R, n_vm, perm, pos, d_pad) of the sampling space.

    Without a rowmap the space is the natural row order with the
    equal-rows ``Partition`` cuts; with one it is the *reordered* row
    order (block g = reordered rows ``[bnd[g·k], bnd[(g+1)·k])``, which
    is contiguous for any level with ``rowmap.P % n_row == 0``), with
    columns mapped through the position embed.
    """
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if rowmap is not None and not rowmap.identity:
        if rowmap.D != D:
            raise ValueError("rowmap.D does not match the matrix")
        if rowmap.P % n_row:
            raise ValueError(f"rowmap planned at P={rowmap.P} cannot be "
                             f"sampled at level n_row={n_row} "
                             f"(P % n_row != 0)")
        k = rowmap.P // n_row
        bnds = rowmap.boundaries[::k].astype(np.int64)
        R = rowmap.level_R(n_row)
        return bnds, R, np.diff(bnds), rowmap.perm, rowmap.pos, rowmap.D_pad
    R = (d_pad // n_row) if d_pad is not None else -(-D // n_row)
    bnds = np.minimum(np.arange(n_row + 1, dtype=np.int64) * R, D)
    return bnds, R, np.diff(bnds), None, None, d_pad


def estimate_comm(matrix, n_row: int, *, d_pad: int | None = None,
                  rowmap: RowMap | None = None, fraction: float | None = None,
                  seed: int = 0, folds: int = DEFAULT_FOLDS
                  ) -> SampledCommEstimate:
    """Estimate per-pair volumes and χ of ``matrix`` at ``n_row`` shards
    from a seeded row subsample (see the module docstring for the
    estimator). ``rowmap`` evaluates the planned partition instead of
    the equal-rows one — the sampled analogue of
    ``planner.comm_plan(rowmap=...)``. Deterministic per
    ``(seed, fraction)``.
    """
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    P = int(n_row)
    bnds, R, n_vm, perm, pos, d_pad_out = _partition_geometry(
        matrix, P, d_pad, rowmap)
    zero_chi = chi_from_nvc(np.zeros(max(P, 1), np.int64), n_vm, D)
    if P <= 1:
        band = ChiBand(CONF_LEVEL, (0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
        return SampledCommEstimate(
            1, D, 1.0, seed, 0, np.zeros((1, 1), np.int64),
            np.zeros(1, np.int64), n_vm, zero_chi, band, d_pad_out,
            rowmap if rowmap is not None and not rowmap.identity else None)
    if fraction is None:
        fraction = default_fraction(D, P)
    folds = max(int(folds), 1)
    rng = np.random.default_rng(seed)
    cap = n_vm.astype(np.float64)
    pair_counts = np.zeros((P, P), dtype=np.int64)
    n_vc_fold = np.zeros((folds, P), dtype=np.int64)
    fold_rate = np.ones((folds, P), dtype=np.float64)
    sampled_total = 0
    for p in range(P):
        a, b = int(bnds[p]), int(bnds[p + 1])
        idx = _sample_block(rng, a, b, fraction, MIN_BLOCK_SAMPLE)
        m = idx.size
        if m == 0:
            continue
        sampled_total += m
        rate = m / (b - a)
        fold_of = np.arange(m, dtype=np.int64) % folds
        rows_fetch = perm[idx] if perm is not None else idx
        rinc, cinc = _rows_cols(matrix, rows_fetch)
        if pos is not None:
            cpart = pos[cinc]
        else:
            cpart = cinc
        # keep remote incidences only, dedup per (row, col)
        owner_inc = np.minimum(cpart // R, P - 1)
        keep = owner_inc != p
        rinc, cpart = _dedup_pairs(rinc[keep], cpart[keep])
        owner_inc = np.minimum(cpart // R, P - 1)
        # fold of each incidence, via the sampled-row rank (rows_fetch is
        # unsorted under a reorder perm: argsort + searchsorted)
        if perm is not None:
            o = np.argsort(rows_fetch, kind="stable")
            rank = o[np.searchsorted(rows_fetch[o], rinc)]
        else:
            rank = np.searchsorted(rows_fetch, rinc)
        finc = fold_of[rank]
        pair_counts[:, p] = _estimate_sender_counts(
            owner_inc, cpart, rate, P, cap)
        for k in range(folds):
            mk = int((fold_of == k).sum())
            if mk == 0:
                continue
            fold_rate[k, p] = mk / (b - a)
            sel = finc == k
            n_vc_fold[k, p] = _estimate_sender_counts(
                owner_inc[sel], cpart[sel], fold_rate[k, p], P, cap).sum()
    n_vc = pair_counts.sum(axis=0)
    center = chi_from_nvc(n_vc, n_vm, D)
    fold_chis = [chi_from_nvc(n_vc_fold[k], n_vm, D) for k in range(folds)]
    intervals = {}
    for metric in ("chi1", "chi2", "chi3"):
        cv = getattr(center, metric)
        fv = np.array([getattr(fc, metric) for fc in fold_chis])
        vals = np.concatenate([fv, [cv, 2.0 * cv - fv.mean()]])
        spread = float(vals.max() - vals.min())
        pad = _BAND_SPREAD_PAD * spread + _BAND_REL_PAD * cv
        intervals[metric] = (max(0.0, float(vals.min()) - pad),
                             float(vals.max()) + pad)
    band = ChiBand(CONF_LEVEL, intervals["chi1"], intervals["chi2"],
                   intervals["chi3"])
    return SampledCommEstimate(
        P, D, float(fraction), int(seed), sampled_total, pair_counts,
        n_vc, n_vm, center, band, d_pad_out,
        rowmap if rowmap is not None and not rowmap.identity else None)


def sampled_comm_plan(matrix, n_row: int, *, d_pad: int | None = None,
                      rowmap: RowMap | None = None,
                      fraction: float | None = None, seed: int = 0):
    """:func:`estimate_comm` wrapped as the ``SpmvCommPlan`` the planner
    scores — the drop-in sampled replacement for ``comm_plan``."""
    return estimate_comm(matrix, n_row, d_pad=d_pad, rowmap=rowmap,
                         fraction=fraction, seed=seed).comm_plan()


# --------------------------------------------------------------------------
# coarsened commvol descent
# --------------------------------------------------------------------------


def coarsened_commvol_boundaries(matrix, P: int, *, alpha: float = 1.0,
                                 beta: float = 4.0,
                                 fraction: float | None = None,
                                 seed: int = 0, n_buckets: int | None = None,
                                 sweeps: int = 3, growth: float = 1.5,
                                 refine_passes: int = 3) -> np.ndarray:
    """``commvol_boundaries`` on a bucket-coarsened, row-sampled cost
    graph: non-uniform block cuts without a full pattern pass.

    Three deterministic stages:

    1. **HT-weighted prefix balance** — rows are bucketed into
       ``B ≈ 64·P`` equal supernodes; each bucket's cost
       ``Σ w_r (α·nnz(r) + β·cut(r))`` is aggregated from its sampled
       rows (weight ``w_r`` = inverse realized sampling rate) and
       re-swept as cuts move, exactly like the exact planner's seed.
    2. **Coarse cut descent** — the ``_WireObjective`` greedy descent in
       bucket-index space on the bucket-level sampled pattern (unique
       (row bucket, col bucket) pairs), from both the prefix seed and
       the equal bucket cuts.
    3. **Row-granularity refinement** — the same descent on the sampled
       pattern laid out at full row resolution (only sampled rows carry
       entries), polishing the coarse cuts to row precision.

    The equal-rows cuts participate as a candidate throughout and win
    ties, so the result is never worse than ``balance="rows"`` *under
    the sampled objective*. At ``fraction >= 1`` stage 3 sees the exact
    pattern and the descent matches ``commvol_boundaries``' quality.
    """
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if P <= 1 or D <= P:
        return equal_cuts(D, P)
    equal = equal_cuts(D, P)
    B = int(n_buckets) if n_buckets else min(D, max(64 * P, 1024))
    bedges = equal_cuts(D, B)
    if fraction is None:
        fraction = default_fraction(D, B)
    rng = np.random.default_rng(seed)
    idx_parts = []
    w_parts = []
    for bkt in range(B):
        a, b = int(bedges[bkt]), int(bedges[bkt + 1])
        s = _sample_block(rng, a, b, fraction, MIN_BUCKET_SAMPLE)
        if s.size:
            idx_parts.append(s)
            w_parts.append(np.full(s.size, (b - a) / s.size))
    if not idx_parts:
        return equal
    srows = np.concatenate(idx_parts)           # sorted distinct rows
    w = np.concatenate(w_parts)                 # HT weight per sampled row
    rinc, cinc = _dedup_pairs(*_rows_cols(matrix, srows))
    if not len(rinc):
        return equal
    rank = np.searchsorted(srows, rinc)         # sampled-row id of each inc.
    n_s = srows.size
    nnz_s = np.bincount(rank, minlength=n_s).astype(np.float64)
    bucket_of = np.searchsorted(bedges, srows, side="right") - 1
    cap = int(-(-D // P) * growth)

    def row_costs(bnds: np.ndarray) -> np.ndarray:
        blk_row = np.searchsorted(bnds, srows, side="right") - 1
        blk_col = np.searchsorted(bnds, cinc, side="right") - 1
        cut = np.bincount(rank, weights=(blk_col != blk_row[rank]),
                          minlength=n_s)
        return w * (alpha * nnz_s + beta * cut)

    # stage 1: HT-weighted prefix balance over bucket costs
    bnds = equal
    cost_s = row_costs(bnds)
    for _ in range(sweeps):
        cb = np.bincount(bucket_of, weights=cost_s, minlength=B)
        cum = np.concatenate([[0.0], np.cumsum(cb)])
        targets = cum[-1] * np.arange(1, P, dtype=np.float64) / P
        inner = bedges[np.clip(np.searchsorted(cum, targets, side="left"),
                               0, B)]
        new = _normalize_boundaries(
            np.concatenate([[0], inner, [D]]), D, P, cap)
        if (new == bnds).all():
            break
        bnds = new
        cost_s = row_costs(bnds)

    # stage 2: coarse descent on the bucket-level sampled pattern
    brow = bucket_of[rank]
    bcol = np.searchsorted(bedges, cinc, side="right") - 1
    bpair_r, bpair_c = _dedup_pairs(brow, bcol)
    indptr_b = np.concatenate(
        [[0], np.cumsum(np.bincount(bpair_r, minlength=B))])
    cb = np.bincount(bucket_of, weights=cost_s, minlength=B)
    obj_b = _WireObjective(indptr_b.astype(np.int64),
                           bpair_c.astype(np.int64), P, cost=cb)
    cap_b = max(int(-(-B // P) * growth), 2)
    seed_b = _normalize_boundaries(
        np.searchsorted(bedges, bnds), B, P, cap_b)
    starts_b = [seed_b, equal_cuts(B, P)]
    coarse = []
    for start in starts_b:
        b_ref, _ = obj_b.refine(start, cap_b, passes=max(refine_passes, 1))
        coarse.append(_normalize_boundaries(bedges[b_ref], D, P, cap))

    # stage 3: row-granularity refinement on the sampled pattern at full
    # row resolution (only sampled rows carry entries/cost)
    indptr_s = np.concatenate(
        [[0], np.cumsum(np.bincount(rinc, minlength=D))]).astype(np.int64)
    cost_vec = np.zeros(D, dtype=np.float64)
    cost_vec[srows] = cost_s
    obj = _WireObjective(indptr_s, cinc, P, cost=cost_vec)
    J_equal, _ = obj.evaluate(equal)
    cand: list[tuple[tuple[int, int], np.ndarray]] = [(J_equal, equal)]
    seen_starts = {tuple(equal)}
    for start in [*coarse, bnds]:
        key = tuple(int(x) for x in start)
        if key in seen_starts:
            continue
        seen_starts.add(key)
        if refine_passes > 0:
            b_ref, J_ref = obj.refine(start, cap, passes=refine_passes)
            cand.append((J_ref, b_ref))
        else:
            cand.append((obj.evaluate(start)[0], start))
    J_best, best = min(cand, key=lambda t: t[0])
    # never-worse guard (sampled objective): keep the equal cuts unless
    # the descent strictly reduced the wire objective
    return equal if J_best[0] >= J_equal[0] else best
