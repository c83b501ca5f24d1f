"""Sparse matrix–(multiple)-vector multiplication over P row shards.

Host side (:func:`build_dist_ell`): given a matrix family (or CSR) and the
number of row shards P, build, as the reference's ``build_dist_ell``
(``repro/core/spmv.py:534-663``) builds them,

* row blocks of a row map (``core/partition.py``): the equal-rows
  partition, R = ceil(D/P) (the tail block zero-padded to ``D_pad =
  P·R``), unless a planned map is given;
* per-shard ELL blocks ``cols/vals [P, R, W]`` with *remapped* columns:
  local columns map to ``[0, R)``, remote ones into the halo region
  ``[R, R + P·L)``, and per row the slots are ordered by remapped column
  (local ascending, then halo by sender and slot), padded with column 0
  and value 0;
* the communication plan: for every (sender q → receiver p) pair the
  sorted local rows q ships to p (``send_idx [P, P, L]``, padded to the
  largest pair L), the true pair volumes ``pair_counts`` and the per-shard
  remote counts ``n_vc``;
* on demand, the split-phase form (:meth:`DistEll.split`) and the
  compressed engine's neighbour schedule (:meth:`DistEll.neighbor_plan`,
  :func:`neighbor_schedule`, the round-pipelined sub-blocks).

At P = 1 this is the one-shard ELL block of the first slice, with the
stored entries of each row in ascending column order. The operator is
built in the map's position space: shard p owns the rows the map places
at positions ``[p·R, (p+1)·R)``; on a planned map (commvol cuts, RCM
order) the split, the neighbour plans and the engines work unchanged.

Device side (:func:`make_spmv`, :func:`make_fused_cheb_step`): the
reference's ``shard_map`` bodies (``spmv.py:781-1187``) over the port's
:class:`~repro_torch.core.shards.ShardGroup`. Eight engines:

* ``comm="a2a"``: one ``all_to_all`` padded to L, then the ELL block
  against ``[x_p ‖ halo]`` (plain), or the exchange on a side stream while
  the local block contracts, then the halo block (``overlap``);
* ``comm="compressed"`` with ``schedule="cyclic"`` or ``"matching"``: one
  gather + ``ppermute`` round per scheduled permutation, each padded only
  to its own largest pair; plain, ``overlap``, or ``overlap`` with
  ``pipeline`` (round r's completed rows contract against the prefix of
  the receive buffer while later rounds are in flight).

Each block goes through one launch of the CUDA ELL kernel for all P
shards on the card (``kernels/ell_gather.py::EllLaunch``, on the shards'
stacked padding-free form), its plain version for all of them on the CPU
(with ``use_kernel=False`` the plain version everywhere), with the
accumulator threaded as ``y0``, in the reference's block order, so within
every row the products are added in the same order in every engine and
all eight agree bit for bit. A
fused step hands its epilogue ``2a·y + 2b·w1 − w2`` to the last block's
launch (the ``ell_gather_cheb`` entry); a comm-free operator (P = 1 or
L = 0) runs the whole step per shard in the DIA kernel when
``ops.plan_dia`` accepts every shard (``spmv.py:1002-1027``).

The s-step filter (:func:`build_sstep_ell`, :func:`make_sstep_cheb`; the
reference's ``spmv.py:1195-1791``) extends each shard's block by its
depth-s ghost zone, ``[R + G, W_i]`` for step i of a group: one exchange
ships the ghosts (the previous group's last two steps, ``[w1 | w2]``),
then s steps run on the extended blocks, each one kernel launch for all
shards, each row's products in its home shard's slot order, so a filter
runs ⌈n/s⌉ exchanges and returns the s = 1 filter's bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops, plan, ref
from ..kernels.ell_gather import EllLaunch
from ..kernels.plan import span_of
from ..matrices.families import MatrixFamily
from ..matrices.matfree import collect_row_entries
from ..matrices.sparse import CSR, gather_row_entry_idx
from .partition import RowMap
from .shards import ShardGroup

__all__ = ["DistEll", "NeighborPlan", "build_dist_ell",
           "make_spmv", "make_fused_cheb_step", "neighbor_schedule",
           "value_dtype", "SPMV_COMM_ENGINES", "SPMV_SCHEDULES",
           "SstepEll", "SstepNeighbor", "build_sstep_ell", "make_sstep_cheb",
           "sstep_ghosts"]

#: Horizontal-layer communication engines of ``make_spmv``.
SPMV_COMM_ENGINES = ("a2a", "compressed")

#: Round schedulers of the compressed engine (``make_spmv(schedule=...)``).
SPMV_SCHEDULES = ("cyclic", "matching")


def neighbor_schedule(pair_counts: np.ndarray, schedule: str = "cyclic",
                      ) -> tuple[tuple[tuple[tuple[int, int], ...], ...],
                                 tuple[int, ...]]:
    """Decompose the pair-volume matrix into the compressed engine's
    permutation rounds (the port's copy of the reference's
    ``neighbor_schedule``, ``repro/core/spmv.py:122-201``).

    Returns ``(perms, round_L)`` for true per-pair volumes
    ``pair_counts[q, p]`` (sender q → receiver p): ``perms[r]`` is round
    r's permutation, a tuple of ``(src, dst)`` pairs in which every shard
    appears at most once as source and once as destination, and
    ``round_L[r]`` the round's pad, the largest volume among its pairs.

    ``"cyclic"``: one round per cyclic shift k with a nonzero pair, the
    full shift permutation padded to that shift's largest pair.
    ``"matching"``: nonzero pairs in descending volume, first-fit into the
    earliest round where both ends are free (greedy max-weight
    matchings); the cyclic rounds are returned instead should they move
    less, so ``H_matching <= H_cyclic``.
    """
    pc = np.asarray(pair_counts)
    P = pc.shape[0]
    q = np.arange(P)
    cyc_perms, cyc_L = [], []
    for k in range(1, P):
        Lk = int(pc[q, (q + k) % P].max())
        if Lk:
            cyc_perms.append(tuple((j, int((j + k) % P)) for j in range(P)))
            cyc_L.append(Lk)
    cyclic = (tuple(cyc_perms), tuple(cyc_L))
    if schedule == "cyclic":
        return cyclic
    if schedule != "matching":
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"(expected one of {SPMV_SCHEDULES})")
    pairs = sorted(((int(pc[s, d]), s, d)
                    for s in range(P) for d in range(P)
                    if s != d and pc[s, d]),
                   key=lambda t: (-t[0], t[1], t[2]))
    rounds: list[dict] = []
    for w, s, d in pairs:
        for r in rounds:
            if s not in r["src"] and d not in r["dst"]:
                break
        else:
            r = dict(src=set(), dst=set(), pairs=[], L=w)
            rounds.append(r)
        r["src"].add(s)
        r["dst"].add(d)
        r["pairs"].append((s, d))
    perms = tuple(tuple(sorted(r["pairs"])) for r in rounds)
    round_L = tuple(r["L"] for r in rounds)
    if sum(round_L) > sum(cyc_L):
        return cyclic  # never schedule worse than the cyclic rounds
    return perms, round_L


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------


def value_dtype(dtype, is_complex: bool) -> np.dtype:
    """The working dtype of an operator: ``dtype`` (float64, float32,
    complex128 or complex64), promoted to the complex type of its
    precision when the entries are complex, as the reference's
    ``FilterDiag`` promotes (``repro/core/filter_diag.py:166-168``)."""
    dt = np.dtype(dtype)
    if dt not in (np.float64, np.float32, np.complex128, np.complex64):
        raise ValueError(f"dtype {dt}: expected float64, float32, complex128 "
                         "or complex64")
    if is_complex and dt.kind == "f":
        dt = np.dtype(np.complex128 if dt == np.float64 else np.complex64)
    return dt


@dataclasses.dataclass
class NeighborPlan:
    """Static schedule of the compressed halo exchange (the reference's
    ``NeighborPlan``): round r applies the partial permutation
    ``perms[r]``, every send segment padded to ``round_L[r]`` slots, and
    the received segments concatenate, round-major, into a compact halo
    buffer of ``H = Σ round_L`` rows.

    ``send_nbr [P, H]`` holds the local rows each shard ships, round by
    round; ``cols_nbr [P, R, W]`` the combined block with halo columns
    re-based into ``[R, R + H)``; for the split-phase engines
    ``cols_halo_nbr [P, R, W_halo]`` the halo block re-based into
    ``[0, H)`` and ``halo_rounds`` one ``(cols_r, vals_r)`` sub-block per
    round, holding complete, in slot order, every halo row whose last
    needed sender lands in round r (its columns stay below
    ``Σ round_L[:r+1]``)."""

    perms: tuple
    round_L: tuple
    send_nbr: torch.Tensor
    cols_nbr: torch.Tensor
    cols_halo_nbr: torch.Tensor | None = None
    halo_rounds: tuple | None = None

    @property
    def H(self) -> int:
        """Rows each shard receives per SpMV column (Σ_r L_r)."""
        return int(sum(self.round_L))

    def scheduled_pairs(self) -> tuple[tuple[int, int], ...]:
        """Every ``(src, dst)`` pair of every round, in round order (what
        ``repro_torch.analysis.plan_lint`` reads)."""
        return tuple(p for perm in self.perms for p in perm)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pack(mask, cols, vals, out_cols, out_vals, rebase: int = 0) -> None:
    """Move the entries ``mask`` selects (``[rows, W]``) to the front of
    their rows of ``out_cols/out_vals``, in slot order, their columns less
    ``rebase``."""
    rows, slots = np.nonzero(mask)
    if not len(rows):
        return
    counts = np.bincount(rows, minlength=mask.shape[0])
    out_slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    out_cols[rows, out_slot] = cols[rows, slots] - rebase
    out_vals[rows, out_slot] = vals[rows, slots]


def _round_plan(pair_counts, send_idx: np.ndarray, schedule: str):
    """``(perms, round_L, off_by_pair, send_nbr)`` of the compressed
    exchange over ``pair_counts``: the rounds and their pads, each
    scheduled pair's offset into the round-concatenated receive buffer
    (−1: in no round) and ``send_nbr [P, max(H, 1)]``, the rows each
    shard ships round by round (from ``send_idx [P, P, L]``)."""
    perms, round_L = neighbor_schedule(pair_counts, schedule)
    P = send_idx.shape[0]
    off_by_pair = np.full((P, P), -1, dtype=np.int64)
    send_nbr = np.zeros((P, max(int(sum(round_L)), 1)), dtype=np.int32)
    H = 0
    for perm, Lk in zip(perms, round_L):
        for s, d in perm:
            off_by_pair[s, d] = H
            send_nbr[s, H:H + Lk] = send_idx[s, d, :Lk]
        H += Lk
    return perms, round_L, off_by_pair, send_nbr


@dataclasses.dataclass
class DistEll:
    """The distributed ELL operator over P row shards, on one device.

    ``cols`` int32 / ``vals`` ``[P, R, W]`` (remapped columns),
    ``send_idx`` int32 ``[P, P, L]``; ``n_vc`` (remote columns per shard)
    and ``pair_counts`` (``[P, P]`` true volumes, sender q → receiver p)
    are host arrays. ``span`` is ``max |col − row|`` of the matrix's
    stored entries in position numbering (the global one on the
    equal-rows partition; the DIA kernel's slab rule reads the same of
    its plan).
    ``rowmap`` is the row map the operator was built on
    (``RowMap.rows``, the identity, for the equal-rows partition).
    The split-phase form and the neighbour plans are built on demand and
    cached.

    The device tensors hold the shards ``[first, first + n_loc)``: all P
    as built, the one shard of a rank after :meth:`held_by` (whose
    ``host`` is the whole operator on the host, from which the split and
    the neighbour plans are sliced). ``send_idx`` holds the plan rows of
    those shards, ``[n_loc, P, L]``."""

    cols: torch.Tensor
    vals: torch.Tensor
    send_idx: torch.Tensor
    R: int
    L: int
    P: int
    D: int
    n_vc: np.ndarray | None = None
    pair_counts: np.ndarray | None = None
    span: int = 0
    cols_loc: torch.Tensor | None = None
    vals_loc: torch.Tensor | None = None
    cols_halo: torch.Tensor | None = None
    vals_halo: torch.Tensor | None = None
    nbr: dict | None = None
    rowmap: RowMap | None = None
    first: int = 0
    host: "DistEll | None" = None

    @property
    def W(self) -> int:
        return int(self.cols.shape[2])

    @property
    def n_loc(self) -> int:
        """The shards whose blocks this operator holds on its device."""
        return int(self.cols.shape[0])

    def held_by(self, group: ShardGroup) -> "DistEll":
        """The operator of the shards ``group`` holds, on its device:
        this one when it holds exactly those there (one process); else
        (a rank) those shards' blocks and plan rows copied from this
        whole operator, which stays on the host as ``host``."""
        if group.P != self.P:
            raise ValueError(f"{group} does not match the operator's "
                             f"{self.P} shards")
        if (group.first, group.n_loc, group.device) == (
                self.first, self.n_loc, self.device):
            return self
        if self.n_loc != self.P:
            raise ValueError("take a rank's shards from the whole operator")
        sl, dev = slice(group.first, group.first + group.n_loc), group.device
        out = DistEll(cols=self.cols[sl].to(dev), vals=self.vals[sl].to(dev),
                      send_idx=self.send_idx[sl].to(dev), R=self.R, L=self.L,
                      P=self.P, D=self.D, n_vc=self.n_vc,
                      pair_counts=self.pair_counts, span=self.span,
                      rowmap=self.rowmap, first=group.first, host=self)
        if self.cols_loc is not None:
            out.split()
        return out

    def _held(self, t: torch.Tensor) -> torch.Tensor:
        """The held shards' rows of a ``[P, ...]`` tensor of ``host``, on
        this operator's device."""
        return t[self.first:self.first + self.n_loc].to(self.device)

    @property
    def D_pad(self) -> int:
        return self.P * self.R

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def comm_bytes_per_spmv(self) -> int:
        """``all_to_all`` payload per vector column, summed over shards."""
        return self.P * self.P * self.L * self.vals.element_size()

    @property
    def halo_nnz_fraction(self) -> float:
        """Fraction of the stored entries in the halo part."""
        stored = self.vals != 0
        n_halo = int((stored & (self.cols >= self.R)).sum())
        return n_halo / max(int(stored.sum()), 1)

    def split(self):
        """``(cols_loc, vals_loc, cols_halo, vals_halo)``: the local part
        (columns in ``[0, R)``) and the halo part (columns re-based into
        the receive buffer, ``[0, P·L)``), each row in the combined slot
        order; cached. ``W_loc`` is at least 1. A rank's operator slices
        its shards' blocks from ``host``'s."""
        if self.cols_loc is not None:
            return self.cols_loc, self.vals_loc, self.cols_halo, self.vals_halo
        if self.host is not None:
            (self.cols_loc, self.vals_loc, self.cols_halo,
             self.vals_halo) = (self._held(t) for t in self.host.split())
            return self.cols_loc, self.vals_loc, self.cols_halo, self.vals_halo
        cols, vals = _np(self.cols), _np(self.vals)
        P, R, W = cols.shape
        stored = vals != 0
        is_halo = stored & (cols >= self.R)
        is_loc = stored & ~is_halo
        W_loc = int(is_loc.sum(axis=2).max()) if W else 0
        W_halo = int(is_halo.sum(axis=2).max()) if W else 0
        W_loc = max(W_loc, 1)  # keep the local block non-degenerate
        cols_loc = np.zeros((P, R, W_loc), dtype=cols.dtype)
        vals_loc = np.zeros((P, R, W_loc), dtype=vals.dtype)
        cols_halo = np.zeros((P, R, W_halo), dtype=cols.dtype)
        vals_halo = np.zeros((P, R, W_halo), dtype=vals.dtype)
        for p in range(P):
            _pack(is_loc[p], cols[p], vals[p], cols_loc[p], vals_loc[p])
            _pack(is_halo[p], cols[p], vals[p], cols_halo[p], vals_halo[p],
                  self.R)
        dev = self.device
        self.cols_loc = torch.as_tensor(cols_loc, device=dev)
        self.vals_loc = torch.as_tensor(vals_loc, device=dev)
        self.cols_halo = torch.as_tensor(cols_halo, device=dev)
        self.vals_halo = torch.as_tensor(vals_halo, device=dev)
        return self.cols_loc, self.vals_loc, self.cols_halo, self.vals_halo

    # ------------------------------------------------- compressed engine --

    def _round_plan(self, schedule: str):
        """:func:`_round_plan` of the operator's pair volumes."""
        if self.pair_counts is None:
            raise ValueError("the compressed engine needs per-pair volumes; "
                             "build the operator with build_dist_ell")
        return _round_plan(self.pair_counts, _np(self.send_idx), schedule)

    def _rebase_halo(self, cols, vals, halo_mask_base, off_by_pair, base):
        """Re-base halo columns ``halo_mask_base + q·L + slot`` (the a2a
        receive layout) into ``base + off(q, p) + slot`` (the compact
        round buffer), touching only stored entries, so the slot order is
        unchanged."""
        out = []
        for p in range(self.P):
            cp = cols[p].copy()
            halo = (vals[p] != 0) & (cp >= halo_mask_base)
            if halo.any():
                c = cp[halo] - halo_mask_base
                q, slot = c // self.L, c % self.L
                off = off_by_pair[q, p]
                if (off < 0).any():
                    raise AssertionError("stored halo entry in no round")
                cp[halo] = (base + off + slot).astype(cp.dtype)
            out.append(cp)
        return np.stack(out)

    def neighbor_plan(self, split_halo: bool = False,
                      schedule: str = "cyclic") -> NeighborPlan:
        """The compressed engine's schedule and re-based blocks, cached per
        scheduler; ``split_halo`` also builds the split-phase halo block and
        the round-pipelined sub-blocks. A rank's operator slices its shards'
        rows from ``host``'s plan."""
        if self.nbr is None:
            self.nbr = {}
        nplan = self.nbr.get(schedule)
        dev = self.device
        if self.host is not None:
            if nplan is None or (split_halo and nplan.cols_halo_nbr is None):
                hp = self.host.neighbor_plan(split_halo, schedule)
                nplan = NeighborPlan(
                    perms=hp.perms, round_L=hp.round_L,
                    send_nbr=self._held(hp.send_nbr),
                    cols_nbr=self._held(hp.cols_nbr),
                    cols_halo_nbr=(None if hp.cols_halo_nbr is None
                                   else self._held(hp.cols_halo_nbr)),
                    halo_rounds=(None if hp.halo_rounds is None else tuple(
                        (self._held(c), self._held(v))
                        for c, v in hp.halo_rounds)))
                self.nbr[schedule] = nplan
            return nplan
        if nplan is None:
            perms, round_L, off_by_pair, send_nbr = self._round_plan(schedule)
            cols_nbr = self._rebase_halo(_np(self.cols), _np(self.vals),
                                         self.R, off_by_pair, self.R)
            nplan = NeighborPlan(
                perms=perms, round_L=round_L,
                send_nbr=torch.as_tensor(send_nbr, device=dev),
                cols_nbr=torch.as_tensor(cols_nbr, device=dev))
            self.nbr[schedule] = nplan
        if split_halo and nplan.cols_halo_nbr is None:
            _, _, ch, vh = self.split()
            off_by_pair = self._round_plan(schedule)[2]
            ch, vh = _np(ch), _np(vh)
            ch_nbr = (self._rebase_halo(ch, vh, 0, off_by_pair, 0)
                      if ch.shape[2] else ch)
            nplan.cols_halo_nbr = torch.as_tensor(ch_nbr, device=dev)
            nplan.halo_rounds = tuple(
                (torch.as_tensor(c, device=dev), torch.as_tensor(v, device=dev))
                for c, v in _build_halo_rounds(ch_nbr, vh, nplan.round_L))
        return nplan


def _build_halo_rounds(ch_nbr: np.ndarray, vh: np.ndarray,
                       round_L: tuple) -> list:
    """Group the split halo block by completion round (the reference's
    ``_build_halo_rounds``, ``spmv.py:487-526``): a row goes to the round
    of its highest-round entry, its entries packed in slot order, their
    positions not re-based (sub-block r reads the prefix of rounds ≤ r)."""
    P, R, Wh = ch_nbr.shape
    stored = vh != 0
    ends = np.cumsum(np.asarray(round_L, dtype=np.int64))
    rounds = []
    if Wh:
        rnd = np.searchsorted(ends, ch_nbr, side="right")
        row_last = np.where(stored, rnd, -1).max(axis=2)  # [P, R]
    else:
        row_last = np.full((P, R), -1, dtype=np.int64)
    for r in range(len(round_L)):
        m = (stored & (row_last == r)[:, :, None] if Wh
             else np.zeros((P, R, 0), dtype=bool))
        Wr = int(m.sum(axis=2).max()) if Wh else 0
        cr = np.zeros((P, R, Wr), dtype=np.int32)
        vr = np.zeros((P, R, Wr), dtype=vh.dtype)
        for p in range(P):
            _pack(m[p], ch_nbr[p], vh[p], cr[p], vr[p])
        rounds.append((cr, vr))
    return rounds


def build_dist_ell(matrix: MatrixFamily | CSR, P_row: int = 1, dtype=None,
                   d_pad: int | None = None, split_halo: bool = False,
                   rowmap=None, device=None) -> DistEll:
    """Build the per-shard ELL blocks and the halo plan of ``matrix`` for
    ``P_row`` row shards, in ``dtype`` (the entries' own when None; a
    real ``dtype`` of a complex operator is promoted by
    :func:`value_dtype`), on ``device`` (the card unless ``"cpu"`` is
    given). ``split_halo`` builds the split-phase form now. ``L`` is the
    true largest pair volume, 0 when no shard needs a remote column.

    The rows are placed by a row map
    (:class:`~repro_torch.core.partition.RowMap`, planned at any level
    whose ``D_pad`` ``P_row`` divides; ``RowMap.rows(D, P_row, d_pad)``,
    the equal-rows partition with ``R = ceil(D/P)`` or ``d_pad / P``, when
    none is given), as the reference's ``_build_dist_ell_mapped``
    (``repro/core/spmv.py:666-757``) places them: shard p's ELL row i
    holds the row the map places at position ``p·R + i`` (pad positions
    are all-zero rows), local columns are position offsets, and the
    remote columns of each pair take their halo slots in ascending
    position order, so every row's slot order (and each engine's
    accumulation order) follows the mapped layout. On the identity map
    this is the reference's equal-rows ``build_dist_ell``."""
    device = resolve_device(device)
    P = int(P_row)
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if rowmap is None:
        rowmap = RowMap.rows(D, P, d_pad)
    elif rowmap.D != D:
        raise ValueError("rowmap.D does not match the matrix")
    elif d_pad is not None and d_pad != rowmap.D_pad:
        raise ValueError(f"d_pad={d_pad} conflicts with the rowmap's "
                         f"D_pad={rowmap.D_pad}")
    R = rowmap.level_R(P)
    pos = rowmap.pos
    get_rows = (matrix.row_entries if isinstance(matrix, CSR)
                else lambda rows: collect_row_entries(matrix, rows))
    per_shard = []
    span = 0
    for p in range(P):
        rows, cols, vals = get_rows(rowmap.shard_rows(p, P)[0])
        rpos, cpos = pos[rows], pos[cols]
        nz = vals != 0
        span = max(span, span_of(rpos[nz], cpos[nz]))
        per_shard.append((rpos, cpos, vals))

    # remote needs per (receiver p, owner q), as sorted sender positions
    need: list[dict[int, np.ndarray]] = []
    for p, (_, cpos, _) in enumerate(per_shard):
        remote = np.unique(cpos[(cpos // R) != p])
        owners = remote // R
        need.append({int(q): remote[owners == q] for q in np.unique(owners)})
    L = max((len(v) for d in need for v in d.values()), default=0)

    pair_counts = np.zeros((P, P), dtype=np.int64)
    send_idx = np.zeros((P, P, L), dtype=np.int32)
    for p, d in enumerate(need):
        for q, spos in d.items():
            pair_counts[q, p] = len(spos)
            send_idx[q, p, :len(spos)] = (spos - q * R).astype(np.int32)

    # per shard: remapped columns, each row's slots in remapped order
    W = 0
    shard_ell = []
    for p, (rpos, cpos, vals) in enumerate(per_shard):
        local = (cpos // R) == p
        newcols = np.empty(len(cpos), dtype=np.int64)
        newcols[local] = cpos[local] - p * R
        rem = ~local
        if rem.any():
            rc = cpos[rem]
            q = rc // R
            slot = np.empty(len(rc), dtype=np.int64)
            for qq in np.unique(q):
                m = q == qq
                slot[m] = np.searchsorted(need[p][int(qq)], rc[m])
            newcols[rem] = R + q * L + slot
        rel = rpos - p * R
        order = np.lexsort((newcols, rel))
        rel, newcols, vals = rel[order], newcols[order], vals[order]
        counts = np.bincount(rel, minlength=R)
        W = max(W, int(counts.max()) if len(counts) else 0)
        shard_ell.append((rel, newcols, vals, counts))

    some = next((v for _, _, v, _ in shard_ell if len(v)), None)
    vdt = value_dtype(dtype if dtype is not None
                      else (some.dtype if some is not None else np.float64),
                      any(np.iscomplexobj(v) for _, _, v, _ in shard_ell))
    cols_arr = np.zeros((P, R, W), dtype=np.int32)
    vals_arr = np.zeros((P, R, W), dtype=vdt)
    for p, (rel, newcols, vals, counts) in enumerate(shard_ell):
        slot = np.arange(len(rel)) - np.repeat(np.cumsum(counts) - counts,
                                               counts)
        cols_arr[p, rel, slot] = newcols
        vals_arr[p, rel, slot] = vals
    n_vc = np.array([sum(len(v) for v in d.values()) for d in need],
                    dtype=np.int64)
    ell = DistEll(cols=torch.as_tensor(cols_arr, device=device),
                  vals=torch.as_tensor(vals_arr, device=device),
                  send_idx=torch.as_tensor(send_idx, device=device),
                  R=R, L=L, P=P, D=D, n_vc=n_vc, pair_counts=pair_counts,
                  span=span, rowmap=rowmap)
    if split_halo:
        ell.split()
    return ell


# --------------------------------------------------------------------------
# device side
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Block:
    """One ELL block of every shard (``cols/vals [P, R, W]``) and, for the
    CUDA kernel, its launch over all P shards (``ell_gather.EllLaunch`` on
    the shards' stacked padding-free form), built once."""

    cols: torch.Tensor
    vals: torch.Tensor
    launch: object | None

    @property
    def W(self) -> int:
        return int(self.cols.shape[2])


def _block(cols, vals, use_kernel: bool) -> _Block:
    launch = None
    if use_kernel and vals.device.type == "cuda":
        launch = EllLaunch(plan.compact_ell_grouped(cols, vals))
    return _Block(cols, vals, launch)


def _contract(blk: _Block, x, y0, epilogue, out):
    """``y0 + A_p·x_p`` of every shard's part of ``blk`` (its epilogue when
    given) in one kernel launch, into ``out``: ``x [P, Rx, n_b]``, ``y0``,
    ``out`` and the epilogue's ``w1, w2 [P, R, n_b]``, views with any
    shard stride. An op census counts it as one op (``ops.ell_census``)."""
    with ops.ell_census(blk.cols, blk.vals, x, y0, epilogue,
                        blk.launch.compact):
        return blk.launch(x, y0, out=out, epilogue=epilogue)


def _contract_plain(blk: _Block, x, y0, epilogue, as_kernel: bool = False):
    """The plain version of :func:`_contract` for every shard at once:
    ``x [P, Rx, n_b]``, ``y0 [P, R, n_b]`` (None: 0), the epilogue's
    ``w1, w2 [P, R, n_b]``. Per element it is the same chain of
    ``ref.mac`` roundings as ``ref.ell_spmv_acc_ref`` on each shard.
    Each slot's rows come from one ``index_select`` over the shards'
    stacked rows, as in ``ref.ell_spmv_acc_ref``: indexing with two index
    tensors runs threaded even at n_b = 1, and stalls when the CPU's
    cores are oversubscribed. With ``as_kernel`` (the kernels on, on the
    CPU) it stands for the kernel's one launch over the P shards, and an
    op census counts it as that launch (``ops.ell_census``)."""
    if as_kernel and ops.censuses:
        with ops.ell_census(blk.cols, blk.vals, x, y0, epilogue):
            return _contract_plain(blk, x, y0, epilogue)
    P, R, W = blk.cols.shape
    Rx, nb = x.shape[1], x.shape[2]
    acc = y0 if y0 is not None else torch.zeros(
        (P, R, nb), dtype=torch.result_type(blk.vals, x), device=x.device)
    xf = x.reshape(P * Rx, nb)
    base = torch.arange(P, device=x.device)[:, None] * Rx
    for w in range(W):
        rows = xf.index_select(0, (blk.cols[:, :, w] + base).reshape(-1))
        acc = ref.mac(acc, blk.vals[:, :, w, None], rows.view(P, R, nb))
    if epilogue is not None:
        acc = ref.cheb_epilogue(acc, *epilogue)
    return acc


def _validate_engine(comm: str, schedule: str) -> None:
    if comm not in SPMV_COMM_ENGINES:
        raise ValueError(f"unknown comm engine {comm!r} "
                         f"(expected one of {SPMV_COMM_ENGINES})")
    if schedule not in SPMV_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"(expected one of {SPMV_SCHEDULES})")
    if comm != "compressed" and schedule != "cyclic":
        raise ValueError(f"schedule={schedule!r} only applies to "
                         f"comm='compressed' (got comm={comm!r})")


class _Engine:
    """One engine: its blocks (built once), ``exchange(x)`` (the halo
    exchange alone) and ``__call__`` (the SpMV, or with an epilogue the
    fused step). ``mode`` is ``"full"`` (one block against
    ``[x_p ‖ halo]``), ``"split"`` (local, then halo) or ``"pipelined"``
    (local, then each round's rows)."""

    def __init__(self, group: ShardGroup, ell: DistEll, *, use_kernel: bool,
                 overlap: bool, comm: str, schedule: str, pipeline: bool):
        self.group, self.ell = group, ell
        self.use_kernel = use_kernel
        P, L = ell.P, ell.L
        self.kind = ("a2a" if comm == "a2a" else f"compressed-{schedule}") + (
            "" if not overlap else
            "-pipelined" if comm == "compressed" and pipeline else "-overlap")
        self.comm = comm
        if comm == "compressed":
            nplan = ell.neighbor_plan(split_halo=overlap, schedule=schedule)
            self.H = nplan.H
            # each round's permutation and send rows (views made once, so
            # the group's index cache keys on them), and where it starts
            # in the receive buffer
            self.ends = [0] + [int(e) for e in np.cumsum(nplan.round_L)]
            self.rounds = [(perm, nplan.send_nbr[:, a:b])
                           for perm, a, b in zip(nplan.perms, self.ends,
                                                 self.ends[1:])]
            if overlap:
                cl, vl, _, vh = ell.split()
                self.local = _block(cl, vl, use_kernel)
                if pipeline:
                    self.mode = "pipelined"
                    self.round_blocks = [_block(c, v, use_kernel)
                                         for c, v in nplan.halo_rounds]
                else:
                    self.mode = "split"
                    self.halo = _block(nplan.cols_halo_nbr, vh, use_kernel)
            else:
                self.mode = "full"
                self.full = _block(nplan.cols_nbr, ell.vals, use_kernel)
        else:
            self.H = P * L
            if overlap:
                cl, vl, ch, vh = ell.split()
                self.mode = "split"
                self.local = _block(cl, vl, use_kernel)
                self.halo = _block(ch, vh, use_kernel)
            else:
                self.mode = "full"
                self.full = _block(ell.cols, ell.vals, use_kernel)

    # -------------------------------------------------------- exchange --

    def _exchange_into(self, x, out, r=None):
        """Fill ``out [n_loc, ·, n_b]`` with the halo (all rounds, or
        round ``r`` only)."""
        g = self.group
        if self.comm == "a2a":
            return g.all_to_all(x, self.ell.send_idx, out=out)
        with g.coalesced():  # on ranks: one batch of sends and receives
            for k in (range(len(self.rounds)) if r is None else (r,)):
                perm, rows = self.rounds[k]
                a = self.ends[k] if r is None else 0
                g.gather_ppermute(x, rows, perm, key=k,
                                  out=out[:, a:a + rows.shape[1]])
        return out

    def exchange(self, x):
        """The halo exchange alone: ``[n_loc, H, n_b]`` (``H = P·L`` for
        the a2a engine), run on the current stream."""
        out = x.new_empty((self.ell.n_loc, self.H, x.shape[1]))
        if self.H:
            self._exchange_into(x, out)
        return out

    # ----------------------------------------------------------- bodies --

    def __call__(self, x, epilogue=None):
        """``A·x`` (with ``epilogue = (w1, w2, alpha, beta)``, the fused
        step) over the stacked block ``x [P·R, n_b]`` (on a rank its own
        shard's rows: P below is the shards held here, ``n_loc``). Each
        shard's blocks contract in the reference's order, the accumulator
        threaded through them; the last block that holds entries carries
        the epilogue (an empty block adds nothing, so this is the same
        function as a launch of the empty block with it). On the card
        with ``use_kernel`` each block is one kernel launch for all the
        shards held, each writing into its rows of the result; otherwise
        the plain version contracts every shard at once."""
        g, ell = self.group, self.ell
        P, R, nb = ell.n_loc, ell.R, x.shape[1]
        if x.shape[0] != P * R:
            raise ValueError(f"x has {x.shape[0]} rows, the operator "
                             f"holds {P} shards of {R}")
        kernel = self.use_kernel and x.device.type == "cuda"
        out = x.new_empty((P, R, nb)) if kernel else None
        epi = None
        if epilogue is not None:
            w1, w2, a, b = epilogue
            epi = (w1.view(P, R, nb), w2.view(P, R, nb), a, b)
        acc = None  # the plain version's [P, R, n_b] accumulator
        started = False  # the kernels' accumulator (out) holds a block

        def phase(blk, src, last, label):
            """Contract ``blk`` against ``src [P, Rx, n_b]`` into the
            accumulator; ``last`` carries the epilogue. ``label`` names
            the phase in the group's trace (one entry a phase, whatever
            the launches)."""
            nonlocal acc, started
            e = epi if last else None
            prior = acc if not kernel else out if started else None
            if not kernel:
                acc = _contract_plain(blk, src, acc, e, self.use_kernel)
            else:
                _contract(blk, src, out if started else None, e, out)
                started = True
            if g.trace is not None:
                g.contraction(label, reads=(src, prior) + (
                    (e[0], e[1]) if e is not None else ()),
                    writes=(out if kernel else acc,),
                    launches=1 if kernel else 0)

        def result():
            return (out if kernel else acc).view(P * R, nb)

        xs = x.view(P, R, nb)
        exchanging = self.H > 0
        if self.mode == "full":
            if exchanging:
                # [x_p ‖ halo_p] per shard, the halo gathered in place
                xfull = x.new_empty((P, R + self.H, nb))
                xfull[:, :R] = xs
                self._exchange_into(x, xfull[:, R:])
                phase(self.full, xfull, True, "full")
            else:
                phase(self.full, xs, True, "full")
            return result()

        halo = x.new_empty((P, self.H, nb)) if exchanging else None
        if self.mode == "split":
            pend = (g.start(lambda: self._exchange_into(x, halo), "halo")
                    if exchanging else None)
            has_halo = self.halo.W > 0
            # the local blocks contract while the exchange is in flight
            phase(self.local, xs, not has_halo, "local")
            if pend is not None:
                g.wait(pend)
            if has_halo:
                phase(self.halo, halo, True, "halo")
            return result()

        # pipelined: each round on the side stream with its own event;
        # round k's completed rows contract against the prefix of rounds
        # <= k once it has landed, while later rounds are in flight
        ends = self.ends
        pends = ([g.start(lambda k=k: self._exchange_into(
                     x, halo[:, ends[k]:ends[k + 1]], k), f"halo-round[{k}]")
                  for k in range(len(self.rounds))] if exchanging else [])
        live = [k for k, b in enumerate(self.round_blocks) if b.W > 0]
        phase(self.local, xs, not (live and exchanging), "local")
        for k, pend in enumerate(pends):
            g.wait(pend)
            if k in live:
                phase(self.round_blocks[k], halo[:, :ends[k + 1]],
                      k == live[-1], f"round[{k}]")
        return result()


def _dia_step(ell: DistEll, group: ShardGroup):
    """The whole fused step per shard in the DIA kernel, for a comm-free
    operator (P = 1 or L = 0) whose every shard held here ``ops.plan_dia``
    accepts (on a rank its own); None otherwise. The step carries its per-shard plans (a list) as
    ``step.dia``; it notes one contraction (``full``) in ``group``'s
    trace."""
    if not (ell.P == 1 or ell.L == 0):
        return None
    dias = [ops.plan_dia(ell.cols[p], ell.vals[p], ell.R, device=ell.device)
            for p in range(ell.n_loc)]
    if any(d is None for d in dias):
        return None
    R = ell.R
    # the compact form and span of each plan, built here, once
    forms = [(d.offsets, d.dvals, d.compact, d.span) for d in dias]

    def step_dia(w1, w2, alpha, beta):
        out = w1.new_empty(w1.shape)
        for p, (offs, dv, cp, span) in enumerate(forms):
            sl = slice(p * R, (p + 1) * R)
            ops.cheb_dia(offs, dv, w1[sl], w1[sl], w2[sl], alpha, beta,
                         compact=cp, span=span, out=out[sl])
        if group.trace is not None:
            group.contraction("full", reads=(w1, w2), writes=(out,),
                              launches=len(forms) if out.is_cuda else 0)
        return out

    step_dia.dia = dias
    return step_dia


def _engine(ell: DistEll, group, use_kernel, overlap, comm, schedule,
            pipeline) -> _Engine:
    _validate_engine(comm, schedule)
    if group is None:
        group = ShardGroup(ell.P, ell.device)
    if (group.P, group.first, group.n_loc, group.device) != (
            ell.P, ell.first, ell.n_loc, ell.device):
        raise ValueError(f"{group} does not hold the operator's shards "
                         f"{ell.first}..{ell.first + ell.n_loc - 1} of "
                         f"{ell.P} on {ell.device}")
    return _Engine(group, ell, use_kernel=use_kernel, overlap=overlap,
                   comm=comm, schedule=schedule, pipeline=pipeline)


def make_spmv(ell: DistEll, *, group: ShardGroup | None = None,
              use_kernel: bool = False, overlap: bool = False,
              comm: str = "a2a", schedule: str = "cyclic",
              pipeline: bool = True):
    """Return ``spmv(x) = A·x`` for the stacked block ``x [P·R, n_b]`` on
    the operator's device, through the engine that ``overlap``, ``comm``
    and ``schedule`` (and, for the compressed split-phase engine,
    ``pipeline``) name; ``group`` (built when omitted) counts the bytes
    each exchange moves. ``use_kernel`` sends every block of CUDA tensors
    through one launch of the CUDA kernel for all P shards (reading the
    stacked padding-free forms built here, once); otherwise, and on the
    CPU, the plain version runs. All engines give the same result bit
    for bit. The closure carries ``spmv.exchange(x)`` (the halo exchange
    alone), ``spmv.kind``, the engine's name, and ``spmv.group``."""
    eng = _engine(ell, group, use_kernel, overlap, comm, schedule, pipeline)

    def spmv(x):
        return eng(x)

    spmv.exchange, spmv.kind, spmv.group = eng.exchange, eng.kind, eng.group
    return spmv


def make_fused_cheb_step(ell: DistEll, *, group: ShardGroup | None = None,
                         use_kernel: bool = False, overlap: bool = False,
                         comm: str = "a2a", schedule: str = "cyclic",
                         pipeline: bool = True):
    """Return ``step(w1, w2, alpha, beta) = 2a·A·w1 + 2b·w1 − w2`` through
    the engine of :func:`make_spmv`, the epilogue carried by the last
    block's launch (the ``ell_gather_cheb`` entry with ``use_kernel``),
    rounded as the reference's step body is.

    With ``use_kernel`` a comm-free operator (P = 1 or L = 0) whose every
    shard ``ops.plan_dia`` accepts runs the whole step in the DIA kernel,
    per shard (ascending offsets == ascending columns == the ELL slot
    order, and the same epilogue, so the result is unchanged); such a
    step carries its per-shard plans (a list) as ``step.dia``."""
    eng = _engine(ell, group, use_kernel, overlap, comm, schedule, pipeline)
    if use_kernel:
        step_dia = _dia_step(ell, eng.group)
        if step_dia is not None:
            step_dia.kind, step_dia.group = "dia", eng.group
            return step_dia

    def step(w1, w2, alpha, beta):
        return eng(w1, epilogue=(w1, w2, alpha, beta))

    step.exchange, step.kind, step.group = eng.exchange, eng.kind, eng.group
    return step


# --------------------------------------------------------------------------
# the s-step filter: depth-s ghost zones
# --------------------------------------------------------------------------


def sstep_ghosts(indptr: np.ndarray, cols: np.ndarray, P_row: int, R: int,
                 s: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-shard depth-``s`` ghost zones of a position-space pattern (the
    port's copy of the reference's ``sstep_ghosts``,
    ``repro/core/spmv.py:1195-1247``).

    ``(indptr, cols)`` is a CSR pattern over the padded position space
    ``[0, P_row·R)`` (pad positions have empty rows). For each shard p a
    breadth-first search from its owned positions ``[p·R, (p+1)·R)``
    collects every position first reached at depth d ∈ [1, s], the
    reachability frontier of the pattern powers A^1 .. A^s. Returns, per
    shard, ``(gpos, gdep)``: the ghost positions ascending (≡ by
    (owner, position), owner = pos // R being monotone) and each ghost's
    depth. The operator (:func:`build_sstep_ell`) and the planner's
    ``comm_plan(sstep=s)`` share it, so the predicted volumes are the
    built ones."""
    indptr = np.asarray(indptr, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    D_pos = P_row * R
    assert len(indptr) == D_pos + 1, "pattern must cover the padded space"
    out = []
    for p in range(P_row):
        seen = np.zeros(D_pos, dtype=bool)
        seen[p * R:(p + 1) * R] = True
        frontier = np.arange(p * R, (p + 1) * R, dtype=np.int64)
        gpos_parts: list[np.ndarray] = []
        gdep_parts: list[np.ndarray] = []
        for d in range(1, s + 1):
            if not frontier.size:
                break
            gather, _ = gather_row_entry_idx(indptr, frontier)
            nxt = np.unique(cols[gather])
            new = nxt[~seen[nxt]]
            if not new.size:
                break
            seen[new] = True
            gpos_parts.append(new)
            gdep_parts.append(np.full(new.size, d, dtype=np.int64))
            frontier = new
        if gpos_parts:
            gpos = np.concatenate(gpos_parts)
            gdep = np.concatenate(gdep_parts)
            order = np.argsort(gpos, kind="stable")
            gpos, gdep = gpos[order], gdep[order]
        else:
            gpos = np.zeros(0, dtype=np.int64)
            gdep = np.zeros(0, dtype=np.int64)
        out.append((gpos, gdep))
    return out


@dataclasses.dataclass
class SstepNeighbor:
    """The compressed engine's schedule of the depth-s ghost exchange (the
    reference's ``SstepNeighbor``): the rounds of
    :func:`neighbor_schedule` over the depth-s pair volumes, ``send_nbr
    [P, max(H, 1)]`` the local rows each shard ships round by round, and
    ``gather [P, G]`` each ghost slot's row of the compact
    round-concatenated receive buffer (``off_by_pair[owner] + rank``), so
    the gathered ghost block equals the a2a engine's."""

    perms: tuple
    round_L: tuple
    send_nbr: torch.Tensor
    gather: torch.Tensor

    @property
    def H(self) -> int:
        return int(sum(self.round_L))


@dataclasses.dataclass
class SstepEll:
    """The depth-s ghost-zone operator over P row shards (the reference's
    ``SstepEll``, ``repro/core/spmv.py:1272-1427``), on one device.

    Shard p's extended address space is ``[0, R + G)``: the owned rows at
    their local offsets, ghost j (of its ascending-position ghost list)
    at ``R + j`` (``G`` the most ghosts of a shard; a shard's pad slots
    are never referenced). Step i of a group (from 0) holds the rows whose
    outputs are still needed, the owned rows and the ghosts at depth
    ≤ s−1−i; the deeper ghost rows are rows with no entries. Each row's
    entries are sorted by ``(owner(col) != owner(row), owner(col),
    position(col))``: on owned rows that is :class:`DistEll`'s slot
    order, on a ghost row its home shard's, so every step adds the same
    products in the same order as the s = 1 engines.

    ``steps[i] = (cols, vals)`` ``[P, R+G, W_i]`` tensors; ``send_idx
    [P, P, L]`` and ``gather_a2a [P, G]`` (into the a2a engine's ``[P·L]``
    receive buffer) the one exchange that serves all s steps of a group.
    ``n_vc``, ``pair_counts`` (the depth-s volumes), ``ghost_cum`` (the
    most ghosts of a shard at depth ≤ d), ``ghost_owner`` and
    ``ghost_rank`` are host arrays. The split-phase form of step 0
    (:meth:`split`) and the neighbour plans are built on demand and
    cached.

    The device tensors hold the shards ``[first, first + n_loc)``: all P
    as built, the one shard of a rank after :meth:`held_by` (whose
    ``host`` is the whole operator on the host, from which the split and
    the neighbour plans are sliced), as :class:`DistEll` holds them."""

    steps: tuple
    send_idx: torch.Tensor
    gather_a2a: torch.Tensor
    R: int
    G: int
    L: int
    P: int
    D: int
    s: int
    n_vc: np.ndarray | None = None
    pair_counts: np.ndarray | None = None
    ghost_cum: tuple | None = None
    ghost_owner: np.ndarray | None = None
    ghost_rank: np.ndarray | None = None
    span: int = 0
    cols_loc: torch.Tensor | None = None
    vals_loc: torch.Tensor | None = None
    cols_post: torch.Tensor | None = None
    vals_post: torch.Tensor | None = None
    nbr: dict | None = None
    rowmap: RowMap | None = None
    first: int = 0
    host: "SstepEll | None" = None

    @property
    def device(self) -> torch.device:
        return self.steps[0][1].device

    @property
    def D_pad(self) -> int:
        return self.P * self.R

    @property
    def n_loc(self) -> int:
        """The shards whose blocks this operator holds on its device."""
        return int(self.steps[0][0].shape[0])

    def held_by(self, group: ShardGroup) -> "SstepEll":
        """The operator of the shards ``group`` holds, on its device (the
        counterpart of :meth:`DistEll.held_by`): this one when it holds
        exactly those there; else (a rank) those shards' step blocks,
        ``send_idx`` rows and ghost gather copied from this whole
        operator, which stays on the host as ``host``."""
        if group.P != self.P:
            raise ValueError(f"{group} does not match the operator's "
                             f"{self.P} shards")
        if (group.first, group.n_loc, group.device) == (
                self.first, self.n_loc, self.device):
            return self
        if self.n_loc != self.P:
            raise ValueError("take a rank's shards from the whole operator")
        sl, dev = slice(group.first, group.first + group.n_loc), group.device
        out = dataclasses.replace(
            self, steps=tuple((c[sl].to(dev), v[sl].to(dev))
                              for c, v in self.steps),
            send_idx=self.send_idx[sl].to(dev),
            gather_a2a=self.gather_a2a[sl].to(dev), cols_loc=None,
            vals_loc=None, cols_post=None, vals_post=None, nbr=None,
            first=group.first, host=self)
        if self.cols_loc is not None:
            out.split()
        return out

    def _held(self, t: torch.Tensor) -> torch.Tensor:
        """The held shards' rows of a ``[P, ...]`` tensor of ``host``, on
        this operator's device."""
        return t[self.first:self.first + self.n_loc].to(self.device)

    def n_groups(self, degree: int) -> int:
        """⌈degree / s⌉ exchanges for a degree-term filter."""
        return -(-int(degree) // self.s)

    def split(self):
        """``(cols_loc, vals_loc, cols_post, vals_post)``: step 0 split for
        the split-phase engines. ``[P, R, W_loc]`` holds the owned rows'
        local entries (contracted while the exchange runs),
        ``[P, R+G, W_post]`` the rest, the owned rows' ghost entries and
        the whole ghost rows, contracted afterwards on the same
        accumulator, so each row's summand order is unchanged; cached. A
        rank's operator slices its shards' blocks from ``host``'s."""
        if self.cols_loc is not None:
            return self.cols_loc, self.vals_loc, self.cols_post, self.vals_post
        if self.host is not None:
            (self.cols_loc, self.vals_loc, self.cols_post,
             self.vals_post) = (self._held(t) for t in self.host.split())
            return self.cols_loc, self.vals_loc, self.cols_post, self.vals_post
        cols, vals = _np(self.steps[0][0]), _np(self.steps[0][1])
        Pn, RG, W = cols.shape
        R = self.R
        stored = vals != 0
        own_row = np.zeros((Pn, RG, 1), dtype=bool)
        own_row[:, :R, :] = True
        pre = stored & own_row & (cols < R)
        post = stored & ~pre
        W_loc = max(int(pre.sum(axis=2).max()) if W else 0, 1)
        W_post = int(post.sum(axis=2).max()) if W else 0
        cols_loc = np.zeros((Pn, R, W_loc), dtype=np.int32)
        vals_loc = np.zeros((Pn, R, W_loc), dtype=vals.dtype)
        cols_post = np.zeros((Pn, RG, W_post), dtype=np.int32)
        vals_post = np.zeros((Pn, RG, W_post), dtype=vals.dtype)
        for p in range(Pn):
            _pack(pre[p, :R], cols[p, :R], vals[p, :R], cols_loc[p],
                  vals_loc[p])
            _pack(post[p], cols[p], vals[p], cols_post[p], vals_post[p])
        dev = self.device
        self.cols_loc, self.vals_loc, self.cols_post, self.vals_post = (
            torch.as_tensor(a, device=dev)
            for a in (cols_loc, vals_loc, cols_post, vals_post))
        return self.cols_loc, self.vals_loc, self.cols_post, self.vals_post

    def neighbor_plan(self, schedule: str = "cyclic") -> SstepNeighbor:
        """The compressed engine's rounds over the depth-s pair volumes,
        cached per scheduler. A rank's operator slices its shards' rows
        from ``host``'s plan."""
        if self.nbr is None:
            self.nbr = {}
        plan_ = self.nbr.get(schedule)
        if plan_ is not None:
            return plan_
        if self.host is not None:
            hp = self.host.neighbor_plan(schedule)
            plan_ = SstepNeighbor(perms=hp.perms, round_L=hp.round_L,
                                  send_nbr=self._held(hp.send_nbr),
                                  gather=self._held(hp.gather))
            self.nbr[schedule] = plan_
            return plan_
        if self.pair_counts is None:
            raise ValueError("compressed s-step engine needs per-pair "
                             "volumes (pair_counts=None)")
        perms, round_L, off_by_pair, send_nbr = _round_plan(
            self.pair_counts, _np(self.send_idx), schedule)
        gather = np.zeros((self.P, self.G), dtype=np.int32)
        for p in range(self.P):
            ng = int(self.n_vc[p])
            if ng:
                own = self.ghost_owner[p, :ng]
                offg = off_by_pair[own, p]
                assert (offg >= 0).all(), "ghost with unscheduled sender"
                gather[p, :ng] = (offg + self.ghost_rank[p, :ng]
                                  ).astype(np.int32)
        dev = self.device
        plan_ = SstepNeighbor(perms=perms, round_L=round_L,
                              send_nbr=torch.as_tensor(send_nbr, device=dev),
                              gather=torch.as_tensor(gather, device=dev))
        self.nbr[schedule] = plan_
        return plan_

    def as_dist_ell(self) -> DistEll:
        """The s = 1 round trip: the depth-1 operator in
        :class:`DistEll`'s halo addressing (``R + owner·L + rank``), equal
        to :func:`build_dist_ell`'s by construction."""
        if self.s != 1:
            raise ValueError("as_dist_ell requires s == 1")
        cols = np.array(_np(self.steps[0][0])[:, :self.R, :], dtype=np.int32)
        vals = _np(self.steps[0][1])[:, :self.R, :]
        for p in range(self.P):
            m = cols[p] >= self.R
            if m.any():
                j = cols[p][m] - self.R
                cols[p][m] = (self.R + self.ghost_owner[p, j] * self.L
                              + self.ghost_rank[p, j]).astype(np.int32)
        dev = self.device
        return DistEll(cols=torch.as_tensor(cols, device=dev),
                       vals=torch.as_tensor(np.ascontiguousarray(vals),
                                            device=dev),
                       send_idx=self.send_idx, R=self.R, L=self.L, P=self.P,
                       D=self.D, n_vc=self.n_vc, pair_counts=self.pair_counts,
                       span=self.span, rowmap=self.rowmap)


def build_sstep_ell(matrix: MatrixFamily | CSR, P_row: int, sstep: int,
                    dtype=None, d_pad: int | None = None,
                    split_halo: bool = False, rowmap=None,
                    device=None) -> SstepEll:
    """Build the depth-``sstep`` ghost-zone operator of ``matrix`` for
    ``P_row`` row shards (the reference's ``build_sstep_ell``,
    ``repro/core/spmv.py:1429-1598``, its arithmetic and sort keys
    unchanged), in ``dtype`` (promoted as :func:`value_dtype` promotes),
    on ``device`` (the card unless ``"cpu"`` is given).

    The breadth-first search of :func:`sstep_ghosts` collects each
    shard's depth-s ghosts; the exchange plan ships them in one
    collective per group of s steps, and the per-step ELL blocks over the
    extended addresses ``[0, R + G)`` apply the operator to the owned
    rows and the ghosts still needed. ``sstep=1`` gives
    :func:`build_dist_ell`'s operator (:meth:`SstepEll.as_dist_ell`). The
    rows are placed by ``rowmap`` as :func:`build_dist_ell` places them
    (the search runs in position space); ``split_halo`` builds the
    split-phase form now."""
    device = resolve_device(device)
    s = int(sstep)
    if s < 1:
        raise ValueError(f"sstep must be >= 1 (got {sstep})")
    P = int(P_row)
    D = matrix.shape[0] if isinstance(matrix, CSR) else matrix.D
    if rowmap is None:
        rowmap = RowMap.rows(D, P, d_pad)
    elif rowmap.D != D:
        raise ValueError("rowmap.D does not match the matrix")
    elif d_pad is not None and d_pad != rowmap.D_pad:
        raise ValueError(f"d_pad={d_pad} conflicts with the rowmap's "
                         f"D_pad={rowmap.D_pad}")
    R = rowmap.level_R(P)
    D_pos = P * R
    all_rows = np.arange(D, dtype=np.int64)
    rows, cols, vals = (matrix.row_entries(all_rows)
                        if isinstance(matrix, CSR)
                        else collect_row_entries(matrix, all_rows))
    pos = rowmap.pos
    rows = pos[np.asarray(rows, dtype=np.int64)]
    cols = pos[np.asarray(cols, dtype=np.int64)]
    vals = np.asarray(vals)
    nz = vals != 0
    span = span_of(rows[nz], cols[nz])
    # stable (position-row, position-col) sort: duplicate entries keep
    # their fetch order, as build_dist_ell's per-shard sort keeps them
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(D_pos + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=D_pos))

    ghosts = sstep_ghosts(indptr, cols, P, R, s)
    n_vc = np.array([g.size for g, _ in ghosts], dtype=np.int64)
    G = int(n_vc.max()) if len(n_vc) else 0

    # the depth-s exchange plan: true pair volumes, each pair's slots in
    # ascending position order (DistEll's need-set order at s = 1)
    pair_counts = np.zeros((P, P), dtype=np.int64)
    for p, (gpos, _) in enumerate(ghosts):
        if gpos.size:
            pair_counts[:, p] = np.bincount(gpos // R, minlength=P)
    L = int(pair_counts.max()) if pair_counts.size else 0
    send_idx = np.zeros((P, P, L), dtype=np.int32)
    ghost_owner = np.zeros((P, G), dtype=np.int64)
    ghost_rank = np.zeros((P, G), dtype=np.int64)
    for p, (gpos, _) in enumerate(ghosts):
        if not gpos.size:
            continue
        own = gpos // R
        starts = np.searchsorted(own, np.arange(P))
        rank = np.arange(gpos.size) - starts[own]
        for q in np.unique(own):
            m = own == q
            send_idx[int(q), p, :int(m.sum())] = (gpos[m] - int(q) * R
                                                  ).astype(np.int32)
        ghost_owner[p, :gpos.size] = own
        ghost_rank[p, :gpos.size] = rank
    gather_a2a = (ghost_owner * L + ghost_rank).astype(np.int32)

    cum = np.zeros((max(P, 1), s + 1), dtype=np.int64)
    for p, (_, gdep) in enumerate(ghosts):
        for d in range(1, s + 1):
            cum[p, d] = int((gdep <= d).sum())
    ghost_cum = tuple(int(v) for v in cum.max(axis=0))

    # each shard's entries of every row that is an output of some step
    # (owned rows and ghosts at depth <= s-1), each row's entries sorted
    # by the (owner != row owner, owner, position) key
    shard_data = []
    for p, (gpos, gdep) in enumerate(ghosts):
        inc = gdep <= s - 1
        inc_pos = np.concatenate([np.arange(p * R, (p + 1) * R,
                                            dtype=np.int64), gpos[inc]])
        inc_ext = np.concatenate([np.arange(R, dtype=np.int64),
                                  R + np.nonzero(inc)[0]])
        inc_owner = np.concatenate([np.full(R, p, dtype=np.int64),
                                    gpos[inc] // R])
        inc_depth = np.concatenate([np.zeros(R, dtype=np.int64), gdep[inc]])
        gather, counts = gather_row_entry_idx(indptr, inc_pos)
        e_cols = cols[gather]
        e_vals = vals[gather]
        e_row = np.repeat(inc_ext, counts)
        e_rowner = np.repeat(inc_owner, counts)
        e_depth = np.repeat(inc_depth, counts)
        e_own = e_cols // R
        local_m = e_own == p
        e_addr = np.empty(e_cols.size, dtype=np.int64)
        e_addr[local_m] = e_cols[local_m] - p * R
        if (~local_m).any():
            rc = e_cols[~local_m]
            idx = np.searchsorted(gpos, rc)
            ok = (idx < gpos.size) & (gpos[np.minimum(idx, max(gpos.size - 1,
                                                               0))] == rc)
            if not ok.all():
                raise AssertionError("s-step BFS closure violated: an "
                                     "output row references a position "
                                     "outside the depth-s ghost zone")
            e_addr[~local_m] = R + idx
        remote_flag = (e_own != e_rowner).astype(np.int64)
        e_order = np.lexsort((e_cols, e_own, remote_flag, e_row))
        e_row = e_row[e_order]
        e_addr = e_addr[e_order]
        e_vals = e_vals[e_order]
        e_depth = e_depth[e_order]
        rcounts = np.bincount(e_row, minlength=R + G)
        slot = np.arange(e_row.size) - np.repeat(
            np.cumsum(rcounts) - rcounts, rcounts)
        shard_data.append((e_row, e_addr, e_vals, e_depth, slot))

    vdt = value_dtype(dtype if dtype is not None else vals.dtype,
                      np.iscomplexobj(vals))
    steps = []
    for i in range(s):
        lim = s - 1 - i
        W_i = 0
        for e_row, e_addr, e_vals, e_depth, slot in shard_data:
            m = e_depth <= lim
            if m.any():
                W_i = max(W_i, int(slot[m].max()) + 1)
        ci = np.zeros((P, R + G, W_i), dtype=np.int32)
        vi = np.zeros((P, R + G, W_i), dtype=vdt)
        for p, (e_row, e_addr, e_vals, e_depth, slot) in enumerate(
                shard_data):
            m = e_depth <= lim
            ci[p, e_row[m], slot[m]] = e_addr[m]
            vi[p, e_row[m], slot[m]] = e_vals[m].astype(vdt)
        steps.append((torch.as_tensor(ci, device=device),
                      torch.as_tensor(vi, device=device)))

    sell = SstepEll(
        steps=tuple(steps),
        send_idx=torch.as_tensor(send_idx, device=device),
        gather_a2a=torch.as_tensor(gather_a2a, device=device),
        R=R, G=G, L=L, P=P, D=D, s=s, n_vc=n_vc, pair_counts=pair_counts,
        ghost_cum=ghost_cum, ghost_owner=ghost_owner, ghost_rank=ghost_rank,
        span=span, rowmap=rowmap)
    if split_halo:
        sell.split()
    return sell


class _SstepGroup:
    """The s-step filter's group applier over a :class:`ShardGroup` (the
    port's counterpart of the reference's ``_build_sstep_group``,
    ``repro/core/spmv.py:1601-1757``): one depth-s ghost exchange, then
    up to s recurrence steps on the extended blocks ``[P, R+G, n_b]``.

    The blocks of every step (and, with ``overlap``, step 0's split) are
    built once, with their kernel launches. The first group
    of a filter ships ``V`` (width n_b); a later one ships ``[w1 | w2]``
    (width 2·n_b) in the same collective. With ``overlap`` the exchange
    runs on the group's side stream while step 0's local prefix
    contracts; later steps read the ghosts and cannot overlap.

    Everything here is over the shards held here (``n = sell.n_loc``):
    all P in one process, one on a rank, whose exchange is a
    ``torch.distributed`` call issued asynchronously under ``overlap``
    and whose ghosts are gathered from the receive buffers once it has
    landed (after the ``wait``)."""

    def __init__(self, group: ShardGroup, sell: SstepEll, *,
                 use_kernel: bool, overlap: bool, comm: str, schedule: str):
        self.group, self.sell, self.use_kernel = group, sell, use_kernel
        self.comm = comm
        P, G, n = sell.P, sell.G, sell.n_loc
        self.has_halo = P > 1 and G > 0
        # the split-phase form needs an exchange to hide
        self.overlap = overlap and self.has_halo
        self.kind = (("a2a" if comm == "a2a" else f"compressed-{schedule}")
                     + ("-overlap" if overlap else "") + f"+s{sell.s}")
        dev = sell.device
        if comm == "compressed":
            nbrp = sell.neighbor_plan(schedule)
            self.X = nbrp.H
            # each round's permutation and send rows (views made once, so
            # the group's index cache keys on them)
            self.ends = [0] + [int(e) for e in np.cumsum(nbrp.round_L)]
            self.rounds = [(perm, nbrp.send_nbr[:, a:b])
                           for perm, a, b in zip(nbrp.perms, self.ends,
                                                 self.ends[1:])]
            gather = nbrp.gather
        else:
            self.X = P * sell.L
            gather = sell.gather_a2a
        # ghost j of the held shard p is row p·X + gather[p, j] of the
        # stacked receive buffers
        self.ghost_idx = (gather.to(torch.int64) + self.X * torch.arange(
            n, device=dev, dtype=torch.int64)[:, None]).reshape(-1)
        self.blocks = [None if (i == 0 and self.overlap)
                       else _block(c, v, use_kernel)
                       for i, (c, v) in enumerate(sell.steps)]
        if self.overlap:
            cl, vl, cp, vp = sell.split()
            self.local = _block(cl, vl, use_kernel)
            self.post = _block(cp, vp, use_kernel)
        self.n_exchanged = 0  # the exchange's index in its filter (traces)

    def _exchange(self, payload, buf):
        """The depth-s exchange of ``payload [n·R, W]`` into the receive
        buffers ``buf [n, X, W]`` (allocated by the caller); the rounds
        of the compressed engine in one batch on ranks."""
        g, label = self.group, f"sstep-exchange[{self.n_exchanged}]"
        if self.comm == "a2a":
            g.all_to_all(payload, self.sell.send_idx, out=buf, label=label)
            return
        with g.coalesced():
            for k, (perm, rows) in enumerate(self.rounds):
                a = self.ends[k]
                g.gather_ppermute(payload, rows, perm, key=k,
                                  out=buf[:, a:a + rows.shape[1]],
                                  label=f"{label}.round[{k}]")

    def _gather_ghosts(self, buf, ghosts):
        """Each held shard's ghosts from the receive buffers into
        ``ghosts [n·G, W]``."""
        torch.index_select(buf.view(-1, buf.shape[2]), 0, self.ghost_idx,
                           out=ghosts)
        if self.group.trace is not None:
            self.group.copy("ghost-gather", reads=(buf,), writes=(ghosts,))

    def _exchange_into(self, payload, buf, ghosts):
        """:meth:`_exchange`, then :meth:`_gather_ghosts`."""
        self._exchange(payload, buf)
        self._gather_ghosts(buf, ghosts)

    def _contract(self, blk: _Block, x, y0, epilogue, kernel: bool, out=None,
                  label: str = "step"):
        """``y0 + A·x`` of every shard's part of ``blk`` (``x [P, Rx, n_b]``,
        ``y0`` and the epilogue's blocks ``[P, rows, n_b]``), one kernel
        launch for all P shards into ``out``, or the plain version at
        once; ``label`` names the phase in the group's trace."""
        if not kernel:
            out = _contract_plain(blk, x, y0, epilogue, self.use_kernel)
        else:
            _contract(blk, x, y0, epilogue, out)
        if self.group.trace is not None:
            self.group.contraction(
                label, reads=(x, y0) + (() if epilogue is None
                                        else (epilogue[0], epilogue[1])),
                writes=(out,), launches=1 if kernel else 0)
        return out

    def __call__(self, n_steps: int, first: bool, carry, coeffs, emit):
        """Run one group of ``n_steps`` steps. ``carry`` is ``V [P·R, n_b]``
        for the first group of a filter, else the previous group's last
        two step blocks ``(w1e, w2e)`` (their ghost rows are overwritten
        here). ``coeffs = (a, b, alpha, beta)``: the first step is
        ``a·y + b·w1`` (``a, b`` rounded as ``chebyshev_filter`` rounds
        them), every later one ``2·alpha·y + 2·beta·w1 − w2``. ``emit`` is
        called with each step's owned rows ``[P, R, n_b]`` in order.
        Returns the carry of the next group."""
        sell, g = self.sell, self.group
        P, R, G = sell.n_loc, sell.R, sell.G  # P: the shards held here
        a, b, alpha, beta = coeffs
        if first:
            V = carry
            if V.shape[0] != P * R:
                raise ValueError(f"V has {V.shape[0]} rows, the operator "
                                 f"holds {P} shards of {R}")
            nb = V.shape[1]
            payload = V
            w1e = V.new_empty((P, R + G, nb))
            w1e[:, :R] = V.view(P, R, nb)
            w2e = None
            self.n_exchanged = 0
        else:
            w1e, w2e = carry
            nb = w1e.shape[2]
            # [w1 | w2] in one collective, twice the width
            payload = torch.cat([w1e[:, :R], w2e[:, :R]], dim=2).view(
                P * R, 2 * nb)
            if g.trace is not None:
                g.copy("payload", reads=(w1e[:, :R], w2e[:, :R]),
                       writes=(payload,))
        kernel = self.use_kernel and payload.device.type == "cuda"
        W = payload.shape[1]
        pend, buf, ghosts = None, None, None
        # on ranks the exchange in flight lands at the wait: the ghosts
        # are gathered after it
        late_gather = self.overlap and g.link is not None
        if self.has_halo:
            buf = payload.new_empty((P, self.X, W))
            ghosts = payload.new_empty((P * G, W))
            if late_gather:
                pend = g.start(lambda: self._exchange(payload, buf),
                               f"sstep-exchange[{self.n_exchanged}]")
            elif self.overlap:
                pend = g.start(lambda: self._exchange_into(payload, buf,
                                                           ghosts),
                               f"sstep-exchange[{self.n_exchanged}]")
            else:
                self._exchange_into(payload, buf, ghosts)
            self.n_exchanged += 1

        def fill_ghosts():
            if ghosts is None:
                w1e[:, R:] = 0
                if w2e is not None:
                    w2e[:, R:] = 0
                return
            gh = ghosts.view(P, G, W)
            w1e[:, R:] = gh[:, :, :nb]
            if w2e is not None:
                w2e[:, R:] = gh[:, :, nb:]
            if g.trace is not None:
                g.copy("ghost-fill", reads=(ghosts,), writes=(
                    w1e[:, R:], None if w2e is None else w2e[:, R:]))

        epi = None if first else (w1e, w2e, alpha, beta)
        if self.overlap:
            # the local prefix contracts while the exchange is in flight
            y = w1e.new_empty((P, R + G, nb))
            if kernel:
                self._contract(self.local, w1e[:, :R], None, None, True,
                               out=y[:, :R], label="step[0].local")
            else:
                y[:, :R] = self._contract(self.local, w1e[:, :R], None, None,
                                          False, label="step[0].local")
            y[:, R:] = 0
            g.wait(pend)
            if late_gather:
                self._gather_ghosts(buf, ghosts)
            fill_ghosts()
            y = self._contract(self.post, w1e, y, epi, kernel, out=y,
                               label="step[0].halo")
        else:
            fill_ghosts()
            y = self._contract(self.blocks[0], w1e, None, epi, kernel,
                               out=w1e.new_empty(w1e.shape) if kernel
                               else None, label="step[0]")
        del payload, buf, ghosts
        if first:
            t = a * y + b * w1e
            if g.trace is not None:
                g.copy("step[0].axpy", reads=(y, w1e), writes=(t,))
        else:
            t = y
        del y
        for i in range(n_steps):
            if i:
                t = self._contract(self.blocks[i], w1e, None,
                                   (w1e, w2e, alpha, beta), kernel,
                                   out=w1e.new_empty(w1e.shape) if kernel
                                   else None, label=f"step[{i}]")
            emit(t[:, :R])
            w2e, w1e = w1e, t
        return w1e, w2e


def make_sstep_cheb(sell: SstepEll, *, group: ShardGroup | None = None,
                    use_kernel: bool = False, overlap: bool = False,
                    comm: str = "a2a", schedule: str = "cyclic"):
    """The s-step (communication-avoiding) Chebyshev filter
    (``spmv_sstep = sell.s``, the reference's ``make_sstep_cheb``,
    ``repro/core/spmv.py:1760-1791``): ``apply(V, mu, alpha, beta)`` runs
    a degree-n filter in ⌈n/s⌉ depth-s ghost exchanges through the
    engine ``comm``/``schedule``/``overlap`` names, over ``group`` (built
    when omitted; it counts each exchange's bytes and calls). With
    ``use_kernel`` every step of every group is one launch of the CUDA
    ELL kernel for all shards (its epilogue entry after the filter's
    first step); otherwise the plain version runs. The result equals
    :func:`~repro_torch.core.chebyshev.chebyshev_filter` through the
    s = 1 engine with the same fused step bit for bit. ``apply.kind``
    names the engine (``"...+s3"``), ``apply.group`` the shard group.

    On a rank (``group`` with a link, ``sell`` its :meth:`SstepEll.
    held_by`) ``V`` is its shard's rows and so is the result, each
    exchange a ``torch.distributed`` call; the rows are the one
    process's bit for bit."""
    from .chebyshev import chebyshev_filter_sstep

    if sell.s < 2:
        raise ValueError("make_sstep_cheb requires s >= 2; s = 1 is the "
                         "make_spmv / make_fused_cheb_step engine")
    _validate_engine(comm, schedule)
    if group is None:
        group = ShardGroup(sell.P, sell.device)
    if (group.P, group.first, group.n_loc, group.device) != (
            sell.P, sell.first, sell.n_loc, sell.device):
        raise ValueError(f"{group} does not hold the operator's shards "
                         f"{sell.first}..{sell.first + sell.n_loc - 1} of "
                         f"{sell.P} on {sell.device}")
    run = _SstepGroup(group, sell, use_kernel=use_kernel, overlap=overlap,
                      comm=comm, schedule=schedule)

    def apply(V, mu, alpha, beta):
        return chebyshev_filter_sstep(run, mu, alpha, beta, V, sell.s)

    apply.kind, apply.group = run.kind, group
    return apply
