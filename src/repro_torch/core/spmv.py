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

Each shard's blocks go through ``ops.ell_spmv`` (the CUDA ELL kernel on
the card, its plain version on the CPU; with ``use_kernel=False`` the
plain version everywhere) with the accumulator threaded as ``y0``, in
the reference's block order, so within every row the products are added
in the same order in every engine and all eight agree bit for bit. A
fused step hands its epilogue ``2a·y + 2b·w1 − w2`` to the last block's
launch (the ``ell_gather_cheb`` entry); a comm-free operator (P = 1 or
L = 0) runs the whole step per shard in the DIA kernel when
``ops.plan_dia`` accepts every shard (``spmv.py:1002-1027``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops, plan, ref
from ..kernels.plan import span_of
from ..matrices.families import MatrixFamily
from ..matrices.matfree import collect_row_entries
from ..matrices.sparse import CSR
from .partition import RowMap
from .shards import ShardGroup

__all__ = ["DistEll", "NeighborPlan", "build_dist_ell",
           "make_spmv", "make_fused_cheb_step", "neighbor_schedule",
           "value_dtype", "SPMV_COMM_ENGINES", "SPMV_SCHEDULES"]

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


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


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
    cached."""

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

    @property
    def W(self) -> int:
        return int(self.cols.shape[2])

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
        order; cached. ``W_loc`` is at least 1."""
        if self.cols_loc is not None:
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
            for mask, carr, varr, rebase in (
                    (is_loc[p], cols_loc[p], vals_loc[p], 0),
                    (is_halo[p], cols_halo[p], vals_halo[p], self.R)):
                rows, slots = np.nonzero(mask)
                if not len(rows):
                    continue
                counts = np.bincount(rows, minlength=R)
                out_slot = np.arange(len(rows)) - np.repeat(
                    np.cumsum(counts) - counts, counts)
                carr[rows, out_slot] = cols[p][rows, slots] - rebase
                varr[rows, out_slot] = vals[p][rows, slots]
        dev = self.device
        self.cols_loc = torch.as_tensor(cols_loc, device=dev)
        self.vals_loc = torch.as_tensor(vals_loc, device=dev)
        self.cols_halo = torch.as_tensor(cols_halo, device=dev)
        self.vals_halo = torch.as_tensor(vals_halo, device=dev)
        return self.cols_loc, self.vals_loc, self.cols_halo, self.vals_halo

    # ------------------------------------------------- compressed engine --

    def _round_offsets(self, schedule: str):
        """``(perms, round_L, off_by_pair)``: the rounds, their pads, and
        each scheduled pair's offset into the concatenated receive buffer
        (−1: in no round)."""
        if self.pair_counts is None:
            raise ValueError("the compressed engine needs per-pair volumes; "
                             "build the operator with build_dist_ell")
        perms, round_L = neighbor_schedule(self.pair_counts, schedule)
        off_by_pair = np.full((self.P, self.P), -1, dtype=np.int64)
        H = 0
        for perm, Lk in zip(perms, round_L):
            for s, d in perm:
                off_by_pair[s, d] = H
            H += Lk
        return perms, round_L, off_by_pair

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
        the round-pipelined sub-blocks."""
        if self.nbr is None:
            self.nbr = {}
        nplan = self.nbr.get(schedule)
        dev = self.device
        if nplan is None:
            perms, round_L, off_by_pair = self._round_offsets(schedule)
            P = self.P
            send_idx = _np(self.send_idx)
            H = int(sum(round_L))
            send_nbr = np.zeros((P, max(H, 1)), dtype=np.int32)
            off = 0
            for perm, Lk in zip(perms, round_L):
                for s, d in perm:
                    send_nbr[s, off:off + Lk] = send_idx[s, d, :Lk]
                off += Lk
            cols_nbr = self._rebase_halo(_np(self.cols), _np(self.vals),
                                         self.R, off_by_pair, self.R)
            nplan = NeighborPlan(
                perms=perms, round_L=round_L,
                send_nbr=torch.as_tensor(send_nbr, device=dev),
                cols_nbr=torch.as_tensor(cols_nbr, device=dev))
            self.nbr[schedule] = nplan
        if split_halo and nplan.cols_halo_nbr is None:
            _, _, ch, vh = self.split()
            _, _, off_by_pair = self._round_offsets(schedule)
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
            rows, slots = np.nonzero(m[p])
            if not len(rows):
                continue
            counts = np.bincount(rows, minlength=R)
            out_slot = np.arange(len(rows)) - np.repeat(
                np.cumsum(counts) - counts, counts)
            cr[p, rows, out_slot] = ch_nbr[p, rows, slots]
            vr[p, rows, out_slot] = vh[p, rows, slots]
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
    CUDA kernel, each shard's padding-free form, built once."""

    cols: torch.Tensor
    vals: torch.Tensor
    compact: list | None

    @property
    def W(self) -> int:
        return int(self.cols.shape[2])


def _block(cols, vals, use_kernel: bool) -> _Block:
    compact = None
    if use_kernel and vals.device.type == "cuda":
        compact = [plan.compact_ell(cols[p], vals[p])
                   for p in range(cols.shape[0])]
    return _Block(cols, vals, compact)


def _contract(blk: _Block, p: int, x, y0, epilogue, out):
    """``y0 + A_p·x`` for shard p's part of ``blk`` (its epilogue when
    given) in the kernel (``ops.ell_spmv``), into ``out``."""
    return ops.ell_spmv(blk.cols[p], blk.vals[p], x, y0,
                        compact=None if blk.compact is None
                        else blk.compact[p], epilogue=epilogue, out=out)


def _contract_plain(blk: _Block, x, y0, epilogue):
    """The plain version of :func:`_contract` for every shard at once:
    ``x [P, Rx, n_b]``, ``y0 [P, R, n_b]`` (None: 0), the epilogue's
    ``w1, w2 [P, R, n_b]``. Per element it is the same chain of
    ``ref.mac`` roundings as ``ref.ell_spmv_acc_ref`` on each shard.
    Each slot's rows come from one ``index_select`` over the shards'
    stacked rows, as in ``ref.ell_spmv_acc_ref``: indexing with two index
    tensors runs threaded even at n_b = 1, and stalls when the CPU's
    cores are oversubscribed."""
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
        """Fill ``out [P, ·, n_b]`` with the halo (all rounds, or round
        ``r`` only)."""
        g = self.group
        if self.comm == "a2a":
            return g.all_to_all(x, self.ell.send_idx, out=out)
        for k in (range(len(self.rounds)) if r is None else (r,)):
            perm, rows = self.rounds[k]
            a = self.ends[k] if r is None else 0
            g.gather_ppermute(x, rows, perm, key=k,
                              out=out[:, a:a + rows.shape[1]])
        return out

    def exchange(self, x):
        """The halo exchange alone: ``[P, H, n_b]`` (``H = P·L`` for the
        a2a engine), run on the current stream."""
        out = x.new_empty((self.ell.P, self.H, x.shape[1]))
        if self.H:
            self._exchange_into(x, out)
        return out

    # ----------------------------------------------------------- bodies --

    def __call__(self, x, epilogue=None):
        """``A·x`` (with ``epilogue = (w1, w2, alpha, beta)``, the fused
        step) over the stacked block ``x [P·R, n_b]``. Each shard's
        blocks contract in the reference's order, the accumulator
        threaded through them; the last block that holds entries carries
        the epilogue (an empty block adds nothing, so this is the same
        function as a launch of the empty block with it). On the card
        with ``use_kernel`` each block is one kernel launch per shard,
        writing into the shard's rows of the result; otherwise the plain
        version contracts every shard at once."""
        g, ell = self.group, self.ell
        P, R, nb = ell.P, ell.R, x.shape[1]
        if x.shape[0] != P * R:
            raise ValueError(f"x has {x.shape[0]} rows, the operator "
                             f"{P} shards of {R}")
        kernel = self.use_kernel and x.device.type == "cuda"
        out = x.new_empty((P, R, nb)) if kernel else None
        epi = None
        if epilogue is not None:
            w1, w2, a, b = epilogue
            epi = (w1.view(P, R, nb), w2.view(P, R, nb), a, b)
        acc = None  # the plain version's [P, R, n_b] accumulator
        started = False  # the kernels' accumulator (out) holds a block

        def phase(blk, src, last):
            """Contract ``blk`` against ``src [P, Rx, n_b]`` into the
            accumulator; ``last`` carries the epilogue."""
            nonlocal acc, started
            e = epi if last else None
            if not kernel:
                acc = _contract_plain(blk, src, acc, e)
                return
            for p in range(P):
                ep = None if e is None else (e[0][p], e[1][p], e[2], e[3])
                _contract(blk, p, src[p], out[p] if started else None, ep,
                          out[p])
            started = True

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
                phase(self.full, xfull, True)
            else:
                phase(self.full, xs, True)
            return result()

        halo = x.new_empty((P, self.H, nb)) if exchanging else None
        if self.mode == "split":
            pend = (g.start(lambda: self._exchange_into(x, halo))
                    if exchanging else None)
            has_halo = self.halo.W > 0
            # the local blocks contract while the exchange is in flight
            phase(self.local, xs, not has_halo)
            if pend is not None:
                g.wait(pend)
            if has_halo:
                phase(self.halo, halo, True)
            return result()

        # pipelined: each round on the side stream with its own event;
        # round k's completed rows contract against the prefix of rounds
        # <= k once it has landed, while later rounds are in flight
        ends = self.ends
        pends = ([g.start(lambda k=k: self._exchange_into(
                     x, halo[:, ends[k]:ends[k + 1]], k))
                  for k in range(len(self.rounds))] if exchanging else [])
        live = [k for k, b in enumerate(self.round_blocks) if b.W > 0]
        phase(self.local, xs, not (live and exchanging))
        for k, pend in enumerate(pends):
            g.wait(pend)
            if k in live:
                phase(self.round_blocks[k], halo[:, :ends[k + 1]],
                      k == live[-1])
        return result()


def _dia_step(ell: DistEll):
    """The whole fused step per shard in the DIA kernel, for a comm-free
    operator (P = 1 or L = 0) whose every shard ``ops.plan_dia`` accepts;
    None otherwise. The step carries its per-shard plans (a list) as
    ``step.dia``."""
    if not (ell.P == 1 or ell.L == 0):
        return None
    dias = [ops.plan_dia(ell.cols[p], ell.vals[p], ell.R, device=ell.device)
            for p in range(ell.P)]
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
        return out

    step_dia.dia = dias
    return step_dia


def _engine(ell: DistEll, group, use_kernel, overlap, comm, schedule,
            pipeline) -> _Engine:
    _validate_engine(comm, schedule)
    if group is None:
        group = ShardGroup(ell.P, ell.device)
    if group.P != ell.P or group.device != ell.device:
        raise ValueError(f"{group} does not hold the operator's {ell.P} "
                         f"shards on {ell.device}")
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
    each exchange moves. ``use_kernel`` sends every block through
    ``ops.ell_spmv`` (the CUDA kernel for CUDA tensors, reading the
    padding-free forms built here, once); otherwise the plain version
    runs. All engines give the same result bit for bit. The closure
    carries ``spmv.exchange(x)`` (the halo exchange alone) and
    ``spmv.kind``, the engine's name."""
    eng = _engine(ell, group, use_kernel, overlap, comm, schedule, pipeline)

    def spmv(x):
        return eng(x)

    spmv.exchange, spmv.kind = eng.exchange, eng.kind
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
        step_dia = _dia_step(ell)
        if step_dia is not None:
            step_dia.kind = "dia"
            return step_dia

    def step(w1, w2, alpha, beta):
        return eng(w1, epilogue=(w1, w2, alpha, beta))

    step.exchange, step.kind = eng.exchange, eng.kind
    return step
