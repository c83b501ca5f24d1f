"""Host-side plan of the two kernels' slab-ordered sweep.

Both CUDA kernels compute ``y[:, slab] = y0 + A·x[:, slab]`` one column
slab of width ``c`` at a time, the CTAs in flight on a narrow band of rows
of one slab, so the x rows that the sweep still has to read again stay in
L2. This module holds what the host decides for that sweep, in plain
Python and torch so that the CPU tests reach it:

* :func:`span_of`: how far an operator's entries lie from the diagonal,
  ``max |col − row|``, recorded once when the operator is built;
* :class:`CompactDia`: the compact DIA form the ``cheb_dia`` kernel reads,
  per row only its stored entries in ascending offset order, each a
  ``uint8`` diagonal id, with int32 row pointers and the values from a
  table where they take few distinct values;
* :class:`CompactEll`: the padding-free form the ``ell_gather`` kernel
  reads, per row only its stored entries in slot order, with int32 row
  pointers, for one block or stacked over the P row shards of a block
  (:func:`compact_ell_grouped`), which one launch takes;
* :func:`slab_width`: the rule that picks the DIA step's ``c`` (the ELL
  product keeps ``c = n_b``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

#: L2 of an H100 (NVIDIA data sheet). A sweep whose whole x window,
#: ``2·span`` rows of ``n_b·S`` bytes, fits it reads each x row once
#: from device memory without slabs.
L2_BYTES = 50 * 2**20

#: Bytes of a row that one slab covers when slabs are needed. Measured,
#: not modelled: in ``chip_smoke.py``'s sweep of cheb_dia fp64 at
#: Hubbard(12,6), n_b = 512 (span 232,848; H100 80GB HBM3 at 700 W;
#: PERF.md) c = 32 (256 B) was the fastest, 7.49 ms against 7.96 at
#: c = 16 and 8.73 at c = 64; fp32 at c = 64 (the same 256 B) ran
#: 3.74 ms. Narrower slabs repeat each row's per-entry work n_b/c times,
#: wider ones lose the L2 reuse of x. (A byte model that counted x
#: re-reads picked c = 8, which ran 11.2 ms: the step is bound by the x
#: loads in flight, not by device-memory bytes.)
SLAB_ROW_BYTES = 256

#: Rows of one tile of the DIA kernel, passed to it with ``tile_max``
#: (the kernel halves it while a tile's operator rows overflow its
#: shared-memory budget).
TILE_ROWS = 128

#: Most rows of one tile of the ELL kernel (a pass of its 256 threads at
#: one thread a row), passed to it with ``tile_max``; it takes tiles of
#: 256 / lanes rows, each inside one of these.
ELL_TILE_ROWS = 256


def tile_max(rowptr: torch.Tensor, rows: int, P: int = 1) -> int:
    """Most entries in ``rows`` rows from a multiple of ``rows`` of a
    shard, ``rowptr`` holding ``P`` shards' rows one after another."""
    rp = rowptr.to(torch.int64)
    R = (rp.numel() - 1) // P
    if R < 1:
        return 0
    starts = torch.arange(0, R, rows, device=rp.device)
    ends = torch.clamp(starts + rows, max=R)
    base = torch.arange(P, device=rp.device)[:, None] * R
    return int((rp[base + ends] - rp[base + starts]).max())


def row_pointers(counts: torch.Tensor) -> torch.Tensor:
    """int32 ``[R + 1]`` row pointers of rows holding ``counts`` entries."""
    rowptr = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                         device=counts.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    if int(rowptr[-1]) >= 2**31:
        raise ValueError(f"{int(rowptr[-1])} entries overflow int32 row "
                         "pointers")
    return rowptr.to(torch.int32)


def span_of(rows, cols) -> int:
    """``max |col − row|`` over the entries ``(rows[i], cols[i])``."""
    d = (torch.as_tensor(cols).to(torch.int64)
         - torch.as_tensor(rows).to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


def span_of_ell(cols: torch.Tensor, vals: torch.Tensor) -> int:
    """``max |col − row|`` over an ELL block's stored (non-zero) entries."""
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    nz = vals != 0
    return span_of(rows.expand_as(cols)[nz], cols[nz])


def span_of_dia(offsets, dvals: torch.Tensor) -> int:
    """``max |offset|`` over the diagonals that store an entry."""
    stored = (dvals != 0).any(dim=1).cpu().tolist()
    return max((abs(int(o)) for o, s in zip(offsets, stored) if s), default=0)


#: Most distinct values off the main diagonal that the compact form keeps
#: in a table (a uint8 index an entry).
TABLE_MAX = 256


@dataclasses.dataclass(frozen=True)
class CompactDia:
    """Compact form of a DIA operator: row ``r``'s stored entries are
    ``ids[rowptr[r]:rowptr[r+1]]`` in ascending offset order (the ELL slot
    order), ``ids`` indexing the plan's ascending ``offsets``.

    An entry's value is ``vals[e]``; or, when the values off the main
    diagonal take at most ``TABLE_MAX`` distinct values (lattice models
    have one or a few: ±t, J/2; Exciton −t and its spin-orbit entries,
    TopIns its hop blocks' entries), ``table[vidx[e]]`` (``table[0]`` when
    ``vidx`` is None), and on the main diagonal (id ``diag_id``)
    ``diag[r]``. The table form reads ≈ 2 bytes an entry instead of 1 + S."""

    rowptr: torch.Tensor  # int32 [R + 1]
    ids: torch.Tensor     # uint8 [nnz]
    nnz: int
    max_row: int          # most entries in one row
    vals: torch.Tensor | None = None   # [nnz], the dtype of dvals
    table: torch.Tensor | None = None  # [<= TABLE_MAX]
    vidx: torch.Tensor | None = None   # uint8 [nnz]
    diag: torch.Tensor | None = None   # [R]
    diag_id: int = -1

    @property
    def R(self) -> int:
        return int(self.rowptr.shape[0]) - 1

    @property
    def dtype(self) -> torch.dtype:
        return (self.vals if self.table is None else self.table).dtype

    @functools.cached_property
    def tile_max(self) -> int:
        """Most entries in one tile of the kernel (TILE_ROWS rows from a
        multiple of TILE_ROWS), which its shared memory must hold."""
        return tile_max(self.rowptr, TILE_ROWS)

    @property
    def bytes_per_row(self) -> float:
        """Operator bytes one sweep reads per row."""
        R = max(self.R, 1)
        if self.table is None:
            S = self.vals.element_size()
            return (self.nnz * (1 + S) + 4 * (self.R + 1)) / R
        S = self.table.element_size()
        per_entry = 1 + (self.vidx is not None)
        diag = S * self.R if self.diag is not None else 0
        return (self.nnz * per_entry + diag + 4 * (self.R + 1)) / R

    def rows(self) -> torch.Tensor:
        """The row of each entry."""
        counts = (self.rowptr[1:] - self.rowptr[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.R, device=self.rowptr.device), counts)

    def entry_values(self) -> torch.Tensor:
        """The value of each entry."""
        if self.table is None:
            return self.vals
        idx = (self.vidx.to(torch.int64) if self.vidx is not None
               else torch.zeros_like(self.ids, dtype=torch.int64))
        v = self.table[idx]
        if self.diag is not None:
            v = torch.where(self.ids == self.diag_id, self.diag[self.rows()], v)
        return v

    def to_dvals(self, n_diag: int) -> torch.Tensor:
        """The dense ``dvals [n_diag, R]`` this form was built from."""
        v = self.entry_values()
        out = torch.zeros((n_diag, self.R), dtype=v.dtype, device=v.device)
        out[self.ids.to(torch.int64), self.rows()] = v
        return out


def diag_id_of(offsets) -> int | None:
    """Index of offset 0 in ``offsets``, or None."""
    offsets = list(offsets)
    return offsets.index(0) if 0 in offsets else None


def _unique(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The distinct values of ``v`` (ascending; complex ones by real, then
    imaginary part) and each entry's index among them. ``torch.unique``
    takes no complex dtype, so a complex ``v`` goes through the rows of
    its real view."""
    if not v.is_complex():
        return torch.unique(v, return_inverse=True)
    rows, inverse = torch.unique(torch.view_as_real(v), dim=0,
                                 return_inverse=True)
    return torch.view_as_complex(rows.contiguous()), inverse


def compact_dia(dvals: torch.Tensor, diag_id: int | None = None) -> CompactDia:
    """The compact form of ``dvals [n_diag, R]`` (on its device);
    ``diag_id`` is the row of ``dvals`` that holds offset 0, if any."""
    n_diag, R = dvals.shape
    if n_diag > 256:
        raise ValueError(f"compact DIA form: {n_diag} diagonals do not fit "
                         "a uint8 id")
    rows, ids = (dvals.t() != 0).nonzero(as_tuple=True)  # row-major order
    nnz = int(rows.shape[0])
    vals = dvals[ids, rows]
    counts = torch.bincount(rows, minlength=R)
    base = dict(rowptr=row_pointers(counts), ids=ids.to(torch.uint8),
                nnz=nnz, max_row=int(counts.max()) if R else 0)
    main = ids == (-1 if diag_id is None else diag_id)
    table, inverse = _unique(vals[~main])
    if len(table) > TABLE_MAX:
        return CompactDia(vals=vals, **base)
    if not len(table):
        table = vals.new_zeros(1)
    vidx = None
    if len(table) > 1:
        vidx = torch.zeros(nnz, dtype=torch.uint8, device=vals.device)
        vidx[~main] = inverse.to(torch.uint8)
    if diag_id is None:
        return CompactDia(table=table, vidx=vidx, **base)
    return CompactDia(table=table, vidx=vidx, diag=dvals[diag_id].contiguous(),
                      diag_id=int(diag_id), **base)


@dataclasses.dataclass(frozen=True)
class CompactEll:
    """Padding-free form of an ELL block ``cols/vals [R, W]``: row ``r``'s
    stored (non-zero) entries are ``cols[rowptr[r]:rowptr[r+1]]`` and
    ``vals[...]``, in slot order, so a contraction over them folds the
    same products in the same order as one over the padded block.

    The stacked form of ``P`` row shards' blocks ``[P, R, W]``
    (:func:`compact_ell_grouped`) holds their ``P·R`` rows one after
    another, shard p's row r at ``p·R + r``, each row's columns local to
    its shard's source rows; ``P = 1`` is one block."""

    rowptr: torch.Tensor  # int32 [P·R + 1]
    cols: torch.Tensor    # int32 [nnz]
    vals: torch.Tensor    # [nnz]
    max_row: int          # most entries in one row
    x_rows: int           # fewest source rows a shard's x may have
    P: int = 1            # row shards

    @property
    def R(self) -> int:
        """Rows of a shard."""
        return (int(self.rowptr.shape[0]) - 1) // self.P

    @functools.cached_property
    def tile_max(self) -> int:
        """Most entries in ELL_TILE_ROWS rows of a shard from a multiple
        of it."""
        return tile_max(self.rowptr, ELL_TILE_ROWS, self.P)

    def to_ell(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``cols/vals [P·R, max_row]``: the entries in slot order, padded
        with column 0 and value 0."""
        rp = self.rowptr.to(torch.int64)
        slot = torch.arange(self.max_row, device=rp.device)
        live = slot[None, :] < (rp[1:] - rp[:-1])[:, None]
        idx = torch.where(live, rp[:-1, None] + slot[None, :], 0)
        return (torch.where(live, self.cols[idx], 0),
                torch.where(live, self.vals[idx], 0))


def compact_ell(cols: torch.Tensor, vals: torch.Tensor) -> CompactEll:
    """The padding-free form of ``cols/vals [R, W]`` (on their device)."""
    nz = vals != 0  # row-major: each row's entries in slot order
    counts = nz.sum(dim=1)
    stored = cols[nz].to(torch.int32).contiguous()
    return CompactEll(rowptr=row_pointers(counts), cols=stored,
                      vals=vals[nz].contiguous(),
                      max_row=int(counts.max()) if counts.numel() else 0,
                      x_rows=int(stored.max()) + 1 if stored.numel() else 0)


def compact_ell_grouped(cols: torch.Tensor, vals: torch.Tensor) -> CompactEll:
    """The stacked padding-free form of ``P`` row shards' blocks
    ``cols/vals [P, R, W]`` (on their device): the shards' rows one after
    another, row pointers over all of them, columns as the blocks hold
    them (local to each shard's source rows), ``tile_max`` taken over
    tiles inside the shards."""
    P, R, W = cols.shape
    one = compact_ell(cols.reshape(P * R, W), vals.reshape(P * R, W))
    return dataclasses.replace(one, P=int(P))


def model_bytes(R: int, n_b: int, S: int, c: int, op_bytes_per_row: float,
                streams: int = 2) -> float:
    """Bytes of the slab schedule when L2 holds each slab's x window:
    ``R·n_b·S·(streams + 1) + ceil(n_b/c)·R·op_bytes_per_row``, x once,
    ``streams`` other [R, n_b] blocks once (w2 and y for the DIA step),
    the operator once per slab. ``chip_smoke.py`` prints it beside the
    effective bytes (ms × 3.35 TB/s)."""
    return (R * n_b * S * (streams + 1)
            + math.ceil(n_b / c) * R * op_bytes_per_row)


def slab_width(n_b: int, S: int, span: int) -> int:
    """The DIA step's slab width: ``n_b`` (one pass, the operator read
    once) when the full-width window ``2·span·n_b·S`` fits L2, else
    ``SLAB_ROW_BYTES / S`` columns (at most ``n_b``)."""
    if 2 * span * n_b * S <= L2_BYTES:
        return n_b
    return max(1, min(n_b, SLAB_ROW_BYTES // S))


def check_slab(slab, n_b: int) -> int | None:
    """``slab`` as given to a wrapper (``None``: the rule decides)."""
    if slab is None:
        return None
    slab = int(slab)
    if not 1 <= slab <= max(n_b, 1):
        raise ValueError(f"slab width {slab} outside [1, n_b = {n_b}]")
    return slab


def ell_operator_bytes(R: int, nnz: int, S: int) -> int:
    """Operator bytes one sweep of the ELL kernel reads: the row pointers,
    an int32 column and a value an entry."""
    return 4 * (R + 1) + nnz * (4 + S)


def ell_bytes_per_row(cp: CompactEll) -> float:
    """:func:`ell_operator_bytes` of ``cp`` per row (of all its shards)."""
    rows = cp.P * cp.R
    return (ell_operator_bytes(rows, cp.cols.numel(), cp.vals.element_size())
            / max(rows, 1))
