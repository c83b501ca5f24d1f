"""Structured forms built from the generators (the port's copy of
``repro.matrices.matfree``).

``dia_from_family`` extracts the diagonal-offset (DIA) representation of a
family: lattice Hamiltonians (Exciton, TopIns) are unions of a few dozen
shifted diagonals, which the DIA kernel (``kernels/cheb_dia.py``) applies
without a gather.

``iter_row_entries`` / ``collect_row_entries`` are the **windowed generator
protocol**: a family's ``row_entries`` is called on bounded windows of the
requested rows, so no caller materializes one giant whole-shard COO
temporary; ``core/spmv.py::build_dist_ell`` builds its block this way. The
concatenated result carries exactly the same (row, col, value) multiset as a
single ``row_entries`` call; entry *order* may differ across window sizes,
which consumers must not rely on (``build_dist_ell`` lexsorts, so the built
operator is the same for every window size).
"""
from __future__ import annotations

import numpy as np

from .families import MatrixFamily

#: Default window (rows per generator call) of the streamed protocol —
#: big enough to amortize the per-call vectorization, small enough that
#: a ~10-entry/row family's per-window temporaries stay a few MB.
DEFAULT_WINDOW = 262_144


def iter_row_entries(fam: MatrixFamily, rows: np.ndarray,
                     window: int = DEFAULT_WINDOW):
    """Yield ``(row_idx, col_idx, values)`` chunks of ``rows``, at most
    ``window`` rows per generator call."""
    rows = np.asarray(rows, dtype=np.int64)
    for lo in range(0, max(len(rows), 1), window):
        yield fam.row_entries(rows[lo: lo + window])


def collect_row_entries(fam: MatrixFamily, rows: np.ndarray,
                        window: int = DEFAULT_WINDOW):
    """``row_entries`` of ``rows`` via windowed generator calls: the same
    (row, col, value) multiset as one whole-set call, per-call temporaries
    bounded by ``window`` rows instead of ``len(rows)``."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) <= window:
        return fam.row_entries(rows)
    parts = list(iter_row_entries(fam, rows, window))
    rs, cs, vs = zip(*parts)
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)


def dia_from_family(fam: MatrixFamily, pad_to: int = 8, rows: slice | None = None,
                    max_diags: int = 128):
    """Extract (offsets, dvals [n_diag, R_pad], R_pad) for a row block.

    ``rows`` selects a contiguous block (default: all rows). Offsets are
    col - row; entries whose target falls outside the block land on the
    same offsets (the caller provides x with halo so i + off indexes it).
    Values are complex64 for a complex family, else float32, as the
    reference's.
    """
    lo = rows.start if rows else 0
    hi = rows.stop if rows else fam.D
    r, c, v = collect_row_entries(fam, np.arange(lo, hi, dtype=np.int64))
    off = c - r
    offsets = np.unique(off)
    if len(offsets) > max_diags:
        raise ValueError(
            f"{fam.name}: {len(offsets)} distinct diagonals — not DIA-structured"
        )
    R = hi - lo
    R_pad = -(-R // pad_to) * pad_to
    dtype = np.complex64 if fam.is_complex else np.float32
    dvals = np.zeros((len(offsets), R_pad), dtype=dtype)
    pos = np.searchsorted(offsets, off)
    dvals[pos, r - lo] = v.astype(dtype)
    return [int(o) for o in offsets], dvals, R_pad
