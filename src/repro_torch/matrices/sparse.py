"""Minimal host-side CSR (numpy, real or complex values): the
explicit-matrix input of the solver and the host re-check of returned
eigenpairs; and the paper's uniform row partition of the χ metrics."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSR", "csr_from_coo", "uniform_partition",
           "gather_row_entry_idx"]


def gather_row_entry_idx(indptr, rows):
    """(entry_idx, counts): indices into a CSR's ``indices``/``data``
    selecting the entries of the (not necessarily contiguous) row set
    ``rows``, concatenated in the given row order (the port's copy of
    ``repro/matrices/sparse.py::gather_row_entry_idx``)."""
    indptr = np.asarray(indptr)
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.diff(indptr)[rows]
    starts = indptr[:-1][rows]
    total = int(counts.sum())
    idx = (np.arange(total, dtype=np.int64)
           - np.repeat(np.cumsum(counts) - counts, counts)
           + np.repeat(starts, counts))
    return idx, counts


@dataclasses.dataclass
class CSR:
    """Compressed-row-storage matrix. ``data`` may be None (pattern only)."""

    indptr: np.ndarray  # int64, shape (D+1,)
    indices: np.ndarray  # int64, shape (nnz,)
    data: np.ndarray | None  # float64/complex128 or None
    shape: tuple[int, int]

    def row_entries(self, rows: np.ndarray):
        """(row_idx, col_idx, values) of ``rows``, the families' protocol."""
        rows = np.asarray(rows, dtype=np.int64)
        idx, counts = gather_row_entry_idx(self.indptr, rows)
        return np.repeat(rows, counts), self.indices[idx], self.data[idx]

    def to_dense(self) -> np.ndarray:
        D0, D1 = self.shape
        out = np.zeros((D0, D1), dtype=self.data.dtype if self.data is not None else np.float64)
        rows = np.repeat(np.arange(D0), np.diff(self.indptr))
        out[rows, self.indices] = 1.0 if self.data is None else self.data
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference (numpy) SpMV / SpMMV, x of shape (D,) or (D, n_b)."""
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        contrib = self.data[:, None] * x[self.indices] if x.ndim == 2 else self.data * x[self.indices]
        out = np.zeros((self.shape[0],) + x.shape[1:], dtype=np.result_type(self.data, x))
        np.add.at(out, rows, contrib)
        return out

    def to_scipy(self):
        """The same matrix as a ``scipy.sparse.csr_matrix``."""
        import scipy.sparse

        return scipy.sparse.csr_matrix((self.data, self.indices, self.indptr),
                                       shape=self.shape)


def uniform_partition(D: int, P: int) -> np.ndarray:
    """Row boundaries k_0..k_P (Eq. in Sec 3.4): k_p = round(p * D / P)."""
    return np.round(np.arange(P + 1) * (D / P)).astype(np.int64)


def csr_from_coo(rows, cols, vals, shape) -> CSR:
    """CSR with rows in order and ascending columns within a row;
    duplicate (row, col) entries are summed."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = None if vals is None else np.asarray(vals)[order]
    if len(rows):
        first = np.ones(len(rows), dtype=bool)
        first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        if not first.all():
            grp = np.cumsum(first) - 1
            if vals is not None:
                v2 = np.zeros(int(grp[-1]) + 1, dtype=vals.dtype)
                np.add.at(v2, grp, vals)
                vals = v2
            rows, cols = rows[first], cols[first]
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols, data=vals, shape=tuple(shape))
