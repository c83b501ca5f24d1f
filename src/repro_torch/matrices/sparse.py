"""Minimal host-side CSR (numpy, real or complex values): the
explicit-matrix input of the solver and the host re-check of returned
eigenpairs."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSR", "csr_from_coo"]


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
        counts = np.diff(self.indptr)[rows]
        idx = (np.arange(int(counts.sum()), dtype=np.int64)
               - np.repeat(np.cumsum(counts) - counts, counts)
               + np.repeat(self.indptr[:-1][rows], counts))
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
