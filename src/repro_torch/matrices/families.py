"""Matrix family base class and registry (host-side generators, numpy).

The port's own copy of ``repro.matrices.families``, cut to what the
single-device solve needs: each family gives its dimension ``D``, the
vectorized per-row generators ``row_cols`` / ``row_entries``, whether its
entries are complex (``is_complex``, ``S_d``), how far its pattern reaches
from the diagonal (``reach``), an optional analytic inclusion interval
(``spectral_bounds_hint``), and ``build_csr`` for instances that fit in host
memory. The χ counting (``n_vc``) and ``est_nnz`` come with the horizontal
layer.
"""
from __future__ import annotations

import abc

import numpy as np

from .sparse import CSR, csr_from_coo

_REGISTRY: dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def get_family(name: str, **params):
    return _REGISTRY[name](**params)


def available_families():
    return sorted(_REGISTRY)


class MatrixFamily(abc.ABC):
    """A scalable sparse Hermitian matrix defined by its generator."""

    name: str = "abstract"
    #: True if matrix entries are complex (S_d = 16), else real (S_d = 8)
    is_complex: bool = False

    #: max |col - row| the pattern can reach, or None if unbounded.
    reach: int | None = None

    @property
    @abc.abstractmethod
    def D(self) -> int:
        ...

    @abc.abstractmethod
    def row_cols(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (row_idx, col_idx) COO pattern entries for the given rows."""

    @abc.abstractmethod
    def row_entries(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (row_idx, col_idx, values) for the given rows."""

    @property
    def S_d(self) -> int:
        return 16 if self.is_complex else 8

    def build_csr(self, max_D: int = 50_000_000) -> CSR:
        if self.D > max_D:
            raise MemoryError(f"{self.name}: D={self.D} too large for explicit CSR")
        rows, cols, vals = self.row_entries(np.arange(self.D, dtype=np.int64))
        return csr_from_coo(rows, cols, vals, (self.D, self.D))

    def spectral_bounds_hint(self) -> tuple[float, float] | None:
        """Optional analytic inclusion interval (else Lanczos computes it)."""
        return None

    def describe(self) -> str:
        return f"{self.name}(D={self.D})"
