"""Matrix family base class and registry (host-side generators, numpy).

The port's own copy of ``repro.matrices.families``, cut to what the
single-device solve needs: each family gives its dimension ``D``, the
vectorized per-row generators ``row_cols`` / ``row_entries``, whether its
entries are complex (``is_complex``, ``S_d``), how far its pattern reaches
from the diagonal (``reach``), an optional analytic inclusion interval
(``spectral_bounds_hint``), and ``build_csr`` for instances that fit in host
memory, and the χ counts of the horizontal layer: ``n_vc`` (distinct
remote columns of each row block, streamed; Hubbard overrides it with
the reference's exact tensor-product count) and ``n_vm`` (rows of each
block). ``est_nnz``
estimates the stored entries without a pattern pass (exact for RoadNet
and HubNet).
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

    # ---------------------------------------------------------------- χ --

    def n_vc(self, boundaries: np.ndarray, chunk: int = 2_000_000) -> np.ndarray:
        """Exact distinct-remote-column count per block (Eq. 5), streamed."""
        boundaries = np.asarray(boundaries, dtype=np.int64)
        P = len(boundaries) - 1
        out = np.zeros(P, dtype=np.int64)
        for p in range(P):
            a, b = int(boundaries[p]), int(boundaries[p + 1])
            remote: list[np.ndarray] = []
            for lo, hi in self._scan_ranges(a, b):
                for c0 in range(lo, hi, chunk):
                    c1 = min(c0 + chunk, hi)
                    _, cols = self.row_cols(np.arange(c0, c1, dtype=np.int64))
                    cols = cols[(cols < a) | (cols >= b)]
                    if cols.size:
                        remote.append(np.unique(cols))
            out[p] = np.unique(np.concatenate(remote)).size if remote else 0
        return out

    def _scan_ranges(self, a: int, b: int):
        """Row sub-ranges of [a,b) that can produce remote columns."""
        if self.reach is None or (b - a) <= 2 * self.reach:
            return [(a, b)]
        return [(a, a + self.reach), (b - self.reach, b)]

    def n_vm(self, boundaries: np.ndarray) -> np.ndarray:
        """Local vector entries per block; = block size (Eq. 3 note)."""
        return np.diff(np.asarray(boundaries, dtype=np.int64))

    def est_nnz(self, probe_rows: int = 4096) -> int:
        """Estimated stored entries of the whole matrix — a deterministic
        evenly-spaced row probe scaled to D (exact when the probe covers
        every row). The streaming planner's benchmarks normalize planning
        time by this without a pattern pass; families with closed-form
        counts (RoadNet, HubNet) override it exactly."""
        n = min(self.D, int(probe_rows))
        rows = np.unique(np.linspace(0, self.D - 1, max(n, 1)).astype(np.int64))
        r, _ = self.row_cols(rows)
        return int(round(len(r) * self.D / max(len(rows), 1)))

    def spectral_bounds_hint(self) -> tuple[float, float] | None:
        """Optional analytic inclusion interval (else Lanczos computes it)."""
        return None

    def describe(self) -> str:
        return f"{self.name}(D={self.D})"
