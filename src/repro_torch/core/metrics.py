"""Communication metrics χ₁, χ₂, χ₃ (paper Eqs. 8–10): the port's copy of
``repro.core.metrics`` (``ChiMetrics``, ``chi_from_nvc``, ``chi_metrics``).

Computed from the matrix's sparsity pattern alone, before any code runs;
all are zero for N_p = 1. They depend only on the row partition (uniform
by default, Eq. 1; ``chi_from_nvc`` takes any partition's counts, e.g. the
equal-rows blocks of ``build_dist_ell``).

    χ₁ = max_p  n_vc(p) / n_vm(p)          (remote / local accesses)
    χ₂ = Σ_p    n_vc(p) / D                (aggregate comm volume / D)
    χ₃ = N_p · max_p n_vc(p) / D           (parallel-efficiency bound)

χ₃/χ₂ (``imbalance``) above 2–3 says that the communication volume is
imbalanced over the shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..matrices.families import MatrixFamily
from ..matrices.sparse import uniform_partition

__all__ = ["ChiMetrics", "chi_metrics", "chi_from_nvc"]


@dataclasses.dataclass(frozen=True)
class ChiMetrics:
    N_p: int
    D: int
    chi1: float
    chi2: float
    chi3: float
    n_vc: np.ndarray  # per-process distinct remote columns
    n_vm: np.ndarray  # per-process local vector entries

    @property
    def imbalance(self) -> float:
        """χ₃/χ₂ — above ~2–3 indicates severe comm-volume imbalance."""
        return self.chi3 / self.chi2 if self.chi2 > 0 else 1.0

    def efficiency_bound(self, bc_over_bm: float) -> float:
        """Π ≲ min{1, χ₃⁻¹ · b_c/b_m}  (Eq. 11)."""
        if self.chi3 == 0:
            return 1.0
        return min(1.0, bc_over_bm / self.chi3)

    def row(self) -> str:
        return f"{self.N_p:4d}  chi1,3={self.chi1:6.2f}  chi2={self.chi2:6.2f}"


def chi_from_nvc(n_vc: np.ndarray, n_vm: np.ndarray, D: int) -> ChiMetrics:
    n_vc = np.asarray(n_vc, dtype=np.int64)
    n_vm = np.asarray(n_vm, dtype=np.int64)
    P = len(n_vc)
    if P == 1:
        return ChiMetrics(1, D, 0.0, 0.0, 0.0, n_vc * 0, n_vm)
    return ChiMetrics(
        N_p=P,
        D=D,
        chi1=float((n_vc / np.maximum(n_vm, 1)).max()),
        chi2=float(n_vc.sum() / D),
        chi3=float(P * n_vc.max() / D),
        n_vc=n_vc,
        n_vm=n_vm,
    )


def chi_metrics(matrix: MatrixFamily, N_p: int,
                boundaries: np.ndarray | None = None) -> ChiMetrics:
    """Exact χ metrics for a matrix family at N_p processes."""
    if boundaries is None:
        boundaries = uniform_partition(matrix.D, N_p)
    n_vc = matrix.n_vc(boundaries)
    return chi_from_nvc(n_vc, matrix.n_vm(boundaries), matrix.D)
