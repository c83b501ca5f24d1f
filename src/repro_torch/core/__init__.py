"""Core of the port: the SpMV engines over P row shards (the horizontal
layer), the Chebyshev filter, Lanczos, orthogonalization, the χ metrics
and the FD driver (paper Algorithms 1 and 2) in PyTorch."""
from .shards import ShardGroup
from .layouts import Layout, stack
from .spmv import (DistEll, NeighborPlan, Partition, build_dist_ell,
                   make_fused_cheb_step, make_spmv, neighbor_schedule)
from .chebyshev import chebyshev_filter, scale_params
from .filters import FilterPoly, build_filter, degree_for, jackson_damping, window_coeffs
from .orthogonalize import (gram, make_gram, make_svqb, make_tsqr, qr_fixed,
                            svqb)
from .lanczos import lanczos_interval
from .metrics import ChiMetrics, chi_from_nvc, chi_metrics
from .filter_diag import FDConfig, FDResult, FDState, FilterDiag

__all__ = [
    "ShardGroup", "Layout", "stack",
    "DistEll", "NeighborPlan", "Partition", "build_dist_ell",
    "make_fused_cheb_step", "make_spmv", "neighbor_schedule",
    "chebyshev_filter", "scale_params",
    "FilterPoly", "build_filter", "degree_for", "jackson_damping", "window_coeffs",
    "gram", "make_gram", "make_svqb", "make_tsqr", "qr_fixed", "svqb",
    "lanczos_interval",
    "ChiMetrics", "chi_from_nvc", "chi_metrics",
    "FDConfig", "FDResult", "FDState", "FilterDiag",
]
