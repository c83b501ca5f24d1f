"""Core of the port: the one-shard SpMV, the Chebyshev filter, Lanczos,
orthogonalization and the FD driver (paper Algorithms 1 and 2) in PyTorch."""
from .spmv import DistEll, build_dist_ell, make_fused_cheb_step, make_spmv
from .chebyshev import chebyshev_filter, scale_params
from .filters import FilterPoly, build_filter, degree_for, jackson_damping, window_coeffs
from .orthogonalize import gram, qr_fixed, svqb
from .lanczos import lanczos_interval
from .filter_diag import FDConfig, FDResult, FDState, FilterDiag

__all__ = [
    "DistEll", "build_dist_ell", "make_fused_cheb_step", "make_spmv",
    "chebyshev_filter", "scale_params",
    "FilterPoly", "build_filter", "degree_for", "jackson_damping", "window_coeffs",
    "gram", "qr_fixed", "svqb",
    "lanczos_interval",
    "FDConfig", "FDResult", "FDState", "FilterDiag",
]
