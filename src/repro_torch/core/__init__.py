"""Core of the port: the SpMV engines over P row shards (the horizontal
layer), the layouts over N_row × N_col shards and the stack↔panel
redistribution (the vertical layer), planned row maps, the Chebyshev
filter and its s-step form, KPM, Lanczos, orthogonalization, the χ
metrics and the FD solver (paper Algorithms 1 and 2) in PyTorch."""
from .shards import ShardGrid, ShardGroup
from .layouts import Layout, layout_on_grid, panel, pillar, stack
from .spmv import (DistEll, NeighborPlan, SstepEll, SstepNeighbor,
                   build_dist_ell, build_sstep_ell, make_fused_cheb_step,
                   make_spmv, make_sstep_cheb, neighbor_schedule,
                   sstep_ghosts)
from .partition import RowMap, plan_rowmap
from .redistribute import make_redistribute, redistribution_volume
from .chebyshev import (chebyshev_filter, chebyshev_filter_sstep, kpm_dos,
                        kpm_moments, scale_params)
from .filters import FilterPoly, build_filter, degree_for, jackson_damping, window_coeffs
from .orthogonalize import (gram, make_gram, make_svqb, make_tsqr, qr_fixed,
                            svqb)
from .lanczos import lanczos_interval
from .metrics import ChiMetrics, chi_from_nvc, chi_metrics
from .filter_diag import FDConfig, FDResult, FDState, FilterDiag

__all__ = [
    "ShardGrid", "ShardGroup", "Layout", "layout_on_grid", "panel",
    "pillar", "stack",
    "DistEll", "NeighborPlan", "build_dist_ell",
    "make_fused_cheb_step", "make_spmv", "neighbor_schedule",
    "SstepEll", "SstepNeighbor", "build_sstep_ell", "make_sstep_cheb",
    "sstep_ghosts",
    "RowMap", "plan_rowmap", "make_redistribute", "redistribution_volume",
    "chebyshev_filter", "chebyshev_filter_sstep", "kpm_moments", "kpm_dos",
    "scale_params",
    "FilterPoly", "build_filter", "degree_for", "jackson_damping", "window_coeffs",
    "gram", "make_gram", "make_svqb", "make_tsqr", "qr_fixed", "svqb",
    "lanczos_interval",
    "ChiMetrics", "chi_from_nvc", "chi_metrics",
    "FDConfig", "FDResult", "FDState", "FilterDiag",
]
