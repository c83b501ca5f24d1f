"""RoadNet config: D = 48,000 ring road + commuter corridor — the
comm-imbalanced family (χ₃/χ₂ ≈ 4 at P = 8) where the padded all_to_all
engine loses its imbalance factor on the wire and the sparsity-compressed
neighbor-permute engine (``--spmv-comm compressed``) wins it back; the
χ-driven planner picks the compressed engine here (``--layout auto``).
FD targets the low (smooth/community) end of the Laplacian spectrum.

The port's copy of ``repro/configs/roadnet48k.py``."""
from ..core.filter_diag import FDConfig

MATRIX = dict(family="RoadNet", n=48000, w=2, m=1200, k=4)
CONFIG = dict(
    matrix=MATRIX,
    fd=FDConfig(n_target=16, n_search=64, target=0.0, tol=1e-10,
                spmv_comm="compressed"),
    layouts=("stack", "panel", "pillar"),
)
SMOKE = dict(
    matrix=dict(family="RoadNet", n=4000, w=2, m=256, k=4),
    fd=FDConfig(n_target=4, n_search=16, target=0.0, tol=1e-8, max_iters=12,
                spmv_comm="compressed"),
)
