"""HubNet config: D = 48,000 hub-and-spoke "airline" Laplacian — the
schedule-imbalanced family where the corridors land on many distinct
cyclic shifts (χ₃/χ₂ ≈ 5 at P = 32), so the cyclic neighbor schedule
pays one full-sized round per corridor shift while a greedy matching
packs all corridors into O(1) rounds (``--spmv-schedule matching``,
H_cyclic/H_matching ≈ 2–3); the χ-driven planner picks the matching
schedule here (``--layout auto``). FD targets the low
(smooth/community) end of the Laplacian spectrum.

The port's copy of ``repro/configs/hubnet48k.py``."""
from ..core.filter_diag import FDConfig

MATRIX = dict(family="HubNet", n=48000, w=2, h=5, m=512, k=4)
CONFIG = dict(
    matrix=MATRIX,
    fd=FDConfig(n_target=16, n_search=64, target=0.0, tol=1e-10,
                spmv_comm="compressed", spmv_schedule="matching"),
    layouts=("stack", "panel", "pillar"),
)
SMOKE = dict(
    matrix=dict(family="HubNet", n=4000, w=2, h=4, m=192, k=4),
    fd=FDConfig(n_target=4, n_search=16, target=0.0, tol=1e-8, max_iters=12,
                spmv_comm="compressed", spmv_schedule="matching"),
)
