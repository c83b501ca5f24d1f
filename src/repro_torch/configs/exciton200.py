"""Paper config: Exciton, L=200 (D = 193,443,603) — Fig. 1/7, Table 1/4.
FD setup follows Table 4: N_s=384 search vectors, N_t=100 targets at the
lower spectral edge, pillar layout on 256+ chips.

The port's copy of ``repro/configs/exciton200.py``."""
from ..core.filter_diag import FDConfig

MATRIX = dict(family="Exciton", L=200)
CONFIG = dict(
    matrix=MATRIX,
    fd=FDConfig(n_target=100, n_search=384, target=-0.4, tol=1e-10),
    layouts=("stack", "panel", "pillar"),
)
SMOKE = dict(
    matrix=dict(family="Exciton", L=4),
    fd=FDConfig(n_target=4, n_search=16, target=-1.2, tol=1e-8, max_iters=12),
)
