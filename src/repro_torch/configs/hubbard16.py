"""Paper config: Hubbard, n_sites=16, n_fermions=8 (D = 165,636,900) with
U=25, ranpot=1 — Fig. 1/8, Table 1/4. Interior targets in partially
filled spectral gaps (tau = 15, 40, 66).

The port's copy of ``repro/configs/hubbard16.py``."""
from ..core.filter_diag import FDConfig

MATRIX = dict(family="Hubbard", n_sites=16, n_fermions=8, U=25.0, ranpot=1.0)
CONFIG = dict(
    matrix=MATRIX,
    fd=FDConfig(n_target=100, n_search=512, target=15.0, tol=1e-10),
    layouts=("stack", "panel", "pillar"),
)
SMOKE = dict(
    matrix=dict(family="Hubbard", n_sites=8, n_fermions=4, U=4.0, ranpot=1.0),
    fd=FDConfig(n_target=4, n_search=16, target=2.0, tol=1e-8, max_iters=12),
)
