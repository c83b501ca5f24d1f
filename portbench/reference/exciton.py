"""Frozen plain copy of the Exciton generator, for the benchmark's reference.

A bound electron-hole pair on the L-truncated cubic lattice of side
S = 2L+1 with three orbitals a site (row ``o + 3*(x + S*(y + S*z))``):
an orbital-diagonal 6-point hopping ``-t``, a dense Hermitian 3x3
spin-orbit block ``so * SO`` and the Coulomb diagonal
``6t - V / max(r, 1)``, r the distance from the centre. D = 3 S^3, complex
entries. NumPy only: it shares no code with the program it judges, and
``portbench/tests/test_portbench_reference.py`` holds it to the program's
generator entry for entry at small sizes.
"""
from __future__ import annotations

import numpy as np

SO = np.array([[0.0, 1j, 1.0], [-1j, 0.0, 1j], [1.0, -1j, 0.0]],
              dtype=np.complex128)


def coo(L: int, t: float = 1.0, V: float = 2.0, so: float = 0.5):
    """``(rows, cols, vals, D)`` of the Exciton matrix, complex128."""
    S = 2 * int(L) + 1
    D = 3 * S ** 3
    rows = np.arange(D, dtype=np.int64)
    o, site = rows % 3, rows // 3
    x, y, z = site % S, (site // S) % S, site // (S * S)
    r = np.sqrt((x - L) ** 2.0 + (y - L) ** 2.0 + (z - L) ** 2.0)
    coul = 6.0 * t - V / np.maximum(r, 1.0)
    out_r, out_c, out_v = [], [], []
    for oo in range(3):  # the local block, row orbital o, column orbital oo
        out_r.append(rows)
        out_c.append(site * 3 + oo)
        out_v.append(so * SO[o, oo] + np.where(o == oo, coul, 0.0))
    for coord, stride in ((x, 3), (y, 3 * S), (z, 3 * S * S)):
        for sgn in (1, -1):
            ok = (coord + sgn >= 0) & (coord + sgn < S)
            out_r.append(rows[ok])
            out_c.append(rows[ok] + sgn * stride)
            out_v.append(np.full(int(ok.sum()), -t, dtype=np.complex128))
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_v), D)
