"""Exciton matrix — ScaMaC-pattern-equivalent generator (the port's copy).

Models a bound electron-hole pair on an L-truncated 3-D lattice with three
orbital components per site (cf. Alvermann & Fehske, J. Phys. B 51, 044001):

  * kinetic 6-point stencil, orbital-diagonal hopping  (6 entries/row)
  * local 3x3 spin-orbit block, fully dense Hermitian  (3 entries/row)
  * attractive Coulomb diagonal  -V / max(r, 1)

Index order is orbital-fastest: i = o + 3*(x + S*(y + S*z)), S = 2L+1.
This reproduces the published sparsity characteristics exactly:
  n_nzr = 9 - 6/S  (8.96 @ L=75, 8.99 @ L=200),
  chi1[2] ~ 2/S    (0.01 @ L=75/200, Table 1).
Entries are complex (S_d = 16), as in the paper.
"""
from __future__ import annotations

import numpy as np

from .families import MatrixFamily, register

# dense Hermitian local block (orbital space); diagonal of the block is
# where the kinetic shift + Coulomb diagonal lives.
_SO = np.array(
    [[0.0, 1j, 1.0], [-1j, 0.0, 1j], [1.0, -1j, 0.0]], dtype=np.complex128
)


@register
class Exciton(MatrixFamily):
    name = "Exciton"
    is_complex = True

    def __init__(self, L: int = 10, t: float = 1.0, V: float = 2.0, so: float = 0.5):
        self.L = int(L)
        self.S = 2 * self.L + 1
        self.t, self.V, self.so = float(t), float(V), float(so)
        self.reach = 3 * self.S * self.S

    @property
    def D(self) -> int:
        return 3 * self.S**3

    # -------------------------------------------------------- pattern ----

    def _decode(self, rows: np.ndarray):
        o = rows % 3
        site = rows // 3
        x = site % self.S
        y = (site // self.S) % self.S
        z = site // (self.S * self.S)
        return o, site, x, y, z

    def row_cols(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        o, site, x, y, z = self._decode(rows)
        S = self.S
        out_r, out_c = [], []
        # local 3x3 block (includes the diagonal)
        for oo in range(3):
            out_r.append(rows)
            out_c.append(site * 3 + oo)
        # orbital-diagonal hops
        for coord, stride in ((x, 3), (y, 3 * S), (z, 3 * S * S)):
            for sgn in (+1, -1):
                ok = (coord + sgn >= 0) & (coord + sgn < S)
                out_r.append(rows[ok])
                out_c.append(rows[ok] + sgn * stride)
        return np.concatenate(out_r), np.concatenate(out_c)

    # -------------------------------------------------------- values ----

    def row_entries(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        o, site, x, y, z = self._decode(rows)
        S, L = self.S, self.L
        r = np.sqrt(
            (x - L).astype(np.float64) ** 2
            + (y - L).astype(np.float64) ** 2
            + (z - L).astype(np.float64) ** 2
        )
        diag = 6.0 * self.t - self.V / np.maximum(r, 1.0)
        out_r, out_c, out_v = [], [], []
        for oo in range(3):
            out_r.append(rows)
            out_c.append(site * 3 + oo)
            v = np.full(rows.shape, self.so * _SO[0, 0], dtype=np.complex128)
            for src in range(3):
                m = o == src
                v[m] = self.so * _SO[src, oo]
            v = v + np.where(o == oo, diag, 0.0)
            out_v.append(v)
        for coord, stride in ((x, 3), (y, 3 * S), (z, 3 * S * S)):
            for sgn in (+1, -1):
                ok = (coord + sgn >= 0) & (coord + sgn < S)
                out_r.append(rows[ok])
                out_c.append(rows[ok] + sgn * stride)
                out_v.append(np.full(int(ok.sum()), -self.t, dtype=np.complex128))
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def spectral_bounds_hint(self):
        # diag in [-V, 6t], hops 6*t, SO block norm ~ 2.2*so
        lo = -self.V - 6 * self.t - 3 * self.so
        hi = 12 * self.t + 3 * self.so
        return (lo, hi)

    def describe(self) -> str:
        return f"Exciton,L={self.L} (D={self.D}, n_nzr={9 - 6 / self.S:.2f})"
