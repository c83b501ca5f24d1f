"""TopIns matrix — ScaMaC-pattern-equivalent generator (the port's copy).

3-D topological-insulator (Dirac/Wilson) 4-band lattice model:

    H = sum_{sites, d in {x,y,z}} psi†_r B_d psi_{r+e_d} + h.c.,
    B_d = (beta + i alpha_d)/2,

with the Dirac matrices alpha_d = sigma_x (x) sigma_d, beta = sigma_z (x) I.
Each hop block has exactly 2 nonzeros per row whose column union covers all
four orbitals, and there is no stored on-site term, reproducing Table 5:
n_nzr = 12 - 12/L (11.88 @ L=100, 11.98 @ L=500) and chi1[2] ~ 2/L = 0.02.
Index order is orbital-fastest: i = o + 4*(x + Lx*(y + Ly*z)).
Entries are complex (S_d = 16).
"""
from __future__ import annotations

import numpy as np

from .families import MatrixFamily, register

_s0 = np.eye(2)
_sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_beta = np.kron(_sz, _s0)
_alpha = {
    "x": np.kron(_sx, _sx),
    "y": np.kron(_sx, _sy),
    "z": np.kron(_sx, _sz),
}
# forward hop blocks; backward hop along d is the Hermitian conjugate
_B = {d: (_beta + 1j * a) / 2.0 for d, a in _alpha.items()}


@register
class TopIns(MatrixFamily):
    name = "TopIns"
    is_complex = True

    def __init__(self, Lx: int = 10, Ly: int | None = None, Lz: int | None = None, t: float = 1.0):
        self.Lx = int(Lx)
        self.Ly = int(Ly) if Ly is not None else self.Lx
        self.Lz = int(Lz) if Lz is not None else self.Lx
        self.t = float(t)
        self.reach = 4 * self.Lx * self.Ly

    @property
    def D(self) -> int:
        return 4 * self.Lx * self.Ly * self.Lz

    def _decode(self, rows: np.ndarray):
        o = rows % 4
        site = rows // 4
        x = site % self.Lx
        y = (site // self.Lx) % self.Ly
        z = site // (self.Lx * self.Ly)
        return o, site, x, y, z

    def _neighbor_entries(self, rows, o, coord, extent, stride, d, conj: bool):
        """(rows_sel, cols, vals) for hop ±e_d (conj=True is the backward hop)."""
        sgn = -1 if conj else +1
        ok = (coord + sgn >= 0) & (coord + sgn < extent)
        r = rows[ok]
        oo = o[ok]
        nbr_base = r - oo + sgn * stride  # orbital-0 index of neighbour site
        B = _B[d].conj().T if conj else _B[d]
        cols, vals = [], []
        rsel = []
        for col_o in range(4):
            m = np.abs(B[oo, col_o]) > 0
            rsel.append(r[m])
            cols.append(nbr_base[m] + col_o)
            vals.append(self.t * B[oo[m], col_o])
        return np.concatenate(rsel), np.concatenate(cols), np.concatenate(vals)

    def row_cols(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        o, site, x, y, z = self._decode(rows)
        out_r, out_c = [], []
        for d, coord, extent, stride in (
            ("x", x, self.Lx, 4),
            ("y", y, self.Ly, 4 * self.Lx),
            ("z", z, self.Lz, 4 * self.Lx * self.Ly),
        ):
            for conj in (False, True):
                r, c, _ = self._neighbor_entries(rows, o, coord, extent, stride, d, conj)
                out_r.append(r)
                out_c.append(c)
        return np.concatenate(out_r), np.concatenate(out_c)

    def row_entries(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        o, site, x, y, z = self._decode(rows)
        out_r, out_c, out_v = [], [], []
        for d, coord, extent, stride in (
            ("x", x, self.Lx, 4),
            ("y", y, self.Ly, 4 * self.Lx),
            ("z", z, self.Lz, 4 * self.Lx * self.Ly),
        ):
            for conj in (False, True):
                r, c, v = self._neighbor_entries(rows, o, coord, extent, stride, d, conj)
                out_r.append(r)
                out_c.append(c)
                out_v.append(v)
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def spectral_bounds_hint(self):
        return (-6.5 * self.t, 6.5 * self.t)

    def describe(self) -> str:
        return f"TopIns,Lx={self.Lx},Ly={self.Ly},Lz={self.Lz} (D={self.D})"
