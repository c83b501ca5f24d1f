"""SpinChainXXZ matrix — ScaMaC-pattern-equivalent generator (the port's copy).

XXZ spin-1/2 chain (open boundaries) in the fixed-magnetization sector with
``n_up`` up-spins on ``n_sites`` sites:

    H = sum_b [ (Jxy/2)(S+_i S-_{i+1} + h.c.) + Jz Sz_i Sz_{i+1} ]

Basis: configurations in increasing-bitmask (combinadic) order, dimension
D = C(n_sites, n_up). Hop-target ranks come from the O(1) combinadic
rank-delta trick (no unranking of targets).
"""
from __future__ import annotations

import numpy as np

from .basis import binom_table, unrank
from .families import MatrixFamily, register


@register
class SpinChainXXZ(MatrixFamily):
    name = "SpinChainXXZ"
    is_complex = False

    def __init__(self, n_sites: int = 8, n_up: int = 4, Jxy: float = 1.0, Jz: float = 1.0):
        self.n_sites, self.n_up = int(n_sites), int(n_up)
        self.Jxy, self.Jz = float(Jxy), float(Jz)
        self._C = binom_table(self.n_sites)

    @property
    def D(self) -> int:
        return int(self._C[self.n_sites, self.n_up])

    def _hops(self, rows: np.ndarray, masks: np.ndarray):
        """Yield (sel, target_rank) per bond using the rank-delta formula.

        Swapping occupations across bond (i, i+1) changes the combinadic
        rank by ±(C(i+1, c) - C(i, c)) with c = popcount(mask & low(i+2)).
        """
        n = self.n_sites
        C = self._C
        for i in range(n - 1):
            bi = (masks >> i) & 1
            bj = (masks >> (i + 1)) & 1
            sel = np.nonzero(bi != bj)[0]
            if sel.size == 0:
                continue
            m = masks[sel]
            lowmask = (np.int64(1) << (i + 2)) - 1
            c = np.bitwise_count((m & lowmask).astype(np.uint64)).astype(np.int64)
            delta = C[i + 1, c] - C[i, c]
            up_move = ((m >> i) & 1) == 1  # bit moves i -> i+1: rank += delta
            tgt = rows[sel] + np.where(up_move, delta, -delta)
            yield sel, tgt

    def row_cols(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        masks = unrank(rows, self.n_sites, self.n_up)
        out_r = [rows]  # Jz diagonal
        out_c = [rows]
        for sel, tgt in self._hops(rows, masks):
            out_r.append(rows[sel])
            out_c.append(tgt)
        return np.concatenate(out_r), np.concatenate(out_c)

    def row_entries(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        masks = unrank(rows, self.n_sites, self.n_up)
        # diagonal: Jz * sum_b (n_i - 1/2)(n_{i+1} - 1/2)
        diag = np.zeros(len(rows))
        for i in range(self.n_sites - 1):
            zi = ((masks >> i) & 1).astype(np.float64) - 0.5
            zj = ((masks >> (i + 1)) & 1).astype(np.float64) - 0.5
            diag += self.Jz * zi * zj
        out_r, out_c, out_v = [rows], [rows], [diag]
        for sel, tgt in self._hops(rows, masks):
            out_r.append(rows[sel])
            out_c.append(tgt)
            out_v.append(np.full(sel.shape, 0.5 * self.Jxy))
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def spectral_bounds_hint(self):
        nb = self.n_sites - 1
        w = 0.5 * abs(self.Jxy) * nb + 0.25 * abs(self.Jz) * nb
        return (-w, w)

    def describe(self) -> str:
        return f"SpinChainXXZ,n_sites={self.n_sites},n_up={self.n_up} (D={self.D})"
