"""Hubbard matrix — ScaMaC-pattern-equivalent generator (the port's copy).

1-D Hubbard chain (open boundaries) with n_sites sites and n_fermions
electrons per spin orientation:

    H = -t sum_{<ij>,sigma} c†_{i,sigma} c_{j,sigma}
        + U sum_i n_{i,up} n_{i,dn}  + ranpot * sum_i eps_i (n_{i,up}+n_{i,dn})

Basis: |up> (x) |dn>, index i = i_up * D_spin + i_dn, each spin sector in
increasing-bitmask (combinadic) order. Dimension D = C(n_sites,n_fermions)^2.
The diagonal is stored only when U or ranpot is nonzero. The χ counts
(``n_vc``) are exact at any D through the tensor-product structure, as the
reference computes them: remote-column counting reduces to the
D_spin-sized single-spin hop graph (O(D_spin) per block instead of O(D)).
"""
from __future__ import annotations

import numpy as np

from .basis import binom_table, enumerate_masks, hop_neighbors, rank_masks
from .families import MatrixFamily, register


@register
class Hubbard(MatrixFamily):
    name = "Hubbard"
    is_complex = False

    def __init__(
        self,
        n_sites: int = 8,
        n_fermions: int = 4,
        t: float = 1.0,
        U: float = 0.0,
        ranpot: float = 0.0,
        seed: int = 42,
    ):
        self.n_sites, self.n_fermions = int(n_sites), int(n_fermions)
        self.t, self.U, self.ranpot = float(t), float(U), float(ranpot)
        C = binom_table(self.n_sites)
        self.D_spin = int(C[self.n_sites, self.n_fermions])
        if self.D_spin > 40_000_000:
            raise MemoryError("spin sector too large to enumerate")
        self.masks = enumerate_masks(self.n_sites, self.n_fermions)
        rng = np.random.default_rng(seed)
        self.eps = rng.uniform(-1.0, 1.0, size=self.n_sites)
        # single-spin hop graph (CSR over the spin sector)
        src, tgt_masks, _ = hop_neighbors(self.masks, self.n_sites, self.n_fermions)
        tgt = rank_masks(tgt_masks, self.n_sites, self.n_fermions)
        order = np.argsort(src, kind="stable")
        src, tgt = src[order], tgt[order]
        self.adj_indptr = np.zeros(self.D_spin + 1, dtype=np.int64)
        np.add.at(self.adj_indptr, src + 1, 1)
        self.adj_indptr = np.cumsum(self.adj_indptr)
        self.adj_targets = tgt

    @property
    def D(self) -> int:
        return self.D_spin * self.D_spin

    @property
    def has_diag(self) -> bool:
        return self.U != 0.0 or self.ranpot != 0.0

    def _adj_expand(self, idx: np.ndarray):
        """Vectorized (row_repeat, targets, counts) for many spin rows."""
        idx = np.asarray(idx, dtype=np.int64)
        counts = (self.adj_indptr[idx + 1] - self.adj_indptr[idx]).astype(np.int64)
        total = int(counts.sum())
        row_rep = np.repeat(idx, counts)
        starts = np.repeat(self.adj_indptr[idx], counts)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        return row_rep, self.adj_targets[starts + offs], counts

    def row_cols(self, rows: np.ndarray):
        r, c, _ = self.row_entries(rows)
        return r, c

    def row_entries(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        Ds = self.D_spin
        i_up, i_dn = rows // Ds, rows % Ds
        out_r, out_c, out_v = [], [], []
        if self.has_diag:
            up_m, dn_m = self.masks[i_up], self.masks[i_dn]
            dbl = np.bitwise_count(up_m & dn_m).astype(np.float64)
            pot = np.zeros(len(rows))
            for s in range(self.n_sites):
                occ = ((up_m >> s) & 1) + ((dn_m >> s) & 1)
                pot += self.eps[s] * occ
            out_r.append(rows)
            out_c.append(rows)
            out_v.append(self.U * dbl + self.ranpot * pot)
        _, tgt_dn, cnt_dn = self._adj_expand(i_dn)
        out_r.append(np.repeat(rows, cnt_dn))
        out_c.append(np.repeat(i_up, cnt_dn) * Ds + tgt_dn)
        out_v.append(np.full(tgt_dn.shape, -self.t))
        _, tgt_up, cnt_up = self._adj_expand(i_up)
        out_r.append(np.repeat(rows, cnt_up))
        out_c.append(tgt_up * Ds + np.repeat(i_dn, cnt_up))
        out_v.append(np.full(tgt_up.shape, -self.t))
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    # ------------------------------------------------- structured n_vc ----

    def _targets_bool(self, ups: "np.ndarray | range") -> np.ndarray:
        """Union of spin-hop targets over the given source rows, as bool[Ds]."""
        out = np.zeros(self.D_spin, dtype=bool)
        ups = np.asarray(list(ups) if isinstance(ups, range) else ups, dtype=np.int64)
        if len(ups) == 0:
            return out
        _, tgt, _ = self._adj_expand(ups)
        out[tgt] = True
        return out

    def _dn_targets_from(self, lo: int, hi: int) -> np.ndarray:
        """Distinct dn-hop targets from sources i_dn in [lo,hi), as bool[Ds]."""
        return self._targets_bool(np.arange(lo, hi, dtype=np.int64))

    def n_vc(self, boundaries: np.ndarray, chunk: int = 2_000_000) -> np.ndarray:
        boundaries = np.asarray(boundaries, dtype=np.int64)
        P = len(boundaries) - 1
        Ds = self.D_spin
        out = np.zeros(P, dtype=np.int64)
        for p in range(P):
            a, b = int(boundaries[p]), int(boundaries[p + 1])
            u0, d0 = divmod(a, Ds)
            u1, d1 = divmod(b, Ds)
            if u0 == u1:  # block inside a single up-sector
                # up-hops: every target j_up != u0 is fully remote
                T0 = self._targets_bool([u0])
                n = int(T0.sum()) * (d1 - d0)
                # dn-hops from [d0,d1): targets outside [d0,d1) are remote
                tb = self._dn_targets_from(d0, d1)
                tb[d0:d1] = False
                out[p] = n + int(tb.sum())
                continue
            # full up-sectors in [u0(+1) .. u1)
            fu0 = u0 + 1 if d0 > 0 else u0
            F = self._targets_bool(range(fu0, u1))
            T0 = self._targets_bool([u0]) if d0 > 0 else np.zeros(Ds, dtype=bool)
            T1 = self._targets_bool([u1]) if d1 > 0 else np.zeros(Ds, dtype=bool)
            # coverage |i_dn set| for generic j_up (vectorized interval math)
            covA = Ds - d0  # from partial-first sources (i_dn in [d0,Ds))
            covB = d1  # from partial-last sources (i_dn in [0,d1))
            covAB = covA + covB - max(0, d1 - d0)  # union of the intervals
            cov = np.where(
                F, Ds, np.where(T0 & T1, covAB, np.where(T0, covA, np.where(T1, covB, 0)))
            ).astype(np.int64)
            # generic j_up: exclude locals (full sectors) and the two edges
            cov[fu0:u1] = 0
            cov[u0] = 0
            cov[u1 if d1 > 0 else u0] = 0
            total = int(cov.sum())
            # edge sector u0 (local i_dn in [d0,Ds)) — remote part m < d0
            if d0 > 0:
                e = np.zeros(Ds, dtype=bool)
                if F[u0]:
                    e[:d0] = True
                elif T1[u0]:
                    e[: min(d0, d1)] = True
                # dn-hops within u0 partial rows
                tb = self._dn_targets_from(d0, Ds)
                tb[d0:] = False
                e |= tb
                total += int(e.sum())
            # edge sector u1 (local i_dn in [0,d1)) — remote part m >= d1
            if d1 > 0:
                e = np.zeros(Ds, dtype=bool)
                if F[u1]:
                    e[d1:] = True
                elif T0[u1]:
                    e[max(d0, d1):] = True
                tb = self._dn_targets_from(0, d1)
                tb[:d1] = False
                e |= tb
                total += int(e.sum())
            out[p] = total
        return out

    def spectral_bounds_hint(self):
        w = 2 * self.t * self.n_sites  # loose kinetic bound
        lo = -w - self.ranpot * 2 * self.n_sites
        hi = w + self.U * min(self.n_fermions, self.n_sites) + self.ranpot * 2 * self.n_sites
        return (lo, hi)

    def describe(self) -> str:
        return (
            f"Hubbard,n_sites={self.n_sites},n_fermions={self.n_fermions} "
            f"(D={self.D}, U={self.U}, ranpot={self.ranpot})"
        )
