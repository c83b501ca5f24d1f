"""Frozen plain copy of the Hubbard generator, for the benchmark's reference.

1-D Hubbard chain with open boundaries, ``n_sites`` sites and
``n_fermions`` electrons of each spin:

    H = -t sum_{<ij>,s} c+_{i,s} c_{j,s} + U sum_i n_{i,up} n_{i,dn}
        + ranpot sum_i eps_i (n_{i,up} + n_{i,dn}),   eps ~ U(-1, 1) (seed)

Basis |up> (x) |dn>, row ``i_up * D_spin + i_dn``, each spin sector in
increasing-bitmask order, D = C(n_sites, n_fermions)^2. The diagonal is
stored when U or ranpot is nonzero. NumPy only: it shares no code with the
program it judges, and ``portbench/tests/test_portbench_reference.py``
holds it to the program's generator entry for entry at small sizes.
"""
from __future__ import annotations

import numpy as np


def coo(n_sites: int, n_fermions: int, U: float, ranpot: float,
        t: float = 1.0, seed: int = 42):
    """``(rows, cols, vals, D)`` of the Hubbard matrix, float64."""
    n = int(n_sites)
    masks = np.asarray([m for m in range(1 << n)
                        if bin(m).count("1") == n_fermions], dtype=np.int64)
    Ds = len(masks)
    eps = np.random.default_rng(seed).uniform(-1.0, 1.0, size=n)
    # one spin's hops along the bonds (b, b+1): source and target index
    src, tgt = [], []
    for b in range(n - 1):
        sel = np.nonzero(((masks >> b) & 1) != ((masks >> (b + 1)) & 1))[0]
        src.append(sel)
        tgt.append(np.searchsorted(masks, masks[sel] ^ (3 << b)))
    src, tgt = np.concatenate(src), np.concatenate(tgt)
    every = np.arange(Ds, dtype=np.int64)
    rows, cols, vals = [], [], []
    if U != 0.0 or ranpot != 0.0:
        um, dm = masks[:, None], masks[None, :]
        dbl = np.zeros((Ds, Ds))
        pot = np.zeros((Ds, Ds))
        for s in range(n):
            bu, bd = (um >> s) & 1, (dm >> s) & 1
            dbl += bu & bd
            pot += eps[s] * (bu + bd)
        rows.append(np.arange(Ds * Ds, dtype=np.int64))
        cols.append(np.arange(Ds * Ds, dtype=np.int64))
        vals.append((U * dbl + ranpot * pot).ravel())
    # dn hops (u, d) -> (u, d'), up hops (u, d) -> (u', d)
    rows += [(every[:, None] * Ds + src).ravel(),
             (src[:, None] * Ds + every).ravel()]
    cols += [(every[:, None] * Ds + tgt).ravel(),
             (tgt[:, None] * Ds + every).ravel()]
    vals += [np.full(Ds * len(src), -float(t))] * 2
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            Ds * Ds)
