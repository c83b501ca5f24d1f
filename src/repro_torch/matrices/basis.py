"""Occupation-number basis utilities for many-body matrices (Hubbard, SpinChainXXZ).

Configurations of ``k`` particles on ``n`` sites are represented as n-bit
masks. The basis is ordered by *increasing numeric value* of the mask (the
standard combinadic / combinatorial-number-system order, which is what
ScaMaC-style generators use). Rank/unrank are fully vectorized so that
bases with 1e8+ configurations can be processed in chunks.
"""
from __future__ import annotations

import numpy as np
from functools import lru_cache

__all__ = [
    "binom_table",
    "enumerate_masks",
    "rank_masks",
    "unrank",
    "hop_neighbors",
]


@lru_cache(maxsize=None)
def binom_table(n_max: int) -> np.ndarray:
    """(n_max+1, n_max+1) table of binomial coefficients C[n, k] in int64."""
    C = np.zeros((n_max + 1, n_max + 1), dtype=np.int64)
    C[:, 0] = 1
    for n in range(1, n_max + 1):
        for k in range(1, n + 1):
            C[n, k] = C[n - 1, k - 1] + C[n - 1, k]
    return C


def enumerate_masks(n: int, k: int) -> np.ndarray:
    """All n-bit masks with popcount k, in increasing numeric order.

    Only intended for small bases (C(n,k) ≲ 2e7); larger bases should be
    processed through :func:`unrank` in chunks.
    """
    C = binom_table(n)
    D = int(C[n, k])
    return unrank(np.arange(D, dtype=np.int64), n, k)


def rank_masks(masks: np.ndarray, n: int, k: int) -> np.ndarray:
    """Rank of each mask in the increasing-numeric-order C(n,k) basis.

    Vectorized combinadic ranking: rank(m) = sum over set bits at position p
    (with c set bits at positions <= p) of C(p, c).
    """
    C = binom_table(n)
    masks = np.asarray(masks, dtype=np.int64)
    rank = np.zeros(masks.shape, dtype=np.int64)
    c = np.zeros(masks.shape, dtype=np.int64)
    for p in range(n):
        bit = (masks >> p) & 1
        c += bit
        # C[p, c] contribution where the bit is set
        rank += np.where(bit == 1, C[p, np.minimum(c, p + 1)], 0)
    return rank


def unrank(ranks: np.ndarray, n: int, k: int) -> np.ndarray:
    """Inverse of :func:`rank_masks` (vectorized greedy combinadic unrank)."""
    C = binom_table(n)
    r = np.asarray(ranks, dtype=np.int64).copy()
    masks = np.zeros(r.shape, dtype=np.int64)
    kk = np.full(r.shape, k, dtype=np.int64)
    for p in range(n - 1, -1, -1):
        # set bit p iff C(p, kk) <= r (and kk > 0)
        c = C[p, np.minimum(kk, p + 1)]
        take = (kk > 0) & (r >= c) & (kk <= p + 1)
        r = np.where(take, r - c, r)
        masks = np.where(take, masks | (np.int64(1) << p), masks)
        kk = np.where(take, kk - 1, kk)
    return masks


def hop_neighbors(masks: np.ndarray, n: int, k: int, periodic: bool = False):
    """Nearest-neighbour hop targets on a 1-D chain.

    For every mask and bond (i, i+1) with differing occupations, the hop
    swaps the two bits: target = mask XOR (2^i | 2^{i+1}).

    Returns ``(src_idx, tgt_masks, bond)`` where ``src_idx`` indexes into
    ``masks``. Open boundary conditions by default (matches ScaMaC
    n_nzr = n_sites at half filling: (n_s-1) bonds, plus stored diagonal
    only when an interaction/potential term is enabled).
    """
    masks = np.asarray(masks, dtype=np.int64)
    src_list, tgt_list, bond_list = [], [], []
    bonds = n if periodic else n - 1
    for b in range(bonds):
        i, j = b, (b + 1) % n
        flip = (np.int64(1) << i) | (np.int64(1) << j)
        bi = (masks >> i) & 1
        bj = (masks >> j) & 1
        sel = np.nonzero(bi != bj)[0]
        src_list.append(sel)
        tgt_list.append(masks[sel] ^ flip)
        bond_list.append(np.full(sel.shape, b, dtype=np.int32))
    return (
        np.concatenate(src_list),
        np.concatenate(tgt_list),
        np.concatenate(bond_list),
    )
