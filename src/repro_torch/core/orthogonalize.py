"""Communication-avoiding orthogonalization in the stack layout.

TSQR (Demmel et al. [11]): a local QR per row shard, then a butterfly
over the shards, log2(P) rounds of ``ppermute`` exchanging only the small
N_s × N_s R factors (the reference's ``make_tsqr``,
``repro/core/orthogonalize.py:42-85``). SVQB (Stathopoulos & Wu [41]): the
Gram matrix through one all-reduce, then a replicated eigendecomposition.
Both run over a :class:`~repro_torch.core.shards.ShardGroup`; at P = 1
TSQR is its local QR. The dense QR, Gram product and ``eigh`` go to
``torch.linalg`` / ``matmul``, as the reference leaves them to XLA.

``R`` gets a positive real diagonal (``qr_fixed``), so the basis does not
depend on the QR routine's column signs.
"""
from __future__ import annotations

import math

import torch

from .shards import ShardGroup

__all__ = ["qr_fixed", "gram", "svqb", "make_tsqr", "make_gram",
           "make_svqb"]


def qr_fixed(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with the sign fix of the reference's ``_qr_fixed``."""
    Q, R = torch.linalg.qr(M)
    d = torch.diagonal(R)
    s = torch.where(d.abs() > 0, d / d.abs(), torch.ones_like(d))
    return Q * s.conj()[None, :], R / s[:, None]


def gram(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """V^H W on one shard."""
    return V.conj().T @ W


def svqb(V: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    """Orthonormal basis of span(V) (Gram + eigh), one shard."""
    return make_svqb(None, eps)(V)


def make_tsqr(group: ShardGroup):
    """``tsqr(V) -> (Q, R)`` for the stacked block ``V [P·R_loc, N_s]``.

    P must be a power of two. Each shard takes a local QR; at butterfly
    level ``l`` shard i exchanges its R with shard ``i ^ 2^l``, both stack
    the pair in the same (lower index above) order and take its QR, and
    each keeps the rows of the new Q that belong to it. Every shard ends
    with the same R; ``Q_p = Q0_p · acc_p``. Q is returned row-major, the
    layout the kernels take."""
    P = group.P
    levels = int(math.log2(P)) if P > 1 else 0
    if 2 ** levels != P:
        raise ValueError(f"TSQR butterfly needs power-of-two shards, got {P}")

    def tsqr(V: torch.Tensor):
        if P == 1:
            Q, R = qr_fixed(V)
            return Q.contiguous(), R
        Q0, Rs = [], []
        for p in range(P):
            q, r = qr_fixed(group.shard(V, p))
            Q0.append(q)
            Rs.append(r)
        acc = [None] * P
        Ns = Rs[0].shape[0]
        for lvl in range(levels):
            bit = 1 << lvl
            R_peer = group.ppermute(torch.stack(Rs),
                                    [(i, i ^ bit) for i in range(P)])
            new_R = []
            for p in range(P):
                lo = (p & bit) == 0
                A = torch.cat([Rs[p], R_peer[p]] if lo else [R_peer[p], Rs[p]])
                Qf, Rn = qr_fixed(A)
                mine = 0 if lo else 1
                Qblk = Qf[mine * Ns:(mine + 1) * Ns]
                acc[p] = Qblk if acc[p] is None else acc[p] @ Qblk
                new_R.append(Rn)
            Rs = new_R
        Q = V.new_empty(V.shape)
        for p in range(P):
            torch.matmul(Q0[p], acc[p], out=group.shard(Q, p))
        return Q, Rs[0]

    return tsqr


def make_gram(group: ShardGroup | None):
    """``gram(V, W) = V^H W``: each shard's partial ``V_p^H W_p``, then one
    all-reduce over the group (the product alone when ``group`` is None
    or holds one shard)."""
    if group is None or group.P == 1:
        return gram

    def gram_group(V, W):
        return group.psum(gram(group.shard(V, p), group.shard(W, p))
                          for p in range(group.P))

    return gram_group


def make_svqb(group: ShardGroup | None, eps: float = 1e-14):
    """``svqb(V)``: an orthonormal basis of span(V) from the Gram matrix
    (one all-reduce) and a replicated ``eigh``."""
    gram_fn = make_gram(group)

    def svqb_fn(V: torch.Tensor) -> torch.Tensor:
        G = gram_fn(V, V)
        d = torch.diagonal(G).real
        s = 1.0 / torch.sqrt(torch.clamp(d, min=eps))
        Gs = G * s[:, None] * s[None, :]
        w, U = torch.linalg.eigh(Gs)
        w = torch.maximum(w.real, eps * w.real.max())
        T = (s[:, None] * U) / torch.sqrt(w)[None, :]
        return V @ T.to(V.dtype)

    return svqb_fn
