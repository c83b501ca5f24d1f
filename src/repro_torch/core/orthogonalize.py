"""Orthogonalization in the stack layout, on one device.

TSQR (Demmel et al. [11]) at P = 1 is its local QR with the sign fix
(``R`` gets a positive real diagonal, so the basis does not depend on the
QR routine's column signs). SVQB (Stathopoulos & Wu [41]) is a Gram matrix
and a replicated eigendecomposition. The butterfly over row shards and the
Gram all-reduce come with the horizontal layer. The dense QR, Gram product
and ``eigh`` go to ``torch.linalg`` / ``matmul``, as the reference leaves
them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

__all__ = ["qr_fixed", "gram", "svqb"]


def qr_fixed(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with the sign fix of the reference's ``_qr_fixed``."""
    Q, R = torch.linalg.qr(M)
    d = torch.diagonal(R)
    s = torch.where(d.abs() > 0, d / d.abs(), torch.ones_like(d))
    return Q * s.conj()[None, :], R / s[:, None]


def gram(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """V^H W."""
    return V.conj().T @ W


def svqb(V: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    """Orthonormal basis of span(V) (Gram + eigh)."""
    G = gram(V, V)
    d = torch.diagonal(G).real
    s = 1.0 / torch.sqrt(torch.clamp(d, min=eps))
    Gs = G * s[:, None] * s[None, :]
    w, U = torch.linalg.eigh(Gs)
    w = torch.maximum(w.real, eps * w.real.max())
    T = (s[:, None] * U) / torch.sqrt(w)[None, :]
    return V @ T.to(V.dtype)
