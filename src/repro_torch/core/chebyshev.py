"""Chebyshev filter evaluation — paper Algorithm 2.

Evaluates V <- p[A]V for p(x) = sum_k mu_k T_k(x) with the three-term
recurrence and the fused SpMV+axpy step (kernel fusion keeps the vector
traffic factor at κ=5 instead of 6 — paper §3.2). The reference's
``lax.scan`` becomes a Python loop with the same accumulation order
(``Y = Y + mu_k·T_k``); ``Y`` is updated in place, so the loop holds four
blocks (Y and three recurrence terms) and allocates one per step.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["scale_params", "chebyshev_filter"]


def scale_params(lambda_l: float, lambda_r: float) -> tuple[float, float]:
    """alpha, beta mapping spec(A) in [λl, λr] onto [-1, 1] (Alg. 2 step 1)."""
    alpha = 2.0 / (lambda_r - lambda_l)
    beta = (lambda_l + lambda_r) / (lambda_l - lambda_r)
    return alpha, beta


def chebyshev_filter(spmv, mu, alpha: float, beta: float, V: torch.Tensor,
                     fused_step=None) -> torch.Tensor:
    """Return p[A]V given ``spmv``.

    ``mu`` is a length-(n+1) coefficient array (n >= 2); it and ``alpha``,
    ``beta`` are rounded to V's real dtype (float64 for a complex128 block,
    float32 for complex64), as the reference does. ``fused_step(w1, w2,
    alpha, beta)``, when given
    (:func:`~repro_torch.core.spmv.make_fused_cheb_step`), replaces the
    inline ``2a·spmv(w1) + 2b·w1 - w2`` step.
    """
    np_dt = (np.float64 if V.dtype in (torch.float64, torch.complex128)
             else np.float32)
    mu = [float(m) for m in np.asarray(mu, dtype=np_dt)]
    n = len(mu) - 1
    if n < 2:
        raise ValueError(f"filter degree must be >= 2, got {n}")
    a = float(np_dt(alpha))
    b = float(np_dt(beta))

    if fused_step is None:
        def fused_step(w1, w2, alpha_, beta_):
            return 2 * a * spmv(w1) + 2 * b * w1 - w2  # fused SpMV+axpy

    W1 = a * spmv(V) + b * V                     # T1
    W2 = fused_step(W1, V, alpha, beta)          # T2
    Y = mu[0] * V + mu[1] * W1 + mu[2] * W2
    Tkm1, Tkm2 = W2, W1
    for mu_k in mu[3:]:
        Tk = fused_step(Tkm1, Tkm2, alpha, beta)
        Y.add_(Tk, alpha=mu_k)
        Tkm1, Tkm2 = Tk, Tkm1
    return Y
