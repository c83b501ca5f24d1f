"""Lanczos spectral inclusion interval (Alg. 1 step 1).

A few Lanczos steps on a random vector give Ritz value bounds; the residual
of the extremal Ritz pairs provides a rigorous safety margin so that
spec(A) ⊂ [λ_l, λ_r] (required for the Chebyshev map to stay in [-1,1]).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["lanczos_interval"]


def lanczos_interval(spmv, D: int, dtype: torch.dtype, device, v0=None,
                     generator: torch.Generator | None = None,
                     steps: int = 30, safety: float = 1.05,
                     D_pad: int | None = None, mask=None):
    """Return (lambda_l, lambda_r) enclosing spec(A).

    ``spmv`` acts on [D_pad, 1] tensors (``D_pad`` defaults to D; the
    stacked block of P row shards pads D to a multiple of P). The pad rows
    are kept exactly zero, so the padded operator's null modes never enter
    the Krylov space: the start vector is multiplied by ``mask``, a
    [D_pad] bool of the positions that hold a row (``RowMap.valid_mask()``;
    by default the tail ``[D, D_pad)`` is the pad), as the reference does
    (``repro/core/lanczos.py:31-34``). The start vector is ``v0`` (numpy
    or tensor, D_pad entries in position space) when given; otherwise it
    is drawn from ``generator`` ([D_pad, 1]), real, and cast to ``dtype``
    (complex too), as the reference draws it. The tridiagonal
    coefficients are accumulated on the host (scalars: one tiny transfer
    per step).
    """
    D_pad = D if D_pad is None else int(D_pad)
    if v0 is None:
        v = torch.randn((D_pad, 1), generator=generator, dtype=torch.float64,
                        device=device).to(dtype)
    else:
        v = torch.as_tensor(np.array(v0) if not isinstance(v0, torch.Tensor)
                            else v0).reshape(-1, 1).to(device=device, dtype=dtype)
    mask = (torch.arange(D_pad, device=v.device) < D if mask is None
            else torch.as_tensor(mask, device=v.device))
    if v.shape[0] != D_pad or mask.shape != (D_pad,):
        raise ValueError(f"the start vector and the mask need {D_pad} "
                         f"entries, got v0 {tuple(v.shape)}, mask "
                         f"{tuple(mask.shape)}")
    v = v * mask[:, None].to(v.dtype)
    v = v / torch.linalg.norm(v)
    alphas, betas = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(steps):
        w = spmv(v)
        a = float(torch.vdot(v[:, 0], w[:, 0]).real)
        w = w - a * v - beta * v_prev
        b = float(torch.linalg.norm(w))
        alphas.append(a)
        betas.append(b)
        if b < 1e-12:
            break
        # ``beta`` stays 0.0, as in the reference (``repro/core/lanczos.py``
        # never updates it): the recurrence orthogonalizes against v only.
        # Kept for parity; the safety margin covers the looser bounds.
        v_prev, v = v, w / b
    T = np.diag(alphas)
    off = betas[: len(alphas) - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    theta, Y = np.linalg.eigh(T)
    resid = betas[len(alphas) - 1] * np.abs(Y[-1, :])  # Ritz residual bounds
    lo = float(theta[0] - resid[0])
    hi = float(theta[-1] + resid[-1])
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    return mid - safety * half, mid + safety * half
