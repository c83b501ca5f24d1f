"""Chebyshev filter evaluation — paper Algorithm 2.

Evaluates V <- p[A]V for p(x) = sum_k mu_k T_k(x) with the three-term
recurrence and the fused SpMV+axpy step (kernel fusion keeps the vector
traffic factor at κ=5 instead of 6 — paper §3.2). The reference's
``lax.scan`` becomes a Python loop with the same accumulation order
(``Y = Y + mu_k·T_k``); ``Y`` is updated in place, so the loop holds four
blocks (Y and three recurrence terms) and allocates one per step.

``mu`` may also be ``[n+1, n_cols]``, one coefficient column per column
of V (the reference batcher's ``Mu``, ``repro/service/batcher.py:
198-205``): the columns of several requests share one sweep, each with
its own polynomial, zero-padded past its own degree. Each step then
updates ``Y.addcmul_(T_k, mu[k])``, one rounding per element as
``Y.add_(T_k, alpha=mu_k)`` has (both a fused multiply-add, on the CPU
in every dtype and on the card), so a column whose coefficients equal a
1-D ``mu`` gets that filter's bits, and a zero-padded column its own
degree's (``Y + 0·T_k`` is ``Y``).

:func:`chebyshev_filter_sstep` evaluates the same polynomial in ⌈n/s⌉
groups of s steps, one depth-s ghost exchange each
(``core/spmv.py::make_sstep_cheb``), with the same accumulation; KPM
moments and the DOS built from them (the density-of-states panels) come
along from the same file of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["scale_params", "chebyshev_filter", "chebyshev_filter_sstep",
           "kpm_moments", "kpm_dos"]


def scale_params(lambda_l: float, lambda_r: float) -> tuple[float, float]:
    """alpha, beta mapping spec(A) in [λl, λr] onto [-1, 1] (Alg. 2 step 1)."""
    alpha = 2.0 / (lambda_r - lambda_l)
    beta = (lambda_l + lambda_r) / (lambda_l - lambda_r)
    return alpha, beta


def _real_dtype(V: torch.Tensor):
    """V's real numpy dtype: float64 for a complex128 block, float32 for
    complex64."""
    return (np.float64 if V.dtype in (torch.float64, torch.complex128)
            else np.float32)


def _rounded(V: torch.Tensor, mu, alpha: float, beta: float):
    """``mu``, ``alpha`` and ``beta`` rounded to V's real dtype, as the
    reference rounds them; the degree must be at least 2. A 1-D ``mu``
    becomes a list of floats, a 2-D ``[n+1, n_cols]`` one a tensor on V's
    device (``n_cols`` must be V's)."""
    np_dt = _real_dtype(V)
    mu = np.asarray(mu, dtype=np_dt)
    if mu.ndim not in (1, 2) or (mu.ndim == 2 and mu.shape[1] != V.shape[1]):
        raise ValueError(f"mu must be [n+1] or [n+1, {V.shape[1]}], got "
                         f"{list(mu.shape)}")
    if mu.shape[0] - 1 < 2:
        raise ValueError(f"filter degree must be >= 2, got {mu.shape[0] - 1}")
    mu = ([float(m) for m in mu] if mu.ndim == 1
          else torch.as_tensor(mu, device=V.device))
    return mu, float(np_dt(alpha)), float(np_dt(beta))


def chebyshev_filter(spmv, mu, alpha: float, beta: float, V: torch.Tensor,
                     fused_step=None) -> torch.Tensor:
    """Return p[A]V given ``spmv``.

    ``mu`` is a length-(n+1) coefficient array (n >= 2), or ``[n+1,
    n_cols]`` with a column per column of V (module docstring); it and
    ``alpha``, ``beta`` are rounded to V's real dtype (float64 for a
    complex128 block, float32 for complex64), as the reference does.
    ``fused_step(w1, w2, alpha, beta)``, when given
    (:func:`~repro_torch.core.spmv.make_fused_cheb_step`), replaces the
    inline ``2a·spmv(w1) + 2b·w1 - w2`` step.
    """
    mu, a, b = _rounded(V, mu, alpha, beta)
    n = len(mu) - 1
    per_column = isinstance(mu, torch.Tensor)

    if fused_step is None:
        def fused_step(w1, w2, alpha_, beta_):
            return 2 * a * spmv(w1) + 2 * b * w1 - w2  # fused SpMV+axpy

    W1 = a * spmv(V) + b * V                     # T1
    W2 = fused_step(W1, V, alpha, beta)          # T2
    Y = mu[0] * V + mu[1] * W1 + mu[2] * W2
    Tkm1, Tkm2 = W2, W1
    for k in range(3, n + 1):
        Tk = fused_step(Tkm1, Tkm2, alpha, beta)
        if per_column:
            Y.addcmul_(Tk, mu[k])
        else:
            Y.add_(Tk, alpha=mu[k])
        Tkm1, Tkm2 = Tk, Tkm1
    return Y


def chebyshev_filter_sstep(group, mu, alpha: float, beta: float,
                           V: torch.Tensor, s: int) -> torch.Tensor:
    """p[A]V in ⌈n/s⌉ depth-s ghost exchanges (the reference's
    ``chebyshev_filter_sstep``, ``repro/core/chebyshev.py:68-120``).

    ``group(n_steps, first, carry, coeffs, emit)`` (the applier of
    ``core/spmv.py::make_sstep_cheb``) runs one exchange and ``n_steps``
    recurrence steps, calls ``emit(T_k)`` with each step's output in
    order (V's elements in V's order, in any shape V views as) and
    returns the carry of the next group. The reference's first group
    (seeded by V alone), ``lax.scan`` over the middle groups and tail
    group become one Python loop: a first group of ``min(s, n)`` steps,
    then groups of ``s``, the last holding the ``n mod s`` left over.
    ``Y`` is accumulated exactly as :func:`chebyshev_filter` accumulates
    it, the init ``mu0·V + mu1·T1 + mu2·T2`` then ``Y.add_(T_k,
    alpha=mu_k)``, so the result equals the s = 1 filter bit for bit. On
    a rank ``V`` and each ``T_k`` are its shard's rows only (``[R, n_b]``
    viewed ``[1, R, n_b]``), the same code."""
    if np.ndim(mu) != 1:
        raise ValueError("the s-step filter takes a 1-D mu (a batch of "
                         "requests filters each request on its own)")
    mu, a, b = _rounded(V, mu, alpha, beta)
    n, s = len(mu) - 1, int(s)
    if s < 2:
        raise ValueError("s = 1 is the per-step filter (chebyshev_filter)")
    acc = dict(k=0, Y=None, T1=None)

    def emit(T):
        acc["k"] += 1
        k = acc["k"]
        if k == 1:
            acc["T1"] = T
        elif k == 2:
            acc["Y"] = mu[0] * V.view(T.shape) + mu[1] * acc["T1"] + mu[2] * T
            acc["T1"] = None
        else:
            acc["Y"].add_(T, alpha=mu[k])

    coeffs = (a, b, alpha, beta)
    first = min(s, n)
    carry = group(first, True, V, coeffs, emit)
    done = first
    while done < n:
        m = min(s, n - done)
        carry = group(m, False, carry, coeffs, emit)
        done += m
    del carry
    if acc["k"] != n:
        raise AssertionError(f"the groups ran {acc['k']} steps, not {n}")
    return acc["Y"].view(V.shape)


def kpm_moments(spmv, alpha: float, beta: float, V: torch.Tensor,
                n_moments: int) -> torch.Tensor:
    """KPM moments ``mu_m = tr[T_m(Ã)]`` estimated with the stochastic
    trace over the columns of V (the reference's ``kpm_moments``,
    ``repro/core/chebyshev.py:123-143``; its scan a Python loop):
    ``[n_moments]`` of V's real dtype."""
    n_moments = int(n_moments)
    if n_moments < 2:
        raise ValueError(f"kpm_moments needs n_moments >= 2, got {n_moments}")
    np_dt = _real_dtype(V)
    a, b = float(np_dt(alpha)), float(np_dt(beta))

    def dot(x, y):
        return torch.real(torch.sum(torch.conj(x) * y))

    T0 = V
    T1 = a * spmv(V) + b * V
    ms = [dot(V, T0), dot(V, T1)]
    Tkm1, Tkm2 = T1, T0
    for _ in range(n_moments - 2):
        Tk = 2 * a * spmv(Tkm1) + 2 * b * Tkm1 - Tkm2
        ms.append(dot(V, Tk))
        Tkm1, Tkm2 = Tk, Tkm1
    return torch.stack(ms)


def kpm_dos(moments, n_bins: int = 512, jackson: bool = True):
    """The normalized DOS on [-1, 1] from KPM moments (the reference's
    ``kpm_dos``, ``repro/core/chebyshev.py:146-159``, numpy):
    ``(x, rho)``, x ascending."""
    M = len(moments)
    mu = np.asarray(moments, dtype=np.float64).copy()
    if jackson:
        k = np.arange(M)
        g = ((M - k + 1) * np.cos(np.pi * k / (M + 1))
             + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))) / (M + 1)
        mu *= g
    x = np.cos(np.pi * (np.arange(n_bins) + 0.5) / n_bins)
    Tm = np.cos(np.outer(np.arccos(x), np.arange(M)))
    w = (2.0 - (np.arange(M) == 0)) * mu / mu[0]
    rho = (Tm @ w) / (np.pi * np.sqrt(1 - x**2))
    return x[::-1], rho[::-1]
