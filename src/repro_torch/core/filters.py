"""Filter polynomial construction (Chebyshev window expansion).

The filter polynomial p(x) = sum_k mu_k T_k(x) approximates the indicator
function of the *search interval* mapped to x-space, optionally smoothed by
Jackson damping (the paper constructs filters per Pieper et al. [28]).
The polynomial is large inside the search interval and small outside of the
red boxes of Fig. 2.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["window_coeffs", "jackson_damping", "FilterPoly", "build_filter", "degree_for"]


def jackson_damping(n: int) -> np.ndarray:
    """Jackson kernel coefficients g_0..g_n."""
    M = n + 1
    k = np.arange(M)
    return ((M - k + 1) * np.cos(np.pi * k / (M + 1))
            + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))) / (M + 1)


def window_coeffs(a: float, b: float, n: int) -> np.ndarray:
    """Chebyshev coefficients of the indicator of [a, b] ⊂ [-1, 1].

    mu_0 = (acos(a) - acos(b)) / pi
    mu_k = 2 (sin(k acos(a)) - sin(k acos(b))) / (k pi),  k >= 1
    """
    a = float(np.clip(a, -1.0, 1.0))
    b = float(np.clip(b, -1.0, 1.0))
    ta, tb = np.arccos(a), np.arccos(b)
    k = np.arange(1, n + 1)
    mu = np.empty(n + 1)
    mu[0] = (ta - tb) / np.pi
    mu[1:] = 2.0 * (np.sin(k * ta) - np.sin(k * tb)) / (k * np.pi)
    return mu


@dataclasses.dataclass(frozen=True)
class FilterPoly:
    mu: np.ndarray  # Chebyshev coefficients (damped)
    degree: int
    search: tuple[float, float]  # search interval in eigenvalue units
    inclusion: tuple[float, float]  # [λl, λr]

    def eval(self, lam: np.ndarray) -> np.ndarray:
        """Evaluate p(λ) on eigenvalue-axis points (for tests/plots)."""
        alpha = 2.0 / (self.inclusion[1] - self.inclusion[0])
        beta = (self.inclusion[0] + self.inclusion[1]) / (self.inclusion[0] - self.inclusion[1])
        x = np.clip(alpha * np.asarray(lam) + beta, -1.0, 1.0)
        t = np.arccos(x)
        return np.cos(np.outer(t, np.arange(len(self.mu)))) @ self.mu


def degree_for(search: tuple[float, float], inclusion: tuple[float, float],
               sharpness: float = 6.0, n_min: int = 20, n_max: int = 200_000,
               bucket: int = 32) -> int:
    """Heuristic filter degree: resolution ∝ 1 / (x-space half width).

    The Jackson-damped window has transition width ≈ pi/n in x-space; we
    demand the transition be a fraction of the window half-width. Degrees
    are bucketed (rounded up to a multiple of ``bucket``) to bound the
    number of distinct compiled Chebyshev loops in the FD driver.
    """
    lam_l, lam_r = inclusion
    alpha = 2.0 / (lam_r - lam_l)
    half_w = 0.5 * (search[1] - search[0]) * alpha  # x-space half width
    n = int(np.ceil(sharpness / max(half_w, 1e-12)))
    n = int(np.clip(n, n_min, n_max))
    return -(-n // bucket) * bucket


def build_filter(search: tuple[float, float], inclusion: tuple[float, float],
                 degree: int | None = None, damped: bool = True, **deg_kw) -> FilterPoly:
    lam_l, lam_r = inclusion
    alpha = 2.0 / (lam_r - lam_l)
    beta = (lam_l + lam_r) / (lam_l - lam_r)
    if degree is None:
        degree = degree_for(search, inclusion, **deg_kw)
    a = alpha * search[0] + beta
    b = alpha * search[1] + beta
    mu = window_coeffs(min(a, b), max(a, b), degree)
    if damped:
        mu = mu * jackson_damping(degree)
    return FilterPoly(mu=mu, degree=degree, search=tuple(search), inclusion=tuple(inclusion))
