"""Shared polynomial root-finding and interpolation-minimization utilities
(a copy of ``ceres_tpu/ops/polynomial.py``; numpy only).

Host-side (numpy) analogs of the reference's ``internal/ceres/polynomial.cc``
(FindPolynomialRoots via companion-matrix eigenvalues,
MinimizeInterpolatingPolynomial over value/gradient samples) — one tested
implementation for the three former inline copies in ``line_search.py``
(Armijo/Wolfe cubic steps), ``dogleg.py`` (boundary/subspace root finding)
and ``trust_region.py`` (projected-bounds Armijo interpolation).

These run in the host-side control loop between device computations (step
acceptance, line-search trial selection), exactly where the reference calls
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "polynomial_roots",
    "minimize_polynomial",
    "minimize_interpolating_polynomial",
    "cubic_minimizer_two_points",
    "cubic_minimizer_from_samples",
    "quadratic_minimizer",
]


def polynomial_roots(
    coeffs: Sequence[float], real_parts: bool = False
) -> np.ndarray:
    """Roots of the polynomial with descending ``coeffs``.

    Companion-matrix eigenvalues (``polynomial.cc:FindPolynomialRoots``,
    which uses the balanced companion matrix). By default complex pairs
    are dropped and the sorted real roots returned; ``real_parts=True``
    returns the real parts of ALL roots instead (the convention of the
    reference's trust-region boundary search,
    ``dogleg_strategy.cc:FindMinimumOnTrustRegionBoundary``, which probes
    every root's real part as a candidate multiplier). Leading zeros are
    stripped; a constant (or empty) polynomial has no roots.
    """
    c = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    # strip leading zeros
    nz = np.nonzero(c != 0.0)[0]
    if nz.size == 0 or c.size - nz[0] < 2:
        return np.zeros((0,), dtype=np.float64)
    c = c[nz[0]:]
    roots = np.roots(c)
    if real_parts:
        return np.sort(roots.real)
    real = roots[np.abs(roots.imag) <= 1e-10 * (1.0 + np.abs(roots.real))]
    return np.sort(real.real)


def _polyval(c: np.ndarray, x: float) -> float:
    return float(np.polyval(c, x))


def minimize_polynomial(
    coeffs: Sequence[float], x_min: float, x_max: float
) -> Tuple[float, float]:
    """Global minimizer of the polynomial on [x_min, x_max].

    Candidates are the interval endpoints plus real stationary points
    inside the interval (``polynomial.cc:MinimizePolynomial``). Returns
    (argmin, min value).
    """
    c = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    cand = [x_min, x_max]
    if c.size >= 3:  # derivative has degree >= 1
        dc = np.polyder(c)
        for r in polynomial_roots(dc):
            if x_min < r < x_max and np.isfinite(r):
                cand.append(float(r))
    vals = [_polyval(c, x) for x in cand]
    i = int(np.argmin(vals))
    return cand[i], vals[i]


def minimize_interpolating_polynomial(
    samples: Sequence[Tuple[float, Optional[float], Optional[float]]],
    x_min: float,
    x_max: float,
) -> Tuple[float, float]:
    """Fit the least-squares polynomial through (x, value, gradient)
    samples and minimize it on [x_min, x_max]
    (``polynomial.cc:MinimizeInterpolatingPolynomial``).

    Each sample is (x, value-or-None, gradient-or-None); the polynomial
    degree is (#constraints - 1). Returns (argmin, min value).
    """
    rows = []
    rhs = []
    num = sum((v is not None) + (g is not None) for _, v, g in samples)
    deg = max(num - 1, 0)
    n = deg + 1  # number of coefficients, descending powers
    for x, v, g in samples:
        powers = np.array([x ** (deg - i) for i in range(n)])
        if v is not None:
            rows.append(powers)
            rhs.append(v)
        if g is not None:
            dpow = np.array(
                [(deg - i) * (x ** max(deg - i - 1, 0)) if deg - i > 0 else 0.0
                 for i in range(n)]
            )
            rows.append(dpow)
            rhs.append(g)
    if not rows:
        raise ValueError("no constraints")
    A = np.stack(rows)
    b = np.asarray(rhs, dtype=np.float64)
    coeffs, *_ = np.linalg.lstsq(A, b, rcond=None)
    return minimize_polynomial(coeffs, x_min, x_max)


def cubic_minimizer_two_points(
    a0: float, f0: float, g0: float, a1: float, f1: float, g1: float
) -> float:
    """Minimizer of the cubic matching value+derivative at two points
    (Nocedal & Wright eq. 3.59; the closed form the reference's generic
    fit reduces to). Falls back to the midpoint when the cubic has no
    interior minimizer or the arithmetic degenerates.
    """
    h = a1 - a0
    if h == 0.0:
        return a0
    d1 = g0 + g1 - 3.0 * (f0 - f1) / (a0 - a1)
    disc = d1 * d1 - g0 * g1
    if disc < 0.0:
        return 0.5 * (a0 + a1)
    d2 = np.sign(h) * np.sqrt(disc)
    denom = g1 - g0 + 2.0 * d2
    if denom == 0.0:
        return 0.5 * (a0 + a1)
    a = a1 - h * (g1 + d2 - d1) / denom
    lo_b, hi_b = min(a0, a1), max(a0, a1)
    if not (lo_b < a < hi_b) or not np.isfinite(a):
        return 0.5 * (a0 + a1)
    return float(a)


def cubic_minimizer_from_samples(
    phi0: float, dphi0: float, a0: float, f0: float, a1: float, f1: float
) -> float:
    """Minimizer of the cubic through phi(0)=phi0, phi'(0)=dphi0 and two
    later samples (a0, f0), (a1, f1) (Nocedal & Wright eq. 3.43, the
    form the projected-bounds Armijo search uses). Returns a1/2 when
    degenerate.
    """
    d = a0 * a0 * a1 * a1 * (a1 - a0)
    if d == 0.0 or not np.isfinite(f0):
        return 0.5 * a1
    r0 = f0 - phi0 - dphi0 * a0
    r1 = f1 - phi0 - dphi0 * a1
    ca = (a0 * a0 * r1 - a1 * a1 * r0) / d
    cb = (-(a0 ** 3) * r1 + (a1 ** 3) * r0) / d
    disc = cb * cb - 3.0 * ca * dphi0
    if ca != 0.0 and disc >= 0.0:
        a = (-cb + np.sqrt(disc)) / (3.0 * ca)
    elif cb != 0.0:
        a = -dphi0 / (2.0 * cb)
    else:
        a = 0.5 * a1
    if not np.isfinite(a):
        a = 0.5 * a1
    return float(a)


def quadratic_minimizer(phi0: float, dphi0: float, a1: float, f1: float) -> float:
    """Minimizer of the quadratic through phi(0), phi'(0), (a1, f1);
    a1/2 when the quadratic is non-convex or degenerate."""
    denom = 2.0 * (f1 - phi0 - dphi0 * a1)
    if np.isfinite(denom) and denom > 0.0:
        return float(-dphi0 * a1 * a1 / denom)
    return 0.5 * a1
