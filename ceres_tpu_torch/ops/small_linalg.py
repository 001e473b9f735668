"""Batched inverse of small SPD blocks (port of
``ceres_tpu/ops/small_linalg.py``'s ``spd_inverse`` / ``spd_solve``).

Closed-form cofactor inverse for n <= 3 (the (E'E + D^2) point blocks of
bundle adjustment, what InvertPSDMatrix<3,3> does) and above that a batched
Cholesky followed by two batched triangular solves against the identity,
L^-T (L^-1 I) (the 9x9 camera blocks of SCHUR_JACOBI, the cluster blocks).
The JAX package unrolls the Cholesky up to n = 32 so XLA can fuse it on the
TPU; eagerly that would be hundreds of tiny launches, so the port calls the
batched library factorization instead. ``contract`` multiplies batches of tiny matrices
term by term over their short axis.
"""

from __future__ import annotations

import torch


def _inv2(m):
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    rows = [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def _inv3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    inv_det = 1.0 / (a * A + b * B + c * C)
    rows = [
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD matrices (..., n, n) (invert_psd_matrix.h:44)."""
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        return _inv2(m)
    if n == 3:
        return _inv3(m)
    # Batched Cholesky; a block that is not SPD yields NaN (no exception,
    # no host sync), as the JAX package's unrolled factorization does.
    L, info = torch.linalg.cholesky_ex(m)
    inv = cholesky_solve(L, torch.eye(n, dtype=m.dtype, device=m.device).expand(m.shape))
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 b by two triangular solves, L^-T (L^-1 b): on the CPU the
    bits of ``torch.cholesky_solve`` (LAPACK's potrs is these two trsm
    calls), on the card cuBLAS' trsm, which a CUDA graph captures (the
    batched ``cholesky_solve`` goes to MAGMA, which cannot be captured)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def spd_solve(inv_m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply precomputed inverses: (..., n, n) x (..., n) -> (..., n)."""
    return torch.einsum("...ij,...j->...i", inv_m, b)


def contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j, k) -> (..., i, k) over a short axis j, one
    term at a time: for a batch of a million tiny matrices, elementwise
    passes run at the memory's rate where a batched matrix product does not
    (the cluster preconditioners' probes, ``linear/schur.py``)."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j, None] * b[..., None, j, :]
    return out
